"""One run of one cell on this rank: set-up, window, trace, comparison.

Set-up builds the program with the seed's weights and the image pool,
drives its first ``checked_steps`` steps through the window's own call
(their losses, the first update's gradients as the optimizer gets them,
and each parameter's change after them are the program's readings), then
warms up in blocks of steps until the step time settles (``warm_up``),
which sizes the window at ``--seconds`` and ends with every shape the
window uses built. The window then runs that many steps with no host
synchronise; CUDA events after each step give the step boundaries, read
once the window has closed. ``--trace 1`` profiles
``trace_steps`` more steps after the window. Then the program is freed
and rank 0 runs the plain reference over the same first steps of the
global batch and compares (``compare.py``).
"""

from __future__ import annotations

import gc
import math
import sys
import time
from time import perf_counter
from types import SimpleNamespace

import torch

from benchmark import compare, faults, peaks, spec, trace
from benchmark.reference.precision import PRECISIONS


class Clock:
    """Step boundaries: CUDA events on a card, the host clock on the CPU
    (where every operation has finished when it returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, marks) -> list[float]:
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_readings(kind, steps: int) -> compare.Readings:
    """Drive the program's first ``steps`` steps and read it (see module
    docstring); the first update's gradients come from a hook on the
    optimizer that removes itself."""
    names = {id(p): n for n, p in kind.model.named_parameters()}
    first = {}

    def hook(opt, args, kwargs):
        if first:
            return
        ps = [p for g in opt.param_groups for p in g["params"] if p.grad is not None]
        first.update((names[id(p)], p.grad.detach().float().flatten().cpu()) for p in ps)

    outs = []

    def forward_hook(module, args, output):
        if not outs:
            outs.append(kind.output(output).detach().float().clone())

    handles = [kind.optimizer.register_step_pre_hook(hook),
               kind.model.register_forward_hook(forward_hook)]
    try:
        losses = [kind.losses(kind.step(i)) for i in range(steps)]
    finally:
        for h in handles:
            h.remove()
    start = dict(kind.seed_model().named_parameters())
    params = dict(kind.model.named_parameters())
    change = {n: (p.detach().float() - start[n].detach()).norm() for n, p in params.items()}
    del start
    grads = {n: float(v.norm()) for n, v in first.items()}
    change = {n: float(v) for n, v in zip(change, torch.stack(list(change.values())).cpu())}
    out = outs[0]
    if kind.world > 1:
        parts = [torch.empty_like(out) for _ in range(kind.world)]
        torch.distributed.all_gather(parts, out.contiguous())
        out = torch.cat(parts)
    return compare.Readings(out.cpu(), torch.stack(losses).double().cpu(), grads, change, first)


def build(cell, seed: int, device, rank: int, world: int, fault: str | None):
    kind = spec.kind(cell.config["kind"]).KIND(cell.config, cell.traffic, seed, device, rank,
                                               world, fault)
    kind.build()
    return kind, faults.plant(kind, fault)


def _from_rank0(value, world: int):
    if world > 1:
        box = [value]
        torch.distributed.broadcast_object_list(box, src=0)
        value = box[0]
    return value


def _timed(kind, i: int, n: int, device) -> float:
    """``n`` steps from ``i``, synchronised at the end only: seconds a step."""
    t0 = perf_counter()
    for j in range(n):
        kind.step(i + j)
    sync(device)
    return (perf_counter() - t0) / n


def warm_up(kind, start: int, seconds: float, device, world: int, block_s: float = 2.0,
            most_s: float = 60.0) -> tuple[int, int, list[float]]:
    """Steps from ``start`` in blocks of two steps and then of at least
    ``block_s`` seconds, synchronised at each block's end only, as the window
    runs them. It stops once a long block, the second or a later one, is no
    more than 2% faster a step than the fastest before it, or once
    ``most_s`` have passed, so that a start which runs slow and speeds up is
    spent here, in set-up, and not in the window. Rank 0 decides for all
    ranks. Returns the next index, the
    window's step count for ``seconds`` at the last block's pace, and each
    long block's ms a step."""
    sync(device)
    t_all = perf_counter()
    first = _timed(kind, start, 2, device)
    k = _from_rank0(max(2, math.ceil(block_s / first)), world)
    i, blocks = start + 2, []
    while True:
        blocks.append(_timed(kind, i, k, device))
        i += k
        done = (len(blocks) >= 2 and blocks[-1] >= 0.98 * min(blocks[:-1])) or (
            perf_counter() - t_all >= most_s)
        if _from_rank0(done, world):
            break
    steps = _from_rank0(max(1, round(seconds / blocks[-1])), world)
    return i, steps, [b * 1e3 for b in blocks]


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device, rank: int = 0,
        world: int = 1, t_start: float | None = None, fault: str | None = None,
        control: str | None = None) -> dict:
    """One run; rank 0 returns the result line's fields, others ``{}``."""
    t_start = time.time() if t_start is None else t_start
    mix = cell.traffic
    kind, undo = build(cell, seed, device, rank, world, fault)
    prog = program_readings(kind, mix["checked_steps"])
    i, steps, blocks = warm_up(kind, mix["checked_steps"], seconds, device, world)
    clock = Clock(device)
    sync(device)
    setup_s = time.time() - t_start
    if rank == 0:
        print(f"warm-up: {len(blocks)} blocks, ms a step {[round(b, 1) for b in blocks]}; "
              f"window {steps} steps", file=sys.stderr)

    marks, losses = [clock.mark()], []
    t0 = perf_counter()
    for j in range(steps):
        losses.append(kind.losses(kind.step(i + j)))
        marks.append(clock.mark())
    sync(device)
    window_s = perf_counter() - t0
    i += steps
    step_ms = clock.ms(marks)
    failed = int((~torch.isfinite(torch.cat(losses))).sum())

    tr, b1 = None, []
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t1 = perf_counter()
            for j in range(mix["trace_steps"]):
                kind.step(i + j)
            sync(device)
            traced_us = (perf_counter() - t1) * 1e6
        tr = trace.parse(prof, traced_us)
        del prof
        b1 = [n for j in range(mix["trace_steps"]) for n in kind.b1_bytes(i + j)]

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    undo()
    mine = {"peak": peak, "busy_s": tr.busy_us() / 1e6 if tr else None,
            "window_s": tr.window_us / 1e6 if tr else None}
    ranks = [mine]
    if world > 1:
        ranks = [None] * world
        torch.distributed.all_gather_object(ranks, mine)
    flops = kind.flops_per_step()
    kind.free()
    del kind
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return {}

    checks, correct = reference_check(cell, seed, device, world, prog, control)
    kind_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    measured = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, steps=steps, step_ms=step_ms,
        images_per_step=cell.traffic["batch"] * world, flops_per_step=flops,
        peak_bytes=max(r["peak"] for r in ranks), world=world, peaks=peaks.of(kind_name),
        trace=tr, trace_steps=mix["trace_steps"], b1_bytes=b1,
        busy_s=[r["busy_s"] for r in ranks], traced_window_s=[r["window_s"] for r in ranks])
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(measured)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind_name,
           "count": world, "memory_peak_bytes": measured.peak_bytes}
    out = {"correct": correct and failed == 0, "attempted": steps, "failed": failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        busy = [b for b in measured.busy_s if b is not None]
        dev["busy_s"] = sum(busy) / len(busy)
        dev["window_s"] = sum(measured.traced_window_s) / len(measured.traced_window_s)
        out["breakdown"] = {
            "device_ops": [[k, v] for k, v in trace.device_ops(tr).most_common(10)],
            "idle_gaps": [[k, v] for k, v in trace.named_gaps(tr).most_common(10)]}
    out["checks"] = checks
    return out


def reference_readings(cell, seed: int, device, world: int, precision: str):
    """The plain reference's readings over the cell's checked steps of the
    global batch, its products in ``precision``."""
    kind = spec.kind(cell.config["kind"]).KIND(cell.config, cell.traffic, seed, device, 0, world)
    return kind.reference(PRECISIONS[precision], cell.traffic["checked_steps"])


def reference_check(cell, seed, device, world, prog: compare.Readings, control: str | None):
    """The reference's readings over the same first steps, the gaps and
    their limits. ``control`` names a precision whose reference readings
    stand in for the program's (the control runs of the calibration)."""
    t0 = perf_counter()
    if control is not None:
        prog = reference_readings(cell, seed, device, world, control)
    ref = reference_readings(cell, seed, device, world, "float32")
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else 0.0
    print(f"reference: {perf_counter() - t0:.1f} s; process peak {peak:.2f} GiB", file=sys.stderr)
    nums = compare.numbers(prog, ref)
    for name in sorted(set(nums) - set(cell.limits)):
        print(f"reading {name}: {nums[name]!r} (not held)", file=sys.stderr)
    correct, checks = compare.judge(nums, cell.limits)
    return checks, correct


def report_checks(checks: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)


def calibrate(cell, roles: dict[str, list[int]], device, rank: int, world: int):
    """Readings without a window: for each seed and each role that names it
    (``program``, a precision of the control, or a fault), the numbers
    against the float32 reference, from the run's own ``build``,
    ``program_readings`` and ``reference_readings``. Rank 0 yields one
    record a reading."""
    for seed in dict.fromkeys(s for seeds in roles.values() for s in seeds):
        ref = None
        for role in (r for r, seeds in roles.items() if seed in seeds):
            t0 = perf_counter()
            prog = None
            if role not in PRECISIONS:
                kind, undo = build(cell, seed, device, rank, world,
                                   None if role == "program" else role)
                prog = program_readings(kind, cell.traffic["checked_steps"])
                undo()
                kind.free()
                del kind
                gc.collect()
            if rank != 0:
                continue
            if prog is None:
                prog = reference_readings(cell, seed, device, world, role)
            if ref is None:
                ref = reference_readings(cell, seed, device, world, "float32")
            yield {"role": role, "seed": seed, "numbers": compare.numbers(prog, ref),
                   "seconds": perf_counter() - t0,
                   "losses": [float(x) for x in prog.losses.flatten()[:4]]}
            if device.type == "cuda":
                torch.cuda.empty_cache()
