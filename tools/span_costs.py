#!/usr/bin/env python3
"""What the port's spans cost, and where a benchmark cell's traced steps go
by span, on one GPU.

    python3 tools/span_costs.py --workload detr-r50-b256-f2
    python3 tools/span_costs.py --workload simclr-r50-b256-f10 --seed 7

Builds the cell's program as ``benchmark/run.py`` does (its configuration,
traffic and the seed's weights, TF32 off, one intra-op thread), runs its
checked steps and a warm-up, then:

* ns a span costs with no profiler running (``utils/profiling.span``: a
  flag check and a shared no-op context), over a million spans on this
  host, and under a CPU and CUDA profiler (a ``record_function``), and
  the spans a step opens (counted in a traced step), so the tracing-off
  and tracing-on costs a step;
* the untraced step time (host clock over ``--steps`` steps, synchronised
  at the end), and the traced time of the cell's ``trace_steps`` steps
  under ``torch.profiler`` with the spans and without them (the spans'
  flag read as off), after one traced run to warm up, ``--rounds`` of
  each in turns (with, without, without, with, ...);
* from the last traced capture with spans: the span table
  (``utils/profiling.span_table``), the kernels summed by layer
  (``span_layers``), the benchmark's readers of the spans, the launches
  and busy time, the number of kernels inside ``trainers.backward``'s
  device ranges, and the idle gaps in which no host operation but spans
  is open split by the innermost span.

Prints a table and one JSON line. Needs CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
from time import perf_counter
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("OMP_NUM_THREADS", "1")

import torch  # noqa: E402

from benchmark import harness, spec  # noqa: E402
from benchmark import trace as btrace  # noqa: E402
from multimodal_active_ai_tpu_torch.utils import profiling  # noqa: E402

SPAN_READERS = ("retina.device_ms", "models.forward_device_ms", "trainers.backward_device_ms",
                "dispatch.idle_outside_program_pct")


def ns_per_span(n: int = 1_000_000, profiled: bool = False) -> float:
    """ns one ``with span(...)`` costs, with no profiler running or under
    a CPU and CUDA profiler."""
    span = profiling.span

    def spans():
        for _ in range(n):
            with span("trainers.step", 3):
                pass

    def empty():
        for _ in range(n):
            pass

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    best = []
    with torch.profiler.profile(activities=acts) if profiled else contextlib.nullcontext():
        for fn in (spans, empty):
            t = []
            for _ in range(3):
                t0 = perf_counter()
                fn()
                t.append(perf_counter() - t0)
            best.append(min(t))
    return (best[0] - best[1]) / n * 1e9


class _SpansOff:
    """Inside the block ``span`` reads the profiler as off: the traced
    steps without the program's spans."""

    def __enter__(self):
        self.real = profiling._autograd_profiler
        profiling._autograd_profiler = SimpleNamespace(_is_profiler_enabled=False)

    def __exit__(self, *exc):
        profiling._autograd_profiler = self.real


def traced(kind, start: int, steps: int, spans: bool):
    """``steps`` steps from ``start`` under the profiler: (ms a step, the
    capture)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with contextlib.nullcontext() if spans else _SpansOff():
        with torch.profiler.profile(activities=acts) as prof:
            t0 = perf_counter()
            for j in range(steps):
                kind.step(start + j)
            torch.cuda.synchronize()
            ms = (perf_counter() - t0) * 1e3 / steps
    return ms, prof


# the first words of the port's span names, and torch's ``Optimizer.*#*`` ranges
SPAN_PREFIXES = ("trainers.", "retina.", "models.", "collectives.", "input.", "Optimizer.")


def idle_host_by_span(tr: btrace.Trace) -> dict[str, float]:
    """The gaps in which no host operation is open once the spans are left
    out (the parent program's ``idle host``), in ms by the innermost span
    open, ``(no span)`` where none is."""
    ops = [s for s in tr.host if not s.name.startswith(SPAN_PREFIXES)]
    spans = [s for s in tr.host if s.name.startswith(SPAN_PREFIXES)]
    op_starts, span_starts = [s.start for s in ops], [s.start for s in spans]
    out: dict[str, float] = {}
    for a, b in tr.gaps():
        mid = 0.5 * (a + b)
        if btrace.host_op_at(ops, op_starts, mid) != "idle host":
            continue
        name = btrace.host_op_at(spans, span_starts, mid)
        name = profiling.NO_SPAN if name == "idle host" else name
        out[name] = out.get(name, 0.0) + (b - a) / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1234567)
    ap.add_argument("--steps", type=int, default=10, help="untraced steps timed")
    ap.add_argument("--rounds", type=int, default=4, help="traced runs with and without spans")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("span_costs needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    ns = ns_per_span()
    ns_on = ns_per_span(20_000, profiled=True)

    cell = spec.Cell(args.workload)
    device = torch.device("cuda", 0)
    kind, _ = harness.build(cell, args.seed, device, 0, 1, None)
    n_trace = cell.traffic["trace_steps"]
    i = 0
    for _ in range(cell.traffic["checked_steps"] + 3):
        kind.step(i)
        i += 1
    torch.cuda.synchronize()
    t0 = perf_counter()
    for _ in range(args.steps):
        kind.step(i)
        i += 1
    torch.cuda.synchronize()
    step_ms = (perf_counter() - t0) * 1e3 / args.steps

    traced(kind, i, n_trace, spans=True)
    i += n_trace
    with_spans, without, prof = [], [], None
    for r in range(args.rounds):
        for spans in ((True, False) if r % 2 == 0 else (False, True)):
            ms, p = traced(kind, i, n_trace, spans)
            i += n_trace
            (with_spans if spans else without).append(ms)
            if spans:
                prof = p
    table = profiling.span_table(prof)
    tr = btrace.parse(prof, 0.0)
    del prof
    spans_a_step = sum(r.count for r in table if not r.name.startswith("Optimizer.")) / n_trace
    run = SimpleNamespace(trace=tr, trace_steps=n_trace)
    readers = {name: spec.reader(name)(run) for name in SPAN_READERS}
    backward = [a for a in tr.annotations if a.name == "trainers.backward"]
    in_backward = sum(1 for k in tr.kernels for a in backward if a.start <= k.start < a.end)
    layers = profiling.span_layers(table)
    busy_ms = tr.busy_us() / 1e3 / n_trace
    idle_host = idle_host_by_span(tr)

    print(f"[{gpu}] {args.workload} seed {args.seed}: a span with no profiler {ns:.1f} ns, "
          f"{spans_a_step:.0f} spans a step: {ns * spans_a_step / 1e3:.1f} us a step of "
          f"{step_ms:.1f} ms untraced ({100 * ns * spans_a_step / 1e6 / step_ms:.4f}%)")
    print(f"a span under the profiler {ns_on / 1e3:.2f} us: {ns_on * spans_a_step / 1e6:.3f} ms "
          f"a traced step; traced ms a step with spans {[round(x, 1) for x in with_spans]}, "
          f"without {[round(x, 1) for x in without]}")
    print(f"traced steps: {len(tr.kernels) / n_trace:.1f} launches, busy {busy_ms:.3f} ms a step; "
          f"{in_backward} kernels inside trainers.backward's device ranges")
    print("by span (a step): device ms, host ms, host self ms, device idle ms, ranges")
    for r in table:
        print(f"  {r.device_ms / n_trace:9.3f} {r.host_ms / n_trace:9.3f} "
              f"{r.host_self_ms / n_trace:9.3f} {r.idle_ms / n_trace:9.3f}  "
              f"{r.count / n_trace:6.1f}x  {r.name}")
    print("kernels by layer (ms a step): "
          + ", ".join(f"{k} {v / n_trace:.3f}" for k, v in layers.items()))
    print("idle with no host op open, by span (ms a step): "
          + ", ".join(f"{k} {v / n_trace:.3f}" for k, v in sorted(idle_host.items(),
                                                                   key=lambda kv: -kv[1])))
    print("readers: " + ", ".join(f"{k} {v!r}" for k, v in readers.items()))
    print(json.dumps({
        "gpu": gpu, "workload": args.workload, "seed": args.seed, "ns_per_span": ns,
        "ns_per_span_profiled": ns_on,
        "spans_a_step": spans_a_step, "step_ms": step_ms,
        "off_cost_pct": 100 * ns * spans_a_step / 1e6 / step_ms,
        "traced_ms_with_spans": with_spans, "traced_ms_without": without,
        "traced_median_ratio": statistics.median(with_spans) / statistics.median(without),
        "launches_a_step": len(tr.kernels) / n_trace, "busy_ms_a_step": busy_ms,
        "kernels_in_backward_ranges": in_backward,
        "layers_ms_a_step": {k: v / n_trace for k, v in layers.items()},
        "idle_host_ms_a_step": {k: v / n_trace for k, v in idle_host.items()},
        "readers": readers, "trace_steps": n_trace, "spans": [r._asdict() for r in table]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
