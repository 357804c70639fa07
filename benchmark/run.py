"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell; its
configuration, traffic mix, limits and metrics are files under
``benchmark/`` found by name. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared beside its limit, also the last lines of standard error).

Without a CUDA device, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result. A cell on N cards starts N rank
processes of this script (one a card, the port's ``MAAI_*`` launch
variables, a ``file://`` rendezvous under ``TMPDIR``) and waits for them;
rank 0 prints. The program's caches live in ``benchmark/.cache/``.

Options for the tests and the calibration of the limits, not used by a
measured run: ``--rehearse`` (the files' small ``rehearsal`` sizes on the
CPU, no card needed), ``--fault NAME`` (plant a fault of ``faults.py``),
``--control PRECISION`` (the reference in that precision in the program's
place), ``--calibrate ROLE=SEED,SEED,...`` (repeatable; readings without a
window, one JSON line each: ``program``, a precision, or a fault).
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_active_ai_tpu")
RANK_TIMEOUT_S = 340


def _environment(pin: bool) -> None:
    """Every build and kernel cache at a fixed path inside the checkout; one
    intra-op thread; with ``pin``, this process (rank ``r``) on its own two
    cores, ``2r + 2`` and ``2r + 3`` of those it may use (the last two where
    there are too few), before any thread starts. The steps are host-bound
    in part, and a dispatch thread that migrates between cores spreads the
    runs of a cell."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    if not pin:
        return
    cores = sorted(os.sched_getaffinity(0))
    r = int(os.environ.get("MAAI_PROCESS_ID", "0"))
    mine = cores[2 * r + 2:2 * r + 4]
    os.sched_setaffinity(0, mine if len(mine) == 2 else cores[-2:])


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--control", default=None)
    ap.add_argument("--calibrate", action="append", default=[])
    ap.add_argument("--t-start", type=float, default=None)
    return ap.parse_args(argv)


def _loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _spawn(args, chips: int) -> int:
    """Start one rank process a card and wait for them; rank 0 prints."""
    tmp = Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR")))
    procs, logs = [], []
    for r in range(chips):
        env = dict(os.environ, MAAI_NUM_PROCESSES=str(chips), MAAI_PROCESS_ID=str(r),
                   MAAI_COORDINATOR=f"file://{tmp / 'rendezvous'}", LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(chips))
        cmd = [sys.executable, str(Path(__file__).resolve()), *sys.argv[1:],
               "--t-start", repr(T_START)]
        log = open(tmp / f"rank{r}.log", "w+") if r else None
        logs.append(log)
        procs.append(subprocess.Popen(cmd, env=env, stdout=None if r == 0 else subprocess.DEVNULL,
                                      stderr=log))
    deadline = time.time() + RANK_TIMEOUT_S
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed or time.time() > deadline:
                rc = failed[0] if failed else 124
                break
            time.sleep(0.2)
        else:
            rc = next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for r, log in enumerate(logs):
            if log is not None:
                log.seek(0)
                if rc:
                    sys.stderr.write(f"--- rank {r} ---\n{log.read()[-4000:]}")
                log.close()
    return rc


def main(argv=None) -> int:
    args = _args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import spec

    cell = spec.Cell(args.workload, rehearse=args.rehearse)
    spawner = cell.chips > 1 and "MAAI_PROCESS_ID" not in os.environ
    _environment(pin=not spawner)
    import torch

    if not args.rehearse and (not torch.cuda.is_available()
                              or torch.cuda.device_count() < cell.chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    if spawner:
        return _spawn(args, cell.chips)

    from multimodal_active_ai_tpu_torch import parallel

    from benchmark import harness

    # the drivers' setting: float32 means float32; bf16 comes from autocast
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = parallel.initialize_distributed("cpu" if args.rehearse else "cuda")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    rank, world = parallel.rank(), parallel.world_size()
    try:
        if args.calibrate:
            roles = {}
            for item in args.calibrate:
                role, seeds = item.split("=", 1)
                roles[role] = [int(s) for s in seeds.split(",")]
            for rec in harness.calibrate(cell, roles, device, rank, world):
                print(json.dumps(rec), flush=True)
            return 0
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, rank, world,
                          args.t_start or T_START, args.fault, args.control)
    finally:
        parallel.shutdown()
    if rank != 0:
        return 0
    bad = _loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port without JAX",
              file=sys.stderr)
        return 3
    harness.report_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
