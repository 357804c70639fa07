"""A routing control for the calibration of a mixture-of-experts cell's
limits: the program with each token routed to one expert fewer than the
configuration says (top-5 for top-6), read against the float32 reference
of the configuration as it is, as ``run.py --calibrate program=...`` reads
the program. A limit that the program meets on every sound seed and this
control fails on every seed sees a wrong routing. One JSON line a seed::

    python3 benchmark/routing_control.py --workload <name> --seeds 1,2,3 [--rehearse]

from the root of a checkout, on one card (or the CPU with ``--rehearse``).
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import compare, harness, spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.Cell(args.workload, rehearse=args.rehearse)
    k = cell.config["num_experts_per_tok"]
    control = copy.copy(cell)
    control.config = {**cell.config, "num_experts_per_tok": k - 1}
    device = torch.device("cpu" if args.rehearse else "cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        kind, undo = harness.build(control, seed, device, 0, 1, None)
        prog = harness.program_readings(kind, cell.traffic["checked_steps"])
        undo()
        kind.free()
        del kind
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = harness.reference_readings(cell, seed, device, 1, "float32")
        print(json.dumps({"role": f"top{k - 1}", "seed": seed,
                          "numbers": compare.numbers(prog, ref)}), flush=True)
        del prog, ref
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
