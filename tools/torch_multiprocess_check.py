#!/usr/bin/env python3
"""One rank of an N-rank job: the port's bootstrap, feed and collective
contract (port of ``tools/multiprocess_check.py``).

Checks, against closed forms:

1. the bootstrap through ``parallel.initialize_distributed`` (the
   rendezvous, the world size and this rank);
2. ``per_process_batch``'s ``-b`` semantics: global = b·N, b a rank;
3. distinct local rows (each rank's hold ``rank + 1``) whose all-reduced
   sum of ``2·x`` equals ``2·3·b·Σ(r + 1)``, the JAX tool's
   (``multiprocess_check.py:79-80``);
4. the differentiable gather (``all_gather_with_grad``): every rank's rows
   in rank order, and the gradient of ``Σ 2·gathered`` summed over the
   ranks, ``2·N`` on each local element.

and prints ``MULTIPROCESS OK rank r/N ...``. Launch each rank as::

    python3 tools/torch_multiprocess_check.py PROC_ID NUM_PROCS HOST:PORT [--device cpu]

or with no positional arguments under torchrun (``python -m
torch.distributed.run --nproc-per-node N tools/torch_multiprocess_check.py``)
or the JAX package's ``MAAI_NUM_PROCESSES`` / ``MAAI_COORDINATOR`` /
``MAAI_PROCESS_ID``, which ``parallel/distributed.py`` reads. The backend
is NCCL with a card a rank, gloo when ranks share a card or on the CPU
(``--device cpu``). It imports torch and the port, never JAX or the JAX
package; without ``--device cpu`` it needs a card.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_active_ai_tpu_torch import parallel

LOCAL_BATCH = 2     # -b of the check, as in the JAX tool


def check(device: str = "cuda") -> str:
    """The four checks on this rank; returns the OK line. Raises
    ``AssertionError`` naming what failed."""
    dev = parallel.initialize_distributed(device)
    world, rank = parallel.world_size(), parallel.rank()
    if not dist.is_initialized() or world < 2:
        raise AssertionError(f"no process group of 2 or more ranks (world {world})")

    gb, lb = parallel.per_process_batch(LOCAL_BATCH)
    if (gb, lb) != (LOCAL_BATCH * world, LOCAL_BATCH):
        raise AssertionError(f"per_process_batch gave {(gb, lb)}")

    local = torch.full((lb, 3), float(rank + 1), device=dev)
    total = float(parallel.all_reduce_sum((local * 2.0).sum()))
    expect = 2.0 * 3 * lb * sum(p + 1 for p in range(world))
    if total != expect:
        raise AssertionError(f"all-reduced sum {total}, expected {expect}")

    x = local.clone().requires_grad_()
    gathered = parallel.all_gather_with_grad(x)
    want = torch.arange(1, world + 1, device=dev, dtype=torch.float32).repeat_interleave(lb)
    if gathered.shape != (gb, 3) or not torch.equal(gathered[:, 0], want):
        raise AssertionError(f"gathered rows {gathered[:, 0].tolist()}, expected {want.tolist()}")
    (gathered * 2.0).sum().backward()
    if not torch.equal(x.grad, torch.full_like(x, 2.0 * world)):
        raise AssertionError(f"gather gradient {x.grad.flatten().tolist()}, expected "
                             f"{2.0 * world} everywhere")
    backend = dist.get_backend()
    return (f"MULTIPROCESS OK rank {rank}/{world}: device {dev}, backend {backend}, global "
            f"batch {gb}, cross-rank sum {total} == {expect}, gather of {gb} rows and its "
            f"gradient {2.0 * world}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("launch", nargs="*", help="PROC_ID NUM_PROCS HOST:PORT, or none under "
                                              "torchrun or the MAAI_* variables")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.launch:
        if len(args.launch) != 3:
            ap.error("give PROC_ID NUM_PROCS HOST:PORT, or no positional argument")
        proc_id, num_procs, coordinator = args.launch
        os.environ.update(MAAI_PROCESS_ID=proc_id, MAAI_NUM_PROCESSES=num_procs,
                          MAAI_COORDINATOR=coordinator)
    try:
        print(check(args.device), flush=True)
    finally:
        parallel.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
