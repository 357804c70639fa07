"""Data parallelism over processes: one process per GPU, ``torch.distributed``.

Port of ``multimodal_active_ai_tpu/parallel/mesh.py``. The JAX package gets
its multi-device semantics from GSPMD: every step is written for the global
batch and XLA inserts the collectives. Here each rank holds only its own
rows, so the steps make those collectives explicit (``parallel/
collectives.py``): BatchNorm statistics over the global batch
(``models/norm.SyncBatchNorm``), NT-Xent negatives from every rank, the
gradient averaged before each update, the augmentation draws made for the
global batch and sliced (:func:`local_rows`). An N-rank run at ``-b b`` is
then the same function of ``--seed`` as the JAX package's run on an
N-device mesh at ``-b b``: a global batch of ``N·b`` rows.

Launch contracts read by :func:`initialize_distributed`:

* torchrun's (the reference's): ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
* the JAX package's: ``MAAI_NUM_PROCESSES``, ``MAAI_COORDINATOR``
  (``host:port``, or a ``file://`` / ``tcp://`` URL used as it is) and
  ``MAAI_PROCESS_ID`` (``tools/multiprocess_drivers.sh``), every process on
  one host unless ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` say otherwise.

Without either, a run is one process and nothing is initialised.

The backend is NCCL when every rank of a host has a card of its own, and
gloo on the CPU or when ranks share a card (NCCL refuses two ranks on one
GPU). A failed initialisation raises; nothing falls back to another backend
or to the CPU.

The JAX mesh's ``model`` axis is left out: no JAX driver sets it above 1.
``--multislice`` changes only how XLA schedules the collectives on a TPU
pod (``mesh.py:create_hybrid_mesh``), not what they compute; here it prints
the nodes × local-ranks layout.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from multimodal_active_ai_tpu_torch.device import resolve_device


def _launch_env() -> dict | None:
    """``{world, rank, local_rank, local_world, init_method}`` from the
    launcher's variables, or None for a plain single-process run."""
    env = os.environ
    if "WORLD_SIZE" in env and "RANK" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        init = "env://"
    elif int(env.get("MAAI_NUM_PROCESSES", "1")) > 1:
        world, rank = int(env["MAAI_NUM_PROCESSES"]), int(env["MAAI_PROCESS_ID"])
        coord = env["MAAI_COORDINATOR"]
        init = coord if "://" in coord else f"tcp://{coord}"
    else:
        return None
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    return {"world": world, "rank": rank, "local_world": local_world,
            "local_rank": int(env.get("LOCAL_RANK", rank % local_world)),
            "init_method": init}


def initialize_distributed(device: str = "cuda", multislice: bool = False,
                           verbose: bool = False) -> torch.device:
    """Join the job the launcher started and return this rank's device.

    ``device`` is a driver's ``--device``: ``cuda`` gives rank ``r`` the
    card ``cuda:LOCAL_RANK`` (modulo the cards present, so ranks beyond the
    card count share them over gloo), ``cpu`` the CPU over gloo. Without
    the launcher's variables this is :func:`resolve_device` and nothing
    else; a process group that already exists is joined as it is.
    """
    launch = _launch_env()
    if launch is None and not dist.is_initialized():
        return resolve_device(device)
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local_rank = launch["local_rank"] if launch else torch.cuda.current_device()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        shared = dev.type == "cuda" and launch["local_world"] > torch.cuda.device_count()
        backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
        dist.init_process_group(backend, init_method=launch["init_method"],
                                world_size=launch["world"], rank=launch["rank"],
                                device_id=dev if backend == "nccl" else None)
        if is_main():
            why = ("the CPU" if dev.type == "cpu" else
                   f"{launch['local_world']} ranks share {torch.cuda.device_count()} card(s)"
                   if shared else "one card per rank")
            print(f"distributed: {world_size()} ranks, backend {backend} ({why})")
    if multislice and is_main():
        local = launch["local_world"] if launch else 1
        print(f"multislice: {world_size() // local} node(s) x {local} local rank(s); "
              "the collectives span every rank either way")
    if verbose:
        print(f"rank {rank()} of {world_size()} on {dev}")
    return dev


def shutdown() -> None:
    """Leave the process group, if there is one (the end of a driver run)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0: the one process that prints and writes checkpoints (the JAX
    drivers' ``jax.process_index() == 0``)."""
    return rank() == 0


def print0(*args, **kwargs) -> None:
    """``print`` on rank 0 only."""
    if is_main():
        print(*args, **kwargs)


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def per_process_batch(per_rank_batch: int) -> tuple[int, int]:
    """``(global batch, this rank's batch)`` from the per-rank ``-b``: the
    reference's semantics, ``global = b × world`` (``mesh.py:144-160``)."""
    return per_rank_batch * world_size(), per_rank_batch


def local_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's block of a tensor whose ``dim`` spans the global batch
    (``world`` equal blocks in rank order); the tensor itself at world 1.
    Draws made for the global batch become this rank's draws with it."""
    world = world_size()
    if world == 1:
        return x
    n = x.shape[dim] // world
    if n * world != x.shape[dim]:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into {world} ranks")
    return x.narrow(dim, rank() * n, n)
