"""Data parallelism over processes (the JAX package's ``parallel/``)."""

from multimodal_active_ai_tpu_torch.parallel.collectives import (
    all_gather_with_grad,
    all_reduce_mean,
    all_reduce_sum,
    all_reduce_sum_with_grad,
    average_gradients,
    cross_replica_concat,
)
from multimodal_active_ai_tpu_torch.parallel.distributed import (
    barrier,
    initialize_distributed,
    is_main,
    local_rows,
    per_process_batch,
    print0,
    rank,
    shutdown,
    world_size,
)

__all__ = [
    "all_gather_with_grad", "all_reduce_mean", "all_reduce_sum",
    "all_reduce_sum_with_grad", "average_gradients", "barrier",
    "cross_replica_concat", "initialize_distributed", "is_main", "local_rows",
    "per_process_batch", "print0", "rank", "shutdown", "world_size",
]
