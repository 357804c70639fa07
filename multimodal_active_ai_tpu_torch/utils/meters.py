"""Host-side meters and the training log lines.

Port of ``multimodal_active_ai_tpu/utils/meters.py``: the ``AverageMeter``
arithmetic of the reference ``SimCLR/Utilities.py:8-24`` and the same
``Speed`` and ``##Perf`` line formats (``Contrastive_Learning.py:532-539,
726-734``), and :func:`mean_across_replicas`, through which every step's
metrics are averaged over ranks before a line is printed. With several
ranks a line's batch is the global one (``Speed`` counts every rank's rows).
"""

from __future__ import annotations

import torch

from multimodal_active_ai_tpu_torch.parallel import all_reduce_mean, world_size


def mean_across_replicas(metrics: dict) -> dict:
    """Each device tensor of ``metrics`` averaged over ranks, in one
    all-reduce (reference ``Utilities.reduce_tensor``, the JAX package's
    ``mean_across_replicas``). Every rank's value is the mean over its own,
    equally many rows, so the result is the global batch's. At world 1 the
    dict comes back as it is."""
    if world_size() == 1:
        return metrics
    flat = torch.cat([v.detach().to(torch.float32).reshape(-1) for v in metrics.values()])
    flat = all_reduce_mean(flat)
    out, at = {}, 0
    for k, v in metrics.items():
        out[k] = flat[at:at + v.numel()].reshape(v.shape)
        at += v.numel()
    return out


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def state_dict(self):
        return {"val": float(self.val), "avg": float(self.avg),
                "sum": float(self.sum), "count": float(self.count)}

    def load_state_dict(self, state):
        self.val = float(state["val"])
        self.avg = float(state["avg"])
        self.sum = float(state["sum"])
        self.count = float(state["count"])


def speed_line(epoch, i, loader_len, batch_time: AverageMeter, losses: AverageMeter,
               total_batch_size: int) -> str:
    """The reference's per-iteration training log line."""
    return (
        "Epoch: [{0}][{1}/{2}]\t"
        "Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
        "Speed {3:.3f} ({4:.3f})\t"
        "Loss {loss.val:.10f} ({loss.avg:.4f})".format(
            epoch, i, loader_len,
            total_batch_size / batch_time.val if batch_time.val else float("nan"),
            total_batch_size / batch_time.avg if batch_time.avg else float("nan"),
            batch_time=batch_time,
            loss=losses,
        )
    )


def perf_line(prec1, prec5, best_prec1, total_batch_size, avg_epoch_time) -> str:
    """The reference's per-epoch summary."""
    return (
        "##Contrastive Top-1 {0}\n"
        "##Contrastive Top-5 {1}\n"
        "##Best Contrastive Top-1 saved {2}\n"
        "##Perf {3}".format(prec1, prec5, best_prec1,
                            total_batch_size / avg_epoch_time if avg_epoch_time else float("nan"))
    )
