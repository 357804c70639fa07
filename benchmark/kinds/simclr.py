"""SimCLR-with-saccades training, as the SimCLR driver builds it.

The program: ``models/simclr.SimCLRModule`` (``bn``, ``sync_bn`` at more
than one rank, autocast in the configuration's dtype), Adam from
``train/optimizers.get_optimizer``, ``train/schedule.simclr_learning_rate``
and ``train/simclr_train.make_train_step``. Each step is handed its
``1 + F`` views' retina parameters and noise (this rank's rows of the
global batch's draws); the same draws go to the reference.
"""

from __future__ import annotations

import torch

from benchmark import flops, traffic
from benchmark.kinds.base import Kind
from benchmark.reference import optim, retina, simclr


class Views:
    """``views(j)``: view ``j``'s glimpses, made when asked for."""

    def __init__(self, fn, count: int):
        self.fn, self.count = fn, count

    def __call__(self, j: int):
        return self.fn(j)


class SimCLR(Kind):
    reference_model = simclr.SimCLR

    def build_program(self):
        from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
        from multimodal_active_ai_tpu_torch.ops import retina as port_retina
        from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train

        c = self.cfg
        norm = c["norm_multi_rank"] if self.world > 1 else c["norm"]
        with torch.device("meta"):
            model = SimCLRModule(arch=c["arch"], projection_hidden=c["projection_hidden"],
                                 projection_dim=c["projection_dim"], norm_kind=norm,
                                 dtype=getattr(torch, c["dtype"]))
        model = self.load(model)
        sched = schedule.simclr_learning_rate(
            c["lr"], self.global_batch, c["num_examples"] // self.world, self.batch,
            c["warmup_epochs"], c["epochs"], c["lr_scaling"])
        opt = optimizers.get_optimizer(c["optimizer"], model.parameters())
        self.state = simclr_train.TrainState(model, opt, sched)
        self.train_module = simclr_train
        self.fn = simclr_train.make_train_step(self.port_retina_cfg(port_retina),
                                               self.fixations, c["temperature"])
        self.aug = port_retina.AugParams

    def draws(self, i: int):
        return traffic.simclr_views(self.seed, i, self.fixations + 1, self.global_batch,
                                    self.canvas, self.cfg["retina"], self.device)

    def step(self, i: int):
        n = self.batch // 2 if self.half else self.batch
        params, noise = [], []
        for p, nz in self.draws(i):
            params.append(self.aug(*(t[:n] for t in traffic.local_params(p, self.rank, self.world))))
            noise.append(traffic.rows(nz, self.rank, self.world)[:n])
        return self.fn(self.state, self.pool[i % len(self.pool)][:n], None,
                       params=params, noise=noise)

    @staticmethod
    def losses(out) -> torch.Tensor:
        return out

    @staticmethod
    def output(out) -> torch.Tensor:
        return out

    def flops_per_step(self) -> int:
        return flops.simclr_step(self.cfg, self.global_batch, self.fixations)

    def b1_bytes(self, i: int) -> list[int]:
        r = self.cfg["retina"]
        return [flops.b1_bytes(traffic.local_params(p, self.rank, self.world), self.batch,
                               self.canvas, r["glimpse_size"], r["crop_sizes"])
                for p, _ in self.draws(i)]

    def reference_steps(self, model, prec, steps: int, on_first_update):
        c, r = self.cfg, self.cfg["retina"]
        opt = optim.Adam(dict(model.named_parameters()))
        sched = optim.simclr_schedule(c["lr"], self.global_batch, c["num_examples"] // self.world,
                                      self.batch, c["warmup_epochs"], c["epochs"])
        factors = retina.mip_levels(r["crop_sizes"], r["glimpse_size"]).values()
        count, losses = 0, []
        for i in range(steps):
            mips = retina.build_pyramid(self.global_images(i), factors)
            draws = self.draws(i)

            def view(j, mips=mips, draws=draws):
                p, nz = draws[j]
                return retina.glimpses(mips, p, self.canvas, r["glimpse_size"],
                                       r["crop_sizes"], nz)

            out, count = simclr.train_step(model, opt, sched, count, Views(view, len(draws)),
                                           c["temperature"], prec,
                                           on_first_update if i == 0 else None)
            losses.append(out)
            del mips
        return torch.stack(losses)


KIND = SimCLR
