"""DETR glimpse-sequence classifier training, as the DETR driver builds it.

The program: ``models/detr.build`` (the frozen-BN ResNet backbone, autocast
in the configuration's dtype), ``train/detr_train.make_detr_optimizer``
(AdamW groups: head at ``lr``, layer2-4 at ``lr_backbone``, the stem and
layer1 frozen), ``step_lr`` and ``make_detr_train_step`` with its global-
norm clip. Each step is handed its real fixation count and saccades (this
rank's rows of the global batch's draws) and a dropout generator seeded for
the step; the reference gets the same draws and replays the dropout masks
from a generator seeded alike.
"""

from __future__ import annotations

import torch

from benchmark import faults, flops, traffic
from benchmark.kinds.base import Kind
from benchmark.reference import detr, optim, retina
from benchmark.reference.resnet import calibrate_frozen


class DETR(Kind):
    reference_model = detr.DETR

    def build_program(self):
        from multimodal_active_ai_tpu_torch.config import DETRConfig
        from multimodal_active_ai_tpu_torch.models import detr as port_detr
        from multimodal_active_ai_tpu_torch.ops import retina as port_retina
        from multimodal_active_ai_tpu_torch.train import detr_train, simclr_train

        c = self.cfg
        dcfg = DETRConfig(backbone=c["arch"], dataset="imagenet", hidden_dim=c["hidden_dim"],
                          nheads=c["nheads"], enc_layers=c["enc_layers"],
                          dec_layers=c["dec_layers"], dim_feedforward=c["dim_feedforward"],
                          dropout=c["dropout"], num_queries=c["num_queries"],
                          backbone_norm=c["backbone_norm"])
        with torch.device("meta"):
            model, criterion = port_detr.build(dcfg, num_classes=c["num_classes"],
                                               dtype=getattr(torch, c["dtype"]))
        model = self.load(model)
        opt = detr_train.make_detr_optimizer(model, c["lr"], c["lr_backbone"], c["weight_decay"])
        sched = detr_train.step_lr(c["num_examples"] // self.global_batch, c["lr_drop"])
        self.state = simclr_train.TrainState(model, opt, sched)
        self.train_module = detr_train
        if self.fault == "half_loss":
            criterion = faults.half_loss(criterion)
        self.fn = detr_train.make_detr_train_step(criterion, self.port_retina_cfg(port_retina),
                                                  self.fixations, c["clip_max_norm"])
        self.labels = [traffic.labels(self.seed, k, self.rank, self.batch, c["num_classes"],
                                      self.device) for k in range(self.mix["pool"])]
        self.dropout_gen = torch.Generator(self.device)

    def seed_model(self):
        """The seed's weights, the backbone's frozen BatchNorm statistics
        those of its own inputs over ``bn_calibration_images`` canvases of
        the seed, one glimpse each (``calibrate_frozen``)."""
        model = super().seed_model()
        r, n = self.cfg["retina"], self.cfg["bn_calibration_images"]
        images = traffic.images(self.seed, "bn-calibration", 0, n, self.canvas, self.device)
        fix = torch.rand((n, 2), device=self.device,
                         generator=traffic.generator(self.device, self.seed, "bn-calibration"))
        g = retina.glimpses(retina.build_pyramid(images, retina.mip_levels(
            r["crop_sizes"], r["glimpse_size"]).values()), retina.labeled_params(fix, self.canvas),
            self.canvas, r["glimpse_size"], r["crop_sizes"])
        calibrate_frozen(model.backbone[0].body, g)
        return model

    def step(self, i: int):
        n = self.batch // 2 if self.half else self.batch
        num, sacc = traffic.saccades(self.seed, i, self.fixations, self.global_batch, self.device)
        k = i % len(self.pool)
        self.dropout_gen.manual_seed(traffic.stream(self.seed, "dropout", i))
        return self.fn(self.state, self.pool[k][:n], self.labels[k][:n], None, num_fixs=num,
                       saccades=traffic.rows(sacc, self.rank, self.world)[:n],
                       dropout_generator=self.dropout_gen)

    @staticmethod
    def losses(out) -> torch.Tensor:
        return out["loss_ce"].reshape(1)

    @staticmethod
    def output(out) -> torch.Tensor:
        return out["pred_logits"]

    def flops_per_step(self) -> int:
        return flops.detr_step(self.cfg, self.global_batch, self.fixations)

    def _labeled(self, sacc: torch.Tensor) -> retina.Params:
        """View-major plan rows ``j·B + i`` at saccade ``j`` of image ``i``."""
        fix_xy = sacc.transpose(0, 1).reshape(-1, 2)
        return retina.labeled_params(fix_xy.flip(-1), self.canvas)

    def b1_bytes(self, i: int) -> list[int]:
        r = self.cfg["retina"]
        _, sacc = traffic.saccades(self.seed, i, self.fixations, self.global_batch, self.device)
        p = self._labeled(traffic.rows(sacc, self.rank, self.world))
        return [flops.b1_bytes(p, self.batch, self.canvas, r["glimpse_size"], r["crop_sizes"])]

    def free(self):
        super().free()
        self.labels = None

    def reference_steps(self, model, prec, steps: int, on_first_update):
        c, r = self.cfg, self.cfg["retina"]
        lab = detr.groups(model)
        opt = optim.Adam({n: p for n, p in model.named_parameters() if lab[n] != "frozen"},
                         weight_decay=c["weight_decay"])
        factor = optim.step_lr(c["num_examples"] // self.global_batch, c["lr_drop"])
        factors = retina.mip_levels(r["crop_sizes"], r["glimpse_size"]).values()
        gen = torch.Generator(self.device)
        losses = []
        for i in range(steps):
            images = self.global_images(i)
            k = i % self.mix["pool"]
            labels = torch.cat([traffic.labels(self.seed, k, rk, self.batch, c["num_classes"],
                                               self.device) for rk in range(self.world)])
            num, sacc = traffic.saccades(self.seed, i, self.fixations, self.global_batch,
                                         self.device)
            g = retina.glimpses(retina.build_pyramid(images, factors), self._labeled(sacc),
                                self.canvas, r["glimpse_size"], r["crop_sizes"])
            g = g.reshape((self.fixations, self.global_batch) + g.shape[1:]).transpose(0, 1)
            gen.manual_seed(traffic.stream(self.seed, "dropout", i))
            losses.append(detr.train_step(model, opt, c, factor(i), g, sacc, num, labels, gen,
                                          prec, on_first_update if i == 0 else None))
        return torch.stack(losses)


KIND = DETR
