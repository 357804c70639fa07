"""What every training kind shares: sizes from the traffic, the seed's
weights, the image pool, loading the program, and the reference's
readings."""

from __future__ import annotations

import torch

from benchmark import traffic, weights
from benchmark.compare import Readings


class Kind:
    reference_model = None

    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, rank: int = 0,
                 world: int = 1, fault: str | None = None):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.rank, self.world = rank, world
        self.batch, self.fixations, self.canvas = mix["batch"], mix["fixations"], mix["canvas"]
        self.global_batch = self.batch * world
        self.half, self.fault = fault == "half_batch", fault

    # --- the program -------------------------------------------------------

    def build(self):
        """The image pool, then the program with the seed's weights."""
        self.pool = [traffic.images(self.seed, k, self.rank, self.batch, self.canvas, self.device)
                     for k in range(self.mix["pool"])]
        self.build_program()

    def seed_model(self):
        return weights.make(self.reference_model, self.cfg, traffic.stream(self.seed, "weights"),
                            self.device)

    def load(self, model: torch.nn.Module) -> torch.nn.Module:
        """``model`` (built on the meta device) on this rank's device with the
        seed's weights, channels-last on a card as the drivers place it."""
        state = self.seed_model().state_dict()
        model = model.to_empty(device=self.device)
        model.load_state_dict(state, strict=True)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        return model

    def port_retina_cfg(self, port_retina):
        r = self.cfg["retina"]
        return port_retina.RetinaConfig(
            canvas_size=self.canvas, glimpse_size=r["glimpse_size"],
            crop_sizes=tuple(r["crop_sizes"]), color_aug_prob=r["color_aug_prob"],
            grid_mask_prob=r["grid_mask_prob"], gaussian_noise_prob=r["gaussian_noise_prob"],
            brightness=r["brightness"], contrast=r["contrast"], hue=r["hue"],
            saturation=r["saturation"], fixation_angle_range=r["fixation_angle_range"],
            rrc_area=tuple(r["rrc_area"]), rrc_ratio=tuple(r["rrc_ratio"]), mode=r["mode"])

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        return self.state.optimizer

    def free(self):
        self.state = self.fn = self.pool = None

    # --- the reference -----------------------------------------------------

    def global_images(self, i: int) -> torch.Tensor:
        k = i % self.mix["pool"]
        return torch.cat([traffic.images(self.seed, k, r, self.batch, self.canvas, self.device)
                          for r in range(self.world)])

    def reference(self, prec, steps: int) -> Readings:
        """The reference's readings over the first ``steps`` steps of the
        global batch, its products in precision ``prec``."""
        model = self.seed_model()
        grads, vecs, outs = {}, {}, []

        def first(g):
            vecs.update({n: t.detach().float().flatten().cpu() for n, t in g.items()})
            grads.update({n: float(v.double().norm()) for n, v in vecs.items()})

        def forward_hook(module, args, output):
            if not outs:
                outs.append(output.detach().float().cpu())

        handle = model.register_forward_hook(forward_hook)
        losses = self.reference_steps(model, prec, steps, first)
        handle.remove()
        start = dict(self.seed_model().named_parameters())
        change = {n: float((p.detach().double() - start[n].detach().double()).norm())
                  for n, p in model.named_parameters() if n in grads}
        return Readings(outs[0], losses.double().cpu().reshape(steps, -1), grads, change, vecs)
