"""The precision of the reference's products.

Every convolution and matrix product of the reference takes its operands
through ``prec.q``. :data:`EXACT` leaves them in float32. :class:`Fp8` is
the control: each operand rounded to float8 e4m3 with one scale a tensor
(its largest magnitude maps to 448, e4m3's largest finite value), then
multiplied in float32, as an fp8 product with per-tensor scaling computes
it. The gradient passes through the rounding unchanged (straight through),
and each product's backward uses the rounded operands it saved.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


class Exact:
    name = "float32"

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        return x


class Fp8:
    name = "fp8_e4m3"

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
            r = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (r - x).detach()


EXACT = Exact()
FP8 = Fp8()
PRECISIONS = {"float32": EXACT, "fp8_e4m3": FP8}
