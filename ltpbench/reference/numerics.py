"""The precision the reference computes its products in.

``Exact`` leaves every operand as it is: the reference then computes in
the configuration's own dtype (bfloat16 products, float32 accumulation,
as cuBLAS does). ``FP8`` is the control that a correct check must fail:
the same reference with every matrix-product operand rounded to
float8 e4m3 under a per-tensor scale (amax / 448), the step below
bfloat16 that a lower-precision path would take. The rounding is
straight-through: the backward multiplies by the rounded operands the
forward saved, and the gradients flowing in are left alone.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


class Exact:
    name = "exact"

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        return x


class FP8:
    name = "fp8"

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            scale = torch.clamp(x.abs().amax().float(), min=1e-30) / E4M3_MAX
            xq = ((x.float() / scale).to(torch.float8_e4m3fn).float()
                  * scale).to(x.dtype)
        return x + (xq - x).detach()


PRECISIONS = {"exact": Exact, "fp8": FP8}
