"""The reference's arithmetic: float32 with TF32 off, or the control's
float8 (e4m3, one scale a tensor) at every matrix product's inputs.

The configurations compute in bfloat16; the control is the reference put in
the program's place one precision lower, the step a later change could be
tempted by (float8 products), so the comparison that decides ``correct`` has
to fail it.
"""

from __future__ import annotations

from typing import Optional

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def strict_float32() -> None:
    """Matrix products in true float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quantize_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude maps to 448), returned in float32. The gradient passes
    straight through: the backward's products see the rounded operands, not
    a gradient itself rounded to float8."""
    x = t.detach()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    rounded = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (rounded - x) if t.requires_grad else rounded


class Arith:
    """How the reference multiplies: ``precision`` is ``"float32"`` or
    ``"float8"`` (the control)."""

    def __init__(self, precision: str = "float32") -> None:
        if precision not in ("float32", "float8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return quantize_fp8(t) if self.precision == "float8" else t

    def linear(self, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        """``x @ weight.T + bias`` (``weight`` is [out, in])."""
        y = self.q(x) @ self.q(weight).t()
        return y if bias is None else y + bias

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)
