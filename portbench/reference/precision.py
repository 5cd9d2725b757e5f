"""The precision of the reference's matrix products and convolutions.

``float32`` computes them in float32 with TF32 off.  The lower precisions
round both operands of every product as the card's lower-precision units do
and accumulate in float32: ``tf32`` to a 10-bit mantissa (round to nearest,
ties away, as PTX ``cvt.rna.tf32.f32``), ``bfloat16`` to bf16, ``fp8`` to
float8 e4m3 with one scale a tensor (its largest magnitude maps to 448).
Elementwise work stays float32.  The rounding is emulated, so a lower
precision reads the same on any device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NAMES = ("float32", "tf32", "bfloat16", "fp8")
FP8_MAX = 448.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in NAMES:
            raise ValueError(f"precision must be one of {NAMES}, got {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, rounded to this precision; float32 out.
        The rounding passes the gradient straight through."""
        x = x.float()
        if self.name == "float32":
            return x
        if self.name == "tf32":
            r = _tf32(x.detach())
        elif self.name == "bfloat16":
            r = x.detach().to(torch.bfloat16).float()
        else:
            r = _fp8(x.detach())
        return x + (r - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def conv2d(self, x: torch.Tensor, w: torch.Tensor, bias=None, **kw) -> torch.Tensor:
        return F.conv2d(self.q(x), self.q(w), bias, **kw)


FLOAT32 = Precision("float32")


def exact_float32() -> None:
    """Switch TF32 off for products and convolutions, so float32 is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
