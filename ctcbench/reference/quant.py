"""The control's precision: each operand of a product rounded to fp8
(e4m3, per-tensor scale from its largest magnitude), the step below the
configuration's bf16 products.  The gradient passes straight through."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def exact(x: torch.Tensor) -> torch.Tensor:
    return x
