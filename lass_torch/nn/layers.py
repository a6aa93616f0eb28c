"""Core layers with the JAX package's mixed-precision semantics.

Parameters and BatchNorm statistics stay float32. The activation dtype is
the compute dtype: convolutions cast their float32 weights to it at use,
and BatchNorm in eval folds its statistics into a float32 scale and shift
that are cast to it at use (``lass_tpu/nn/layers.py`` BatchNorm). Train-mode
BatchNorm is torch's own (momentum 0.01 as torch means it, unbiased running
variance, eps 1e-5), computed in float32, over an activation of any rank.
``dropout`` draws its mask from an explicit generator.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm(nn.BatchNorm2d):
    """Torch-semantics batch norm over feature dimension ``dim`` of an
    N-D activation (dim=1 for NCHW channels; ResUNet30's bn0 normalises the
    frequency axis, dim=3)."""

    def __init__(self, num_features: int, momentum: float = 0.01,
                 eps: float = 1e-5, dim: int = 1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.dim = dim

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() < 2:
            raise ValueError(f"expected 2D or more input (got {x.dim()}D)")

    def scale_shift(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval affine in float32: y = x * inv + shift."""
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return inv, self.bias - self.running_mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y = super().forward(x.float().movedim(self.dim, 1))
            return y.movedim(1, self.dim).to(x.dtype)
        inv, shift = self.scale_shift()
        shape = [1] * x.dim()
        shape[self.dim] = -1
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout`` (keep with probability
    1 - p, scale by 1 / (1 - p)), its mask from ``generator`` (on x's
    device; torch's default generator when None)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


def _xavier_(module: nn.Module) -> None:
    nn.init.xavier_uniform_(module.weight)
    if module.bias is not None:
        nn.init.zeros_(module.bias)


class Conv2d(nn.Conv2d):
    """NCHW conv, padding k//2 (SAME at stride 1), xavier-uniform weight and
    zero bias; float32 parameters cast to the activation dtype at use."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int] = (3, 3), bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=(kernel_size[0] // 2, kernel_size[1] // 2),
                         bias=bias)
        _xavier_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """Transposed conv with kernel == stride and no bias (the UNet's
    up-sampling). Weight layout is torch's (in, out, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int,
                 stride: Tuple[int, int]):
        super().__init__(in_channels, out_channels, stride, stride=stride,
                         bias=False)
        _xavier_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None,
                                  self.stride)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def avg_pool(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """Non-overlapping average pool over the (H, W) axes of NCHW input."""
    return F.avg_pool2d(x, window, window)
