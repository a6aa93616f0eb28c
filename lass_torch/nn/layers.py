"""Core layers with the JAX package's mixed-precision semantics.

Parameters and BatchNorm statistics stay float32. The activation dtype is
the compute dtype: convolutions cast their float32 weights to it at use,
and BatchNorm in eval folds its statistics into a float32 scale and shift
that are cast to it at use (``lass_tpu/nn/layers.py`` BatchNorm). Train-mode
BatchNorm is torch's own (momentum 0.01 as torch means it, unbiased running
variance, eps 1e-5), computed in float32, over an activation of any rank.
In a process group (``lass_torch.parallel``) its statistics are those of
the global batch, as under lass_tpu's data-sharded jit (the reference's
sync_batchnorm): ``GlobalBatchNorm`` gathers the ranks' statistics in the
forward pass and all-reduces the two grad sums in the backward pass, and
every rank updates its running statistics identically. Under a (data x
model) grid the ranks are the grid's data group (``process_group``).
``dropout`` draws its mask from an explicit generator, at the global
batch's shape in a process group (each rank keeps its rows).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from lass_torch.parallel.host import gather_rows, group_info, row_span


def _sum_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    with torch.profiler.record_function("lass::bn_collective"):
        dist.all_reduce(x, group=group)
    return x


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm of a float32 (N, C, ...) activation over every
    rank's rows: -> (y, batch mean, biased batch variance, global count).

    Forward: each rank's (mean, sum of squared deviations, count) per
    channel (Welford, ``torch.var_mean``) go to every rank in one
    all-gather and combine exactly (Chan et al.), in float64; no E[x^2] -
    E[x]^2 cancellation, which costs float32 1e-5 of the variance where a
    channel's mean is ten times its spread. Backward: one all-reduce of
    the two grad sums. The weight and bias grads it returns are the rank's
    own sums, which the step's grad reduction combines
    (``lass_torch.parallel.mesh``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = [1, c] + [1] * (x.dim() - 2)
        var, mean = torch.var_mean(x, dims, unbiased=False)
        count = x.numel() // c
        local = torch.cat([mean, var * count, x.new_full((1,), count)])
        with torch.profiler.record_function("lass::bn_collective"):
            ranks = gather_rows(local[None], group)
        ranks = ranks.double()
        counts = ranks[:, 2 * c:]
        n = counts.sum()
        mean64 = (ranks[:, :c] * counts).sum(0) / n
        m2 = (ranks[:, c:2 * c]
              + counts * (ranks[:, :c] - mean64) ** 2).sum(0)
        mean, var, n = mean64.float(), (m2 / n).float(), n.float()
        invstd = torch.rsqrt(var + eps)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        ctx.save_for_backward(xhat, weight, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var, n)
        return xhat * weight.view(shape) + bias.view(shape), mean, var, n

    @staticmethod
    def backward(ctx, gy, *_):
        xhat, weight, invstd, n = ctx.saved_tensors
        c = xhat.shape[1]
        dims = [0, *range(2, xhat.dim())]
        shape = [1, c] + [1] * (xhat.dim() - 2)
        dbias, dweight = gy.sum(dims), (gy * xhat).sum(dims)
        sums = _sum_over_ranks(torch.cat([dbias, dweight]), ctx.group) / n
        dx = (gy - sums[:c].view(shape) - xhat * sums[c:].view(shape)) \
            * (invstd * weight).view(shape)
        return dx, dweight, dbias, None, None


class BatchNorm(nn.BatchNorm2d):
    """Torch-semantics batch norm over feature dimension ``dim`` of an
    N-D activation (dim=1 for NCHW channels; ResUNet30's bn0 normalises the
    frequency axis, dim=3). ``process_group``: the ranks whose rows it
    normalises over (None: every rank; a grid's data group under tensor
    parallelism, set by ``lass_torch.parallel.tensor.shard_model``)."""

    process_group = None

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

    def _global_forward(self, h: torch.Tensor) -> torch.Tensor:
        y, mean, var, n = GlobalBatchNorm.apply(h, self.weight, self.bias,
                                                self.eps, self.process_group)
        with torch.no_grad():
            m = self.momentum
            self.num_batches_tracked.add_(1)
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var * (n / (n - 1)), alpha=m)
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            h = x.float().movedim(self.dim, 1)
            y = (self._global_forward(h)
                 if group_info(self.process_group)[1] > 1
                 else super().forward(h))
            return y.movedim(1, self.dim).to(x.dtype)
        inv, shift = self.scale_shift()
        shape = [1] * x.dim()
        shape[self.dim] = -1
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout`` (keep with probability
    1 - p, scale by 1 / (1 - p)), its mask from ``generator`` (on x's
    device; torch's default generator when None), drawn at the global
    batch's shape (``row_span``) and cut to this rank's rows."""
    total, start = row_span(x.shape[0])
    keep = torch.rand((total, *x.shape[1:]), generator=generator,
                      device=x.device, dtype=torch.float32)[
        start:start + x.shape[0]] >= p
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
