"""Whole residual conv block with identity shortcut: CUDA kernel and plain
version.

``fused_residual_conv_block`` is the port of the Pallas TPU kernel
``lass_tpu/ops/pallas_convblock.py::fused_residual_conv_block`` on the
logical layout:

    out = x + conv3x3(leaky(a2 * conv3x3(leaky(a1 * x + b1), W1) + b2), W2)

for in == out channels U. On a CUDA tensor it launches
``lass_torch/csrc/convblock.cu`` (U = 32, bfloat16: encoder_block1's
block, the only one with an identity shortcut at the widest level) or
raises; on a CPU tensor it runs ``residual_conv_block_plain``. Eval only:
no backward, as in the JAX package.

The kernel is persistent: each warpgroup keeps W1 and W2 resident in
shared memory (their nine taps each, ``act_conv.tap_weights``, packed by
``_common.pack_b``), walks strips of 62 frequencies down T with x rows
arriving through a cp.async ring, and keeps y1 and h2 on chip (h2 in a
three-row ring in shared memory), so it reads x and writes out once. It
sits on the ridge between bytes and operations; its design and numbers
are in its source and PERF.md.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from lass_torch.ops import _common
from lass_torch.ops.act_conv import tap_weights

# number of kernel launches since the last reset (the CPU path never adds)
LAUNCHES = 0
_WHAT = "fused residual conv block"
# the one width the kernel is built for (the UNet's widest level)
KERNEL_U = 32


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[:, :, None, None]


def residual_conv_block_plain(x, w1, w2, a1, b1, a2, b2) -> torch.Tensor:
    """Plain version with the kernel's rounding points: the first
    activation in float32, rounded to x's dtype; conv1 in float32 on the
    rounded operands, its sum y1 NOT rounded before leaky(a2 * y1 + b2);
    that activation rounded for conv2; conv2's sum rounded to x's dtype and
    added to x in x's dtype. channels_last output."""
    dt = x.dtype
    h1 = F.leaky_relu(x.float() * _col(a1) + _col(b1), 0.01).to(dt)
    y1 = F.conv2d(h1.float(), w1.to(dt).float(), padding=1)
    h2 = F.leaky_relu(y1 * _col(a2) + _col(b2), 0.01).to(dt)
    y2 = F.conv2d(h2.float(), w2.to(dt).float(), padding=1).to(dt)
    return (x + y2).contiguous(memory_format=_common.CL)


def _check(x, w1, w2, vecs) -> None:
    _common.require_channels_last(_WHAT, [x])
    batch, u = x.shape[0], x.shape[1]
    for w in (w1, w2):
        if tuple(w.shape) != (u, u, 3, 3):
            raise ValueError(f"{_WHAT} weights must be ({u}, {u}, 3, 3), got "
                             f"{tuple(w.shape)}")
    for v in vecs:
        if tuple(v.shape) != (batch, u):
            raise ValueError(f"{_WHAT} affine vectors must be ({batch}, {u}),"
                             f" got {tuple(v.shape)}")
    _common.same_device(_WHAT, [x, w1, w2, *vecs])
    _common.forbid_grad(_WHAT, [x, w1, w2, *vecs])


def _launch(x, w1, w2, vecs) -> torch.Tensor:
    from lass_torch.ops._build import load_library

    global LAUNCHES
    _common.require_bf16_rows(_WHAT, [x])
    batch, u, t, f = x.shape
    if u != KERNEL_U:
        raise ValueError(f"{_WHAT} kernel takes {KERNEL_U} channels, got "
                         f"{u}")
    lib = load_library()

    wp = _common.pack_b(torch.cat([tap_weights(w1), tap_weights(w2)]).to(
        torch.bfloat16))
    vecs = [v.detach().float().contiguous() for v in vecs]
    out = torch.empty_like(x, memory_format=_common.CL)
    _common.launch(lib.lass_residual_conv_block, x.device, _WHAT,
                   x.data_ptr(), *_common.nhwc_strides(x), wp.data_ptr(),
                   *[v.data_ptr() for v in vecs], out.data_ptr(),
                   *_common.nhwc_strides(out), batch, t, f, u)
    LAUNCHES += 1
    return out


def fused_residual_conv_block(x: torch.Tensor, w1: torch.Tensor,
                              w2: torch.Tensor, a1: torch.Tensor,
                              b1: torch.Tensor, a2: torch.Tensor,
                              b2: torch.Tensor) -> torch.Tensor:
    """x: channels_last (B, U, T, F); w1, w2: (U, U, 3, 3) float32, cast to
    x's dtype; a1, b1, a2, b2: (B, U) float32. Returns channels_last
    (B, U, T, F). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    vecs = (a1, b1, a2, b2)
    _check(x, w1, w2, vecs)
    if _common.device_kind(x, _WHAT) == "cpu":
        return residual_conv_block_plain(x, w1, w2, *vecs)
    return _launch(x, w1, w2, vecs)
