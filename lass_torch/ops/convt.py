"""Fused eval BN affine + FiLM beta + leaky ReLU + 2x2 stride-2 transposed
conv: CUDA kernel and plain version.

``fused_act_convT`` is the port of the Pallas TPU kernel
``lass_tpu/ops/pallas_convt.py::fused_act_convT`` on the logical layout:

    z = leaky(x * inv + shift + beta[b])        (in the activation dtype)
    out[b, o, 2t + i, 2f + j] = sum_c z[b, c, t, f] * W[c, o, i, j]

W is torch's ConvTranspose2d weight (C_in, C_out, 2, 2); the TPU kernel's
``w_pair`` carries the frequency tap j in its output fold slots instead.
On a CUDA tensor it launches ``lass_torch/csrc/convt.cu`` (bfloat16, C_in
64 or 128, C_out 32 or 64: the decoder's two fused up-samplings) or
raises; on a CPU tensor it runs ``act_convT_plain``. Eval only: no
backward, as in the JAX package.

The kernel is persistent: each warpgroup keeps both time phases' weights
resident in shared memory (``phase_weights``, packed by
``_common.pack_b``), walks 64-position input tiles through a cp.async
ring, and writes each phase's 64 x 2 C_out product, one contiguous run of
output row 2t + i, in 16-byte stores. It is bound by memory; its design
and numbers are in its source and PERF.md.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from lass_torch.ops import _common

# number of kernel launches since the last reset (the CPU path never adds)
LAUNCHES = 0
_WHAT = "fused act+convT"
# the widths the kernel is built for (its weights, ring and stages fill a
# block's shared memory at 128 -> 64)
KERNEL_CIN = (64, 128)
KERNEL_COUT = (32, 64)


def act_convT_plain(x, inv, shift, beta, w) -> torch.Tensor:
    """Plain version with the kernel's rounding points: BN affine, FiLM add
    and leaky ReLU op by op in x's dtype, the slope 0.01 rounded to x's
    dtype too (as the TPU kernel computes them), then a float32 transposed
    conv of the rounded operands, rounded to x's dtype. channels_last
    output."""
    dt = x.dtype
    h = x * inv.to(dt)[None, :, None, None] + shift.to(dt)[None, :, None, None]
    slope = torch.tensor(0.01, dtype=dt).item()
    z = F.leaky_relu(h + beta.to(dt)[:, :, None, None], slope)
    y = F.conv_transpose2d(z.float(), w.to(dt).float(), stride=2).to(dt)
    return y.contiguous(memory_format=_common.CL)


def phase_weights(w: torch.Tensor) -> torch.Tensor:
    """(C_in, C_out, 2, 2) -> (phase i, C_in, 2 C_out) with column
    j * C_out + o: for each time phase i, the operand whose product with
    a tile of positions is the output run of row 2t + i."""
    cin, cout = w.shape[:2]
    return w.detach().permute(2, 0, 3, 1).reshape(2, cin, 2 * cout)


def _check(x, inv, shift, beta, w) -> None:
    _common.require_channels_last(_WHAT, [x])
    batch, cin = x.shape[0], x.shape[1]
    if w.dim() != 4 or w.shape[0] != cin or tuple(w.shape[2:]) != (2, 2):
        raise ValueError(f"{_WHAT} weight must be ({cin}, C_out, 2, 2), got "
                         f"{tuple(w.shape)}")
    if tuple(inv.shape) != (cin,) or tuple(shift.shape) != (cin,):
        raise ValueError(f"{_WHAT} inv/shift must be ({cin},)")
    if tuple(beta.shape) != (batch, cin):
        raise ValueError(f"{_WHAT} beta must be ({batch}, {cin}), got "
                         f"{tuple(beta.shape)}")
    _common.same_device(_WHAT, [x, inv, shift, beta, w])
    _common.forbid_grad(_WHAT, [x, inv, shift, beta, w])


def _launch(x, inv, shift, beta, w) -> torch.Tensor:
    from lass_torch.ops._build import load_library

    global LAUNCHES
    _common.require_bf16_rows(_WHAT, [x])
    batch, cin, t, f = x.shape
    cout = w.shape[1]
    if cin not in KERNEL_CIN or cout not in KERNEL_COUT:
        raise ValueError(f"{_WHAT} kernel takes C_in in {KERNEL_CIN} and "
                         f"C_out in {KERNEL_COUT}, got {cin} -> {cout}")
    lib = load_library()
    dt = x.dtype
    # the affine constants rounded to the activation dtype, as float32
    inv, shift, beta = (v.detach().to(dt).float().contiguous()
                        for v in (inv, shift, beta))
    wp = _common.pack_b(phase_weights(w).to(torch.bfloat16))
    out = torch.empty((batch, cout, 2 * t, 2 * f), dtype=dt, device=x.device,
                      memory_format=_common.CL)
    _common.launch(lib.lass_act_convt, x.device, _WHAT, x.data_ptr(),
                   *_common.nhwc_strides(x), inv.data_ptr(),
                   shift.data_ptr(), beta.data_ptr(), wp.data_ptr(),
                   out.data_ptr(), *_common.nhwc_strides(out), batch, t, f,
                   cin, cout)
    LAUNCHES += 1
    return out


def fused_act_convT(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
                    beta: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: channels_last (B, C_in, T, F); inv, shift: (C_in,) float32 eval
    BN affine; beta: (B, C_in) float32 FiLM beta; w: (C_in, C_out, 2, 2)
    float32. Returns channels_last (B, C_out, 2T, 2F). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    _check(x, inv, shift, beta, w)
    if _common.device_kind(x, _WHAT) == "cpu":
        return act_convT_plain(x, inv, shift, beta, w)
    return _launch(x, inv, shift, beta, w)
