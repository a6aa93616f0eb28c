"""K=3 complex-mask apply + phase rotation: CUDA kernel and plain version.

``apply_complex_mask_ri`` is the port of the Pallas TPU kernel
``lass_tpu/ops/pallas_masking.py::apply_complex_mask_ri``. On a CUDA
tensor it launches ``lass_torch/csrc/masking.cu`` (built at first use by
``lass_torch/ops/_build.py``) or raises; on a CPU tensor it runs the plain
PyTorch version ``mask_math_from_ri`` below. The backward recomputes
through the plain formula with autograd, as the JAX custom_vjp does.

``apply_head_mask`` (below) fuses the 1x1 ``after_conv`` into the same
chain: the port of ``apply_head_mask_folded``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from lass_torch.ops import _common

# number of kernel launches since the last reset (the CPU path never adds)
LAUNCHES = 0


def mask_math_from_ri(l_mag: torch.Tensor, l_real: torch.Tensor,
                      l_imag: torch.Tensor, real_in: torch.Tensor,
                      imag_in: torch.Tensor, eps: float = 1e-10
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: mixture mag/cos/sin from the raw spectrum (power
    clamped at eps before the sqrt), sigmoid magnitude mask, tanh phase
    mask normalised by max(|.|, 1e-10), rotation, relu magnitude."""
    mag = torch.sqrt(torch.clamp(real_in * real_in + imag_in * imag_in,
                                 min=eps))
    cos_in, sin_in = real_in / mag, imag_in / mag
    mask_mag = torch.sigmoid(l_mag)
    mr, mi = torch.tanh(l_real), torch.tanh(l_imag)
    denom = torch.clamp(torch.sqrt(mr * mr + mi * mi), min=1e-10)
    mask_cos, mask_sin = mr / denom, mi / denom
    out_cos = cos_in * mask_cos - sin_in * mask_sin
    out_sin = sin_in * mask_cos + cos_in * mask_sin
    out_mag = torch.relu(mag * mask_mag)
    return out_mag * out_cos, out_mag * out_sin


def _check(args) -> None:
    shape, device = args[0].shape, args[0].device
    for a in args:
        if a.dim() != 3 or a.shape != shape:
            raise ValueError(
                f"mask inputs must share one (N, T, F) shape, got "
                f"{[tuple(x.shape) for x in args]}")
        if a.dtype != torch.float32:
            raise TypeError(f"mask inputs must be float32, got {a.dtype}")
        if a.device != device:
            raise ValueError("mask inputs must lie on one device")
        if a.shape[-1] > 1 and a.stride(-1) != 1:
            raise ValueError("mask inputs need unit stride along F")


def _vec4_ok(args, f: int) -> bool:
    return f % 4 == 0 and all(
        a.data_ptr() % 16 == 0 and a.stride(0) % 4 == 0
        and a.stride(1) % 4 == 0 for a in args)


def _launch(args) -> Tuple[torch.Tensor, torch.Tensor]:
    from lass_torch.ops._build import load_library

    global LAUNCHES
    lib = load_library()
    n, t, f = args[0].shape
    out_re = torch.empty((n, t, f), dtype=torch.float32,
                         device=args[0].device)
    out_im = torch.empty_like(out_re)
    flat = []
    for a in args:
        flat += [a.data_ptr(), a.stride(0), a.stride(1)]
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lass_apply_complex_mask_ri(
            *flat, out_re.data_ptr(), out_im.data_ptr(), n, t, f,
            int(_vec4_ok(args, f)), stream)
    if err != 0:
        raise RuntimeError(f"masking kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out_re, out_im


class _MaskRI(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l_mag, l_real, l_imag, real_in, imag_in):
        ctx.save_for_backward(l_mag, l_real, l_imag, real_in, imag_in)
        return _launch((l_mag, l_real, l_imag, real_in, imag_in))

    @staticmethod
    def backward(ctx, g_re, g_im):
        inputs = [a.detach().requires_grad_(True) for a in ctx.saved_tensors]
        with torch.enable_grad():
            out = mask_math_from_ri(*inputs)
        return torch.autograd.grad(out, inputs, (g_re, g_im),
                                   allow_unused=True)


def apply_complex_mask_ri(l_mag: torch.Tensor, l_real: torch.Tensor,
                          l_imag: torch.Tensor, real_in: torch.Tensor,
                          imag_in: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, T, F) x5 float32 -> (real, imag) each contiguous (N, T, F).

    Each input may be a strided view (own n and t strides, unit F stride).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    args = (l_mag, l_real, l_imag, real_in, imag_in)
    _check(args)
    if l_mag.device.type == "cpu":
        return mask_math_from_ri(*args)
    if l_mag.device.type != "cuda":
        raise ValueError(f"no masking kernel for device {l_mag.device}")
    return _MaskRI.apply(*args)


# ---------------------------------------------------------------------------
# Fused head: 1x1 after_conv + the mask chain in one kernel.
#
# ``apply_head_mask`` is the port of the Pallas TPU kernel
# ``lass_tpu/ops/pallas_masking.py::apply_head_mask_folded`` on the logical
# layout. On a CUDA tensor it launches ``lass_torch/csrc/head_mask.cu``
# (bfloat16 h) or raises; on a CPU tensor it runs ``head_mask_plain``. The
# backward recomputes through the plain version, as the JAX custom_vjp does.
# ---------------------------------------------------------------------------

HEAD_LAUNCHES = 0
_HEAD = "fused head + mask"
K = 3  # mask logits per output channel: magnitude, real, imaginary


def head_mask_plain(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    real_in: torch.Tensor, imag_in: torch.Tensor,
                    output_channels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version with the kernel's rounding points: w rounded to h's
    dtype, a float32 product and float32 bias (the logits are not rounded
    to h's dtype), the float32 mask chain. h: (B, C, T_h, F) with T_h >= T;
    w: (C_out * 3, C[, 1, 1]); bias: (C_out * 3,); real_in/imag_in:
    (B, 1, T, F_s >= F) float32, spectrum channel 0 serving every output
    channel. Returns (real, imag), each (B * C_out, T, F)."""
    b, c, _, f = h.shape
    t = real_in.shape[2]
    m = output_channels * K
    wq = w.reshape(m, c).to(h.dtype).float()
    logits = torch.einsum("bctf,mc->bmtf", h[:, :, :t].float(), wq) \
        + bias.float()[None, :, None, None]
    x = logits.view(b, output_channels, K, t, f)

    def rows(a):  # (B, C_out, T, F) -> (B * C_out, T, F)
        return a.reshape(b * output_channels, t, f)

    def spec(s):
        return rows(s[:, :1, :, :f].expand(b, output_channels, t, f))

    return mask_math_from_ri(rows(x[:, :, 0]), rows(x[:, :, 1]),
                             rows(x[:, :, 2]), spec(real_in), spec(imag_in))


def _check_head(h, w, bias, real_in, imag_in, output_channels) -> None:
    if h.dim() != 4 or real_in.dim() != 4 or real_in.shape != imag_in.shape:
        raise ValueError(
            f"{_HEAD} takes h (B, C, T_h, F) and spectra (B, 1, T, F_s), got "
            f"{tuple(h.shape)}, {tuple(real_in.shape)}, "
            f"{tuple(imag_in.shape)}")
    b, c, t_h, f = h.shape
    if (real_in.shape[0] != b or real_in.shape[2] > t_h
            or real_in.shape[3] < f):
        raise ValueError(f"{_HEAD}: spectrum {tuple(real_in.shape)} does not "
                         f"cover h {tuple(h.shape)}")
    m = output_channels * K
    if w.numel() != m * c or w.shape[0] != m or tuple(bias.shape) != (m,):
        raise ValueError(f"{_HEAD} weight must be ({m}, {c}[, 1, 1]) and bias"
                         f" ({m},), got {tuple(w.shape)}, {tuple(bias.shape)}")
    for s in (real_in, imag_in):
        if s.dtype != torch.float32 or (s.shape[3] > 1 and s.stride(3) != 1):
            raise ValueError(f"{_HEAD} spectra must be float32 with unit "
                             f"frequency stride")
    _common.same_device(_HEAD, [h, w, bias, real_in, imag_in])


def _launch_head(h, w, bias, real_in, imag_in, output_channels):
    from lass_torch.ops._build import load_library

    global HEAD_LAUNCHES
    _common.require_bf16_rows(_HEAD, [h])
    b, c, _, f = h.shape
    if c != 32:
        raise ValueError(f"{_HEAD} kernel takes h with 32 channels, got "
                         f"{tuple(h.shape)}")
    if not 1 <= output_channels <= 8 or real_in.shape[2] > 65535:
        raise ValueError(f"{_HEAD} kernel takes 1-8 output channels and "
                         f"T <= 65535")
    lib = load_library()
    t = real_in.shape[2]
    m = output_channels * K
    # (C_out * 3, C) -> (C, C_out * 3), rounded to h's dtype, as float32
    wq = w.detach().reshape(m, c).to(h.dtype).float().t().contiguous()
    bq = bias.detach().float().contiguous()
    out_re = torch.empty((b * output_channels, t, f), dtype=torch.float32,
                         device=h.device)
    out_im = torch.empty_like(out_re)
    _common.launch(
        lib.lass_head_mask, h.device, _HEAD, h.data_ptr(),
        *_common.nhwc_strides(h), c, wq.data_ptr(), bq.data_ptr(),
        output_channels, real_in.data_ptr(), real_in.stride(0),
        real_in.stride(2), imag_in.data_ptr(), imag_in.stride(0),
        imag_in.stride(2), out_re.data_ptr(), out_im.data_ptr(), b, t, f)
    HEAD_LAUNCHES += 1
    return out_re, out_im


class _HeadMask(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, bias, real_in, imag_in, output_channels):
        ctx.save_for_backward(h, w, bias, real_in, imag_in)
        ctx.output_channels = output_channels
        return _launch_head(h, w, bias, real_in, imag_in, output_channels)

    @staticmethod
    def backward(ctx, g_re, g_im):
        inputs = [a.detach().requires_grad_(True) for a in ctx.saved_tensors]
        with torch.enable_grad():
            out = head_mask_plain(*inputs, ctx.output_channels)
        return (*torch.autograd.grad(out, inputs, (g_re, g_im),
                                     allow_unused=True), None)


def apply_head_mask(h: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    real_in: torch.Tensor, imag_in: torch.Tensor,
                    output_channels: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused after_conv (1x1, C -> output_channels * 3, + bias) and mask
    apply. h: (B, C, T_h, F) decoder output, read for its first T rows;
    w: after_conv's (C_out * 3, C, 1, 1) weight; bias: (C_out * 3,);
    real_in/imag_in: the raw (B, 1, T, F_s >= F) mixture spectrum, read as
    its first F bins. Returns (real, imag), each contiguous
    (B * C_out, T, F) float32. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise. Differentiable (recompute)."""
    _check_head(h, w, bias, real_in, imag_in, output_channels)
    if _common.device_kind(h, _HEAD) == "cpu":
        return head_mask_plain(h, w, bias, real_in, imag_in, output_channels)
    return _HeadMask.apply(h, w, bias, real_in, imag_in, output_channels)
