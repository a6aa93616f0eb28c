"""K=3 complex-mask apply + phase rotation: CUDA kernel and plain version.

``apply_complex_mask_ri`` is the port of the Pallas TPU kernel
``lass_tpu/ops/pallas_masking.py::apply_complex_mask_ri``. On a CUDA
tensor it launches ``lass_torch/csrc/masking.cu`` (built at first use by
``lass_torch/ops/_build.py``) or raises; on a CPU tensor it runs the plain
PyTorch version ``mask_math_from_ri`` below. The backward recomputes
through the plain formula with autograd, as the JAX custom_vjp does.
"""
from __future__ import annotations

from typing import Tuple

import torch

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
