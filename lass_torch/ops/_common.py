"""Argument checks and launch plumbing shared by the conv kernels' wrappers
(``act_conv``, ``convblock``, ``convt``, ``timetap_conv`` and the fused head
in ``masking``), and the weight packing of the wgmma kernels.
"""
from __future__ import annotations

from typing import Sequence

import torch

CL = torch.channels_last


def device_kind(x: torch.Tensor, what: str) -> str:
    """'cpu' (plain version) or 'cuda' (kernel); anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {x.device}")
    return x.device.type


def same_device(what: str, tensors: Sequence[torch.Tensor]) -> None:
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what} inputs must lie on one device")


def forbid_grad(what: str, tensors: Sequence[torch.Tensor]) -> None:
    """The eval kernels have no backward, as their TPU counterparts."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is an eval kernel with no backward; call it under "
            f"torch.no_grad() or torch.inference_mode()")


def require_channels_last(what: str, tensors: Sequence[torch.Tensor]) -> None:
    for t in tensors:
        if t.dim() != 4 or not t.is_contiguous(memory_format=CL):
            raise ValueError(
                f"{what} needs channels_last-contiguous 4-D activations, got "
                f"shape {tuple(t.shape)} strides {t.stride()}")


def require_bf16_rows(what: str, tensors: Sequence[torch.Tensor]) -> None:
    """What the kernels' 16-byte loads and stores need: bf16, contiguous
    channels, and 16-byte aligned rows."""
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} kernel takes bfloat16 activations, got "
                            f"{t.dtype}")
        if t.stride(1) != 1 and t.shape[1] > 1:
            raise ValueError(f"{what} kernel needs contiguous channels")
        if t.data_ptr() % 16 or any(s % 8 for s in (t.stride(0), t.stride(2),
                                                     t.stride(3))):
            raise ValueError(f"{what} kernel needs 16-byte aligned rows")


def nhwc_strides(t: torch.Tensor):
    """(batch, time, frequency) element strides of an NCHW tensor."""
    return t.stride(0), t.stride(2), t.stride(3)


def launch(fn, device: torch.device, what: str, *args) -> None:
    """Call C entry point ``fn`` on the current stream of ``device``; raise
    on a non-zero CUDA error code."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def pack_b(w: torch.Tensor) -> torch.Tensor:
    """(taps, K, N) weights -> wgmma's K-major B layout without swizzle, as
    ``csrc/sm90_pipe.cuh`` reads it: for each tap and k16 step, 8 x 8 core
    matrices (N / 8, 2 halves of K), each 8 N-rows of 8 contiguous K
    values. Returns a contiguous (taps, K / 16, N / 8, 2, 8, 8) tensor;
    K % 16 == 0 and N % 8 == 0."""
    taps, k, n = w.shape
    if k % 16 or n % 8:
        raise ValueError(f"pack_b needs K % 16 == 0 and N % 8 == 0, got "
                         f"{tuple(w.shape)}")
    # [tap, kk, khalf, k8, nb, n8] -> [tap, kk, nb, khalf, n8, k8]
    return w.reshape(taps, k // 16, 2, 8, n // 8, 8).permute(
        0, 1, 4, 2, 5, 3).contiguous()

