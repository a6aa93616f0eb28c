"""Time-tap convolution (the dw = 0 column of a 3x3 conv): CUDA kernel and
plain version.

``timetap_conv`` is the port of the Pallas TPU kernel
``scripts/microbench_tridiag.py::tridiag_conv``:

    y[b, t, g] = sum_{dt=0..2} act(x[b, t + dt - 1, g]) @ w3[dt*C:(dt+1)*C]

x (B, T, G, C), w3 (3C, C), rows outside [0, T) zero (SAME), act the
identity or ``max(x, 0.01 * x)`` in x's dtype with the slope rounded to
it (what the JAX kernel's ``jnp.maximum(x, 0.01 * x)`` computes on bf16),
float32 accumulation, the output in x's dtype. The TPU kernel's first and
last time tiles read shifted and out-of-range rows; this is the function
the microbench stands for (the SAME time conv), which the TPU kernel
computes on its interior tiles.

On a CUDA tensor it launches ``lass_torch/csrc/timetap_conv.cu`` (bf16,
C of 32, 64 or 128) or raises; on a CPU tensor it runs the plain version
``timetap_conv_plain``. Its entry point is the microbench
``python -m lass_torch.microbench_tridiag``; no model path calls it. Eval
only: no backward, as the TPU kernel has none.
"""
from __future__ import annotations

import torch

from lass_torch.ops import _common

# number of kernel launches since the last reset (the CPU path never adds)
LAUNCHES = 0
_WHAT = "time-tap conv"
T_TILES = (16, 32, 64)


def leaky_rounded(x: torch.Tensor) -> torch.Tensor:
    """max(x, s * x) in x's dtype with s = 0.01 rounded to that dtype."""
    slope = torch.tensor(0.01, dtype=x.dtype, device=x.device)
    return torch.maximum(x, x * slope)


def timetap_conv_plain(x: torch.Tensor, w3: torch.Tensor,
                       fuse_act: bool = False) -> torch.Tensor:
    """Plain version with the kernel's rounding points: the activation in
    x's dtype, w3 rounded to it, a float32 sum of the three taps, the
    result rounded to x's dtype."""
    b, t, g, c = x.shape
    h = (leaky_rounded(x) if fuse_act else x).float()
    h = torch.nn.functional.pad(h, (0, 0, 0, 0, 1, 1))  # zero row each end
    w = w3.to(x.dtype).float().view(3, c, c)
    y = sum(h[:, dt:dt + t] @ w[dt] for dt in range(3))
    return y.to(x.dtype)


def _check(x: torch.Tensor, w3: torch.Tensor, t_tile: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"{_WHAT} takes x of (B, T, G, C), got "
                         f"{tuple(x.shape)}")
    c = x.shape[3]
    if tuple(w3.shape) != (3 * c, c):
        raise ValueError(f"{_WHAT} weight must be ({3 * c}, {c}), got "
                         f"{tuple(w3.shape)}")
    if t_tile not in T_TILES:
        raise ValueError(f"{_WHAT} t_tile must be one of {T_TILES}, got "
                         f"{t_tile}")
    _common.same_device(_WHAT, [x, w3])
    _common.forbid_grad(_WHAT, [x, w3])


def _launch(x, w3, fuse_act: bool, t_tile: int) -> torch.Tensor:
    from lass_torch.ops._build import load_library

    global LAUNCHES
    b, t, g, c = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"{_WHAT} kernel takes contiguous bfloat16 x, got "
                         f"{x.dtype} strides {x.stride()}")
    if c not in (32, 64, 128) or x.data_ptr() % 16:
        raise ValueError(f"{_WHAT} kernel takes C of 32, 64 or 128 and a "
                         f"16-byte aligned x, got C={c}")
    lib = load_library()
    w = _common.pack_b(w3.detach().to(torch.bfloat16).view(3, c, c))
    out = torch.empty_like(x)
    _common.launch(lib.lass_timetap_conv, x.device, _WHAT, x.data_ptr(),
                   w.data_ptr(), out.data_ptr(), b, t, g, c, t_tile,
                   int(bool(fuse_act)))
    LAUNCHES += 1
    return out


def timetap_conv(x: torch.Tensor, w3: torch.Tensor, fuse_act: bool = False,
                 t_tile: int = 16) -> torch.Tensor:
    """x: (B, T, G, C); w3: (3C, C), cast to x's dtype; t_tile (16, 32 or
    64, the microbench's ``tt``): the kernel's persistent warpgroups split
    the (batch, 64-position g block) columns into units of t_tile time
    rows, each warpgroup walking an equal share of units down T with the
    halo carried, so t_tile sets the granularity of that split.
    Returns (B, T, G, C) in x's dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    _check(x, w3, t_tile)
    if _common.device_kind(x, _WHAT) == "cpu":
        return timetap_conv_plain(x, w3, fuse_act)
    return _launch(x, w3, fuse_act, t_tile)
