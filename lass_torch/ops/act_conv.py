"""Fused pre-activation + 3x3 conv: CUDA kernel and plain version.

``fused_act_conv3x3`` is the port of the Pallas TPU kernel
``lass_tpu/ops/pallas_folded_conv.py::fused_act_folded_conv`` on the
logical layout (the TPU's frequency fold is a lane layout with no
counterpart here):

    y = conv3x3_SAME(leaky(a * x + b), W),   x = concat(sources, channels)

with a, b per-(batch, channel) float32 vectors (eval BatchNorm scale, and
its shift plus the FiLM beta). On a CUDA tensor it launches
``lass_torch/csrc/act_conv.cu`` (built at first use by
``lass_torch/ops/_build.py``) or raises; on a CPU tensor it runs the plain
version ``act_conv3x3_plain``. Eval only: there is no backward, as in the
JAX package. What bounds the kernel is in its source.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from lass_torch.ops import _common

# number of kernel launches since the last reset (the CPU path never adds)
LAUNCHES = 0
_WHAT = "fused act+conv3x3"
# widest input the kernel takes: 9 x 128 x 64 bf16 weights (147 KB), its
# ring of four 66-position rows (66 KB) and its output stage (8 KB) fill a
# block's shared memory
MAX_CIN = 128


def tap_weights(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, 3, 3) -> (tap = 3 * dt + df, C_in, C_out)."""
    cout, cin = w.shape[:2]
    return w.detach().permute(2, 3, 1, 0).reshape(9, cin, cout)


def act_conv3x3_plain(sources: Sequence[torch.Tensor], w: torch.Tensor,
                      a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version with the kernel's rounding points: a * x + b and the
    leaky ReLU in float32, the activation rounded to x's dtype, a float32
    conv of the rounded operands (SAME zero padding of the activated
    tensor), the result rounded to x's dtype. channels_last output."""
    x = sources[0] if len(sources) == 1 else torch.cat(tuple(sources), 1)
    dt = x.dtype
    h = F.leaky_relu(x.float() * a[:, :, None, None] + b[:, :, None, None],
                     0.01).to(dt)
    y = F.conv2d(h.float(), w.to(dt).float(), padding=1).to(dt)
    return y.contiguous(memory_format=_common.CL)


def _check(sources, w, a, b) -> None:
    if not 1 <= len(sources) <= 2:
        raise ValueError(f"{_WHAT} takes one or two sources, got "
                         f"{len(sources)}")
    _common.require_channels_last(_WHAT, sources)
    x0 = sources[0]
    for s in sources:
        if (s.shape[0], s.shape[2], s.shape[3]) != (
                x0.shape[0], x0.shape[2], x0.shape[3]) or s.dtype != x0.dtype:
            raise ValueError(
                f"{_WHAT} sources must share batch, time, frequency and "
                f"dtype, got {[(tuple(s.shape), s.dtype) for s in sources]}")
    batch, cin = x0.shape[0], sum(s.shape[1] for s in sources)
    if w.dim() != 4 or tuple(w.shape[1:]) != (cin, 3, 3):
        raise ValueError(f"{_WHAT} weight must be (C_out, {cin}, 3, 3), got "
                         f"{tuple(w.shape)}")
    for name, v in (("a", a), ("b", b)):
        if tuple(v.shape) != (batch, cin):
            raise ValueError(f"{_WHAT} {name} must be ({batch}, {cin}), got "
                             f"{tuple(v.shape)}")
    _common.same_device(_WHAT, [*sources, w, a, b])
    _common.forbid_grad(_WHAT, [*sources, w, a, b])


def _launch(sources, w, a, b) -> torch.Tensor:
    from lass_torch.ops._build import load_library

    global LAUNCHES
    x0 = sources[0]
    cin, cout = w.shape[1], w.shape[0]
    _common.require_bf16_rows(_WHAT, sources)
    if (sources[0].shape[1] % 8 or cin % 16 or cin > MAX_CIN
            or cout not in (32, 64)):
        raise ValueError(
            f"{_WHAT} kernel needs source-0 channels % 8 == 0, C_in % 16 == 0"
            f" and at most {MAX_CIN} (its nine taps' weights stay in shared "
            f"memory), and C_out 32 or 64; got "
            f"{[s.shape[1] for s in sources]} -> {cout}")
    lib = load_library()
    batch, _, t, f = x0.shape
    wp = _common.pack_b(tap_weights(w).to(torch.bfloat16))
    a = a.detach().float().contiguous()
    b = b.detach().float().contiguous()
    out = torch.empty((batch, cout, t, f), dtype=torch.bfloat16,
                      device=x0.device, memory_format=_common.CL)
    views = [[s.data_ptr(), *_common.nhwc_strides(s), s.shape[1]]
             for s in sources]
    if len(views) == 1:  # no second source: zero channels
        views.append([None, 0, 0, 0, 0])
    _common.launch(lib.lass_act_conv3x3, x0.device, _WHAT, *views[0],
                   *views[1],
                   a.data_ptr(), b.data_ptr(), wp.data_ptr(), out.data_ptr(),
                   *_common.nhwc_strides(out), batch, t, f, cout)
    LAUNCHES += 1
    return out


def fused_act_conv3x3(sources: Sequence[torch.Tensor], w: torch.Tensor,
                      a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sources: one or two channels_last (B, C_i, T, F) activations whose
    channel concat is the conv input (never materialised by the kernel);
    w: (C_out, sum C_i, 3, 3) float32, cast to the activation dtype; a, b:
    (B, sum C_i) float32. Returns channels_last (B, C_out, T, F).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bfloat16 only) or raise.
    """
    sources = tuple(sources)
    _check(sources, w, a, b)
    if _common.device_kind(sources[0], _WHAT) == "cpu":
        return act_conv3x3_plain(sources, w, a, b)
    return _launch(sources, w, a, b)
