"""Int8 post-training quantization of the residual blocks' convs (eval
only; counterpart of lass_tpu/ops/quant.py).

Scheme, as in the JAX package:

- activations: symmetric int8 per input channel with static scales
  calibrated on representative batches (running max of |x| per channel,
  ``QConv.observe``); channels that never saw a non-zero value fall back to
  scale 1; the scales carry the safety margin ``MARGIN``;
- channel equalization: each input channel's activation scale is absorbed
  into the float weight before weight quantization, so the dequantization
  is per output channel only;
- weights: symmetric int8 per output channel;
- the product: int8 x int8 with exact int32 accumulation, dequantized by
  the weight scale, then the bias correction and the conv's bias, in
  float32, rounded to the activation dtype.

The int8 product is ``int8_conv_int32``: an im2col of the int8
activations (NHWC, the kh * kw taps side by side) and one
``torch._int_mm`` (int8 x int8 -> int32; cuBLAS on the card) per chunk of
batch items. The JAX package has no Pallas kernel here either (it uses
XLA's int8 conv, or per-tap int8 dots under ``LASS_TPU_QUANT_IMPL=dot``,
which give the same int32 sums), so the port has this one route and no
switch. A hand-written s8 wgmma kernel with the quantize fused into its
operand load is later work.

Calibration and packing (``SeparationInference.calibrate`` / ``pack`` in
``lass_torch/evaluation/dcase.py`` drive them through ``set_mode``):

- ``"calibrate"``: each conv records the amax of its input and runs the
  float conv, so the forward equals the float model's;
- ``"pack"``: each conv quantizes its equalized weight once (kq, sw),
  runs the int8 product, and records the bias correction
  bc = mean(y_float - y_int8) per output channel over the pack batch
  (``bias_correction``; the JAX package's ``LASS_TPU_QUANT_BC``). The pass
  is sequential: each layer's float reference is computed on activations
  its quantized and corrected predecessors produced, so bc absorbs the
  DC error of the whole prefix. Packing always recomputes;
- ``"int8"``: packed convs read kq, sw and bc; a conv without a pack
  quantizes its weight in the forward (the same int8 values, no bc).

The scales and the pack are non-persistent buffers: the state dict, and so
every checkpoint, is the float model's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lass_torch.utils.precision import ieee_float32

# safety margin on the calibrated scales (the JAX package's
# LASS_TPU_QUANT_MARGIN, default 1.0)
MARGIN = 1.0
# im2col elements per int8 product call. The widest conv of a B=16 x 10 s
# forward (32 channels at 1024 x 512, K = 288) would need 2.4e9, past the
# 2^31 a cuBLAS call can index, as one product; 2^28 (256 MiB of int8) is
# one batch item of it per call (see PERF.md for its times)
CHUNK_ELEMENTS = 2 ** 28
# cuBLAS's int8 product needs more than 16 rows (torch._int_mm)
_MIN_ROWS = 17
MODES = ("calibrate", "pack", "int8")


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per output channel: (O, I, kh, kw) -> (int8 weight,
    float32 scale (O,)). round(|max| / sw) == 127 exactly, so no clip."""
    k32 = w.float()
    sw = torch.clamp(k32.abs().amax(dim=(1, 2, 3)) / 127.0, min=1e-30)
    kq = torch.round(k32 / sw[:, None, None, None]).to(torch.int8)
    return kq, sw


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 with static per-channel scales (C,) of an NCHW
    activation: multiply by the reciprocal, round half to even, clip to
    +-127. The result is channels_last in memory (NHWC, what the im2col
    reads): the product of x, widened to float32, and the float32
    reciprocal is written there in one pass, then rounded and clipped in
    place."""
    z = torch.empty(x.shape, dtype=torch.float32, device=x.device,
                    memory_format=torch.channels_last)
    torch.mul(x, (1.0 / scale.float())[None, :, None, None], out=z)
    return z.round_().clamp_(-127.0, 127.0).to(torch.int8)


def int8_conv_int32(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv (padding k // 2) of int8 NCHW ``xq`` with int8
    (O, C, kh, kw) ``kq``, exact int32 sums; returns (B, H, W, O) int32.

    im2col over (dt, df, c) in NHWC, then ``torch._int_mm`` against the
    (kh * kw * C, O) weight, in chunks of whole batch items of at most
    CHUNK_ELEMENTS im2col elements. The weight goes in as the transpose of
    a contiguous (O, K) matrix, cuBLAS's fast int8 layout (3-5x the
    contiguous (K, O) one on the H100, PERF.md); the im2col copies 8
    channels per int64 element where C % 8 == 0."""
    b, c, h, w = xq.shape
    o, _, kh, kw = kq.shape
    wt = kq.permute(0, 2, 3, 1).reshape(o, kh * kw * c).t()
    x = xq.permute(0, 2, 3, 1)
    if kh * kw > 1:
        x = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    out = torch.empty(b, h, w, o, dtype=torch.int32, device=xq.device)
    step = max(1, CHUNK_ELEMENTS // (h * w * kh * kw * c))
    wide = torch.int64 if c % 8 == 0 and x.is_contiguous() else torch.int8
    for b0 in range(0, b, step):
        xb = x[b0:b0 + step]
        if kh * kw > 1:
            xw = xb.view(wide)
            xb = torch.cat([xw[:, dt:dt + h, df:df + w]
                            for dt in range(kh) for df in range(kw)],
                           -1).view(torch.int8)
        cols = xb.reshape(-1, kh * kw * c)
        rows = cols.shape[0]
        dest = out[b0:b0 + step].view(rows, o)
        if rows < _MIN_ROWS:
            dest.copy_(torch._int_mm(
                F.pad(cols, (0, 0, 0, _MIN_ROWS - rows)), wt)[:rows])
        else:
            torch._int_mm(cols, wt, out=dest)
    return out


def _int8_nhwc(x: torch.Tensor, kq: torch.Tensor, sw: torch.Tensor,
               x_scale: torch.Tensor) -> torch.Tensor:
    """The dequantized int8 product, float32 (B, H, W, O): the int32 sums
    widened to float32 and multiplied by sw in one pass."""
    return torch.mul(int8_conv_int32(quantize_act(x, x_scale), kq), sw)


def _finish(y: torch.Tensor, bias: Optional[torch.Tensor],
            like: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Add the conv's bias to float32 NHWC ``y``; return it as NCHW in
    ``out_dtype`` and in ``like``'s memory format."""
    if bias is not None:
        y = y + bias.float()
    fmt = (torch.channels_last if like.is_contiguous(
        memory_format=torch.channels_last) and not like.is_contiguous()
        else torch.contiguous_format)
    return y.permute(0, 3, 1, 2).to(out_dtype, memory_format=fmt)


def conv_int8(x: torch.Tensor, w: Optional[torch.Tensor],
              x_scale: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
              out_dtype: Optional[torch.dtype] = None,
              packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """Stride-1 SAME conv with both operands in int8 and int32 sums,
    dequantized to ``out_dtype`` (default x.dtype). ``w``: the float
    (O, C, kh, kw) weight, equalized by ``x_scale`` and quantized here;
    or None with ``packed`` = (kq, sw) from ``quantize_weight`` of the
    equalized weight."""
    if packed is None:
        packed = quantize_weight(w.float() * x_scale[None, :, None, None])
    y = _int8_nhwc(x, *packed, x_scale)
    return _finish(y, bias, x, out_dtype or x.dtype)


class QConv(nn.Module):
    """Int8 state of one conv call site (the JAX package's
    ``amax_observer`` + ``qconv``): the calibrated amax of the input
    channels and the pack (kq, sw, bc), all non-persistent buffers.
    ``forward(x, conv)`` runs the float ``conv`` (a stride-1 SAME
    nn.Conv2d) per ``mode`` (module docstring)."""

    def __init__(self, lanes: int):
        super().__init__()
        self.register_buffer("amax", torch.zeros(lanes), persistent=False)
        self.register_buffer("kq", None, persistent=False)
        self.register_buffer("sw", None, persistent=False)
        self.register_buffer("bc", None, persistent=False)
        self.mode = "int8"
        self.bias_correction = True
        self.calibrated = False

    def observe(self, x: torch.Tensor) -> None:
        """Running max of |x| per channel of NCHW x."""
        self.amax = torch.maximum(self.amax, x.detach().float().abs().amax(
            dim=(0, 2, 3)))
        self.calibrated = True

    def scale(self) -> torch.Tensor:
        amax = torch.where(self.amax > 0.0, self.amax,
                           torch.full_like(self.amax, 127.0))
        return amax * (MARGIN / 127.0)

    def drop_pack(self) -> None:
        self.kq = self.sw = self.bc = None

    def forward(self, x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        if self.mode == "calibrate":
            self.observe(x)
            return conv(x)
        if not self.calibrated:
            raise RuntimeError(
                "int8 conv used before calibration: run "
                "SeparationInference.calibrate (or load calibrated scales) "
                "first")
        scale = self.scale()
        if self.mode == "pack":
            self.kq, self.sw = quantize_weight(
                conv.weight.float() * scale[None, :, None, None])
            y = _int8_nhwc(x, self.kq, self.sw, scale)
            self.bc = None
            if self.bias_correction:
                with ieee_float32():
                    y_f = F.conv2d(x.float(), conv.weight.float(), None,
                                   padding=conv.padding)
                self.bc = (y_f.permute(0, 2, 3, 1) - y).mean(dim=(0, 1, 2))
        elif self.kq is None:
            return conv_int8(x, conv.weight, scale, bias=conv.bias)
        else:
            y = _int8_nhwc(x, self.kq, self.sw, scale)
        if self.bc is not None:
            y = y + self.bc
        return _finish(y, conv.bias, x, x.dtype)


def quant_layers(model: nn.Module) -> List[QConv]:
    return [m for m in model.modules() if isinstance(m, QConv)]


def set_mode(model: nn.Module, mode: str, bias_correction: bool = True
             ) -> None:
    """Put every QConv of ``model`` in ``mode``. Entering "calibrate"
    drops every pack: new scales make it stale."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    for layer in quant_layers(model):
        layer.mode = mode
        layer.bias_correction = bias_correction
        if mode == "calibrate":
            layer.drop_pack()


def load_quant_state(model: nn.Module, state: Dict[str, torch.Tensor]
                     ) -> None:
    """Set QConv buffers from ``{'<module path>.<amax|kq|sw|bc>': tensor}``
    (``lass_torch.convert.from_jax.quant_state_from_jax``). Every QConv of
    the model must get its amax; a pack is all of kq, sw, bc or none."""
    layers = {name: m for name, m in model.named_modules()
              if isinstance(m, QConv)}
    by_layer: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in state.items():
        prefix, _, buf = key.rpartition(".")
        if prefix not in layers or buf not in ("amax", "kq", "sw", "bc"):
            raise KeyError(f"{key} is not a quantization buffer of the model")
        by_layer.setdefault(prefix, {})[buf] = value
    missing = sorted(set(layers) - {k for k, v in by_layer.items()
                                    if "amax" in v})
    if missing:
        raise KeyError(f"no calibrated amax for {missing[:8]}")
    for name, bufs in by_layer.items():
        layer = layers[name]
        device = layer.amax.device
        layer.amax = bufs["amax"].float().to(device)
        layer.calibrated = True
        pack = [bufs.get(k) for k in ("kq", "sw", "bc")]
        if any(p is not None for p in pack) and any(p is None for p in pack):
            raise KeyError(f"{name}: a pack needs kq, sw and bc")
        kq, sw, bc = pack
        layer.kq = None if kq is None else kq.to(device, torch.int8)
        layer.sw = None if sw is None else sw.float().to(device)
        layer.bc = None if bc is None else bc.float().to(device)
