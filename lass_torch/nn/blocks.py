"""ResUNet residual blocks with FiLM conditioning (NCHW).

Counterparts of ``lass_tpu/nn/blocks.py``. FiLM betas arrive as a nested
dict of (B, C) float32 tensors from the fused projection
(``lass_torch/models/film.py``); each is added after BatchNorm and before
the leaky ReLU. Module and parameter names are the reference torch names,
so a reference checkpoint's ``base.*`` keys load as they are.

``ConvBlockRes(quantize=True)`` runs its convs in int8 in eval
(``lass_torch/ops/quant.py``; the JAX package's ``_call_quant``): one
``QConv`` per conv (``conv1_q``, ``conv2_q``, ``shortcut_q``) holds the
calibrated input scales and the pack as non-persistent buffers, so the
state dict is the float block's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from lass_torch.nn.layers import (
    BatchNorm, Conv2d, ConvTranspose2d, avg_pool, leaky_relu)
from lass_torch.ops.quant import QConv


def _film(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """(B, C) FiLM beta added to an NCHW activation in its dtype."""
    return x + beta.to(x.dtype)[:, :, None, None]


class ConvBlockRes(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 momentum: float = 0.01, quantize: bool = False):
        super().__init__()
        self.bn1 = BatchNorm(in_channels, momentum)
        self.conv1 = Conv2d(in_channels, out_channels, kernel_size,
                            bias=False)
        self.bn2 = BatchNorm(out_channels, momentum)
        self.conv2 = Conv2d(out_channels, out_channels, kernel_size,
                            bias=False)
        self.has_shortcut = in_channels != out_channels
        if self.has_shortcut:
            self.shortcut = Conv2d(in_channels, out_channels, (1, 1))
        self.quantize = quantize
        if quantize:
            self.conv1_q = QConv(in_channels)
            self.conv2_q = QConv(out_channels)
            if self.has_shortcut:
                self.shortcut_q = QConv(in_channels)

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Conv ``name`` in float, or through its QConv in quantized eval."""
        conv = getattr(self, name)
        if self.quantize and not self.training:
            return getattr(self, f"{name}_q")(x, conv)
        return conv(x)

    def forward(self, x: torch.Tensor, film: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        h = self._conv("conv1", leaky_relu(_film(self.bn1(x), film["beta1"])))
        h = self._conv("conv2", leaky_relu(_film(self.bn2(h), film["beta2"])))
        if self.has_shortcut:
            return self._conv("shortcut", x) + h
        return x + h


class EncoderBlockRes1B(nn.Module):
    conv_block = ConvBlockRes  # subclasses swap in a fused block

    def __init__(self, in_channels: int, out_channels: int,
                 downsample: Tuple[int, int],
                 kernel_size: Tuple[int, int] = (3, 3),
                 momentum: float = 0.01, **block_options):
        super().__init__()
        self.conv_block1 = self.conv_block(in_channels, out_channels,
                                           kernel_size, momentum,
                                           **block_options)
        self.downsample = tuple(downsample)

    def forward(self, x: torch.Tensor, film: Dict
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (pooled, pre-pool) activations."""
        encoded = self.conv_block1(x, film["conv_block1"])
        if self.downsample == (1, 1):
            return encoded, encoded
        return avg_pool(encoded, self.downsample), encoded


class DecoderBlockRes1B(nn.Module):
    """Up-sample (kernel == stride transposed conv) + skip concat +
    residual conv block. ``skip_channels`` is the skip's width (-1: as
    out_channels, the reference's case); the multi-resolution variant's
    decoder_block6 takes the fused branches' wider skip."""

    conv_block = ConvBlockRes  # subclasses swap in a fused block

    def __init__(self, in_channels: int, out_channels: int,
                 upsample: Tuple[int, int],
                 kernel_size: Tuple[int, int] = (3, 3),
                 momentum: float = 0.01, skip_channels: int = -1,
                 **block_options):
        super().__init__()
        skip = out_channels if skip_channels == -1 else skip_channels
        self.bn1 = BatchNorm(in_channels, momentum)
        self.conv1 = ConvTranspose2d(in_channels, out_channels, upsample)
        self.conv_block2 = self.conv_block(out_channels + skip, out_channels,
                                           kernel_size, momentum,
                                           **block_options)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, film: Dict
                ) -> torch.Tensor:
        h = self.conv1(leaky_relu(_film(self.bn1(x), film["beta1"])))
        h = torch.cat([h, skip], dim=1)
        return self.conv_block2(h, film["conv_block2"])
