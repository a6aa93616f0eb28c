"""Residual blocks that run the fused-conv kernels in eval.

Counterparts of the kernel-routing parts of ``lass_tpu/ops/folded.py``
(``FoldedConvBlockRes``, ``FoldedEncoderBlockRes1B``,
``FoldedDecoderBlockRes1B``) on the logical layout, without any folding.
They subclass ``nn/blocks.py``'s classes, so parameter names and state
dicts are identical. Eval BatchNorm and the FiLM beta fold into the
kernels' per-(batch, channel) float32 affine, as the JAX package folds them:
a = BN scale, b = BN shift + beta. In train mode every block runs the
unfused path (the JAX package's ``not train`` rule).

Switches (all off by default, as in the JAX package):

- ``sparse_conv``: each 3x3 conv of the block is one
  ``fused_act_conv3x3`` launch that applies its BN + FiLM + leaky in the
  operand load; a decoder's [upsampled, skip] concat enters as two
  sources. The 1x1 shortcut (over the concat, which it materialises) and
  the residual add stay outside the kernel.
- ``fused_conv_block``: a block with in == out channels and one source is
  one ``fused_residual_conv_block`` launch. ``sparse_conv`` takes
  precedence where both are on.
- ``fused_convT``: a decoder's bn1 + FiLM + leaky + 2x2 transposed conv is
  one ``fused_act_convT`` launch.

With ``quantize`` as well, a block that a fused kernel takes stays on it
(bf16), as the JAX package's fused paths return before its int8 branch
(``lass_tpu/ops/folded.py``); the others run ``ConvBlockRes``'s int8 path.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch

from lass_torch.nn.blocks import (
    ConvBlockRes, DecoderBlockRes1B, EncoderBlockRes1B, _film)
from lass_torch.nn.layers import BatchNorm, leaky_relu
from lass_torch.ops.act_conv import fused_act_conv3x3
from lass_torch.ops.convblock import fused_residual_conv_block
from lass_torch.ops.convt import fused_act_convT

Sources = Union[torch.Tensor, Sequence[torch.Tensor]]


def fold_affine(bn: BatchNorm, beta: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN + FiLM beta as (B, C) float32 (a, b): bn(x) + beta ==
    a * x + b."""
    inv, shift = bn.scale_shift()
    batch = beta.shape[0]
    return (inv[None].expand(batch, -1).contiguous(),
            shift[None] + beta.float())


class FusedConvBlockRes(ConvBlockRes):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 momentum: float = 0.01, sparse_conv: bool = False,
                 fused_conv_block: bool = False, quantize: bool = False):
        three = tuple(kernel_size) == (3, 3)
        sparse_conv = sparse_conv and three
        fused_conv_block = (fused_conv_block and three
                            and in_channels == out_channels)
        # a block a fused kernel takes in eval has no int8 path
        super().__init__(in_channels, out_channels, kernel_size, momentum,
                         quantize and not (sparse_conv or fused_conv_block))
        self.sparse_conv = sparse_conv
        self.fused_conv_block = fused_conv_block

    def forward(self, x: Sources, film: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        """x: one activation or the [upsampled, skip] pair whose channel
        concat is the block's input."""
        sources = (x,) if torch.is_tensor(x) else tuple(x)
        if not self.training and self.sparse_conv:
            return self._sparse(sources, film)
        if (not self.training and self.fused_conv_block
                and len(sources) == 1):
            a1, b1 = fold_affine(self.bn1, film["beta1"])
            a2, b2 = fold_affine(self.bn2, film["beta2"])
            return fused_residual_conv_block(
                sources[0], self.conv1.weight, self.conv2.weight,
                a1, b1, a2, b2)
        x = sources[0] if len(sources) == 1 else torch.cat(sources, 1)
        return super().forward(x, film)

    def _sparse(self, sources, film) -> torch.Tensor:
        a1, b1 = fold_affine(self.bn1, film["beta1"])
        h = fused_act_conv3x3(sources, self.conv1.weight, a1, b1)
        a2, b2 = fold_affine(self.bn2, film["beta2"])
        h = fused_act_conv3x3((h,), self.conv2.weight, a2, b2)
        if not self.has_shortcut:
            return sources[0] + h
        # the 1x1 shortcut over the concat, one product rounded once, as
        # the JAX package's folded_conv and the unfused block compute it
        x = sources[0] if len(sources) == 1 else torch.cat(sources, 1)
        return self.shortcut(x) + h


class FusedEncoderBlockRes1B(EncoderBlockRes1B):
    """EncoderBlockRes1B whose conv block is a FusedConvBlockRes; takes
    its ``sparse_conv`` / ``fused_conv_block`` switches."""

    conv_block = FusedConvBlockRes


class FusedDecoderBlockRes1B(DecoderBlockRes1B):
    """DecoderBlockRes1B with the fused up-sampling (``fused_convT``) and a
    FusedConvBlockRes that takes the skip concat as two sources."""

    conv_block = FusedConvBlockRes

    def __init__(self, in_channels: int, out_channels: int,
                 upsample: Tuple[int, int],
                 kernel_size: Tuple[int, int] = (3, 3),
                 momentum: float = 0.01, fused_convT: bool = False,
                 **block_options):
        super().__init__(in_channels, out_channels, upsample, kernel_size,
                         momentum, **block_options)
        self.fused_convT = fused_convT and tuple(upsample) == (2, 2)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, film: Dict
                ) -> torch.Tensor:
        if self.fused_convT and not self.training:
            inv, shift = self.bn1.scale_shift()
            h = fused_act_convT(x, inv, shift, film["beta1"],
                                self.conv1.weight)
        else:
            h = self.conv1(leaky_relu(_film(self.bn1(x), film["beta1"])))
        return self.conv_block2((h, skip), film["conv_block2"])
