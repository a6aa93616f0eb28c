"""Training tasks of the precomputed-STFT variants (counterpart of
lass_tpu/tasks/audiosep_variants.py).

- ``MultiSTFTAudioSepTask``: batches of precomputed {win: (mag, cos, sin)}
  mixture STFTs (``lass_torch/data/precomputed.py``) through a
  ``MultiSTFTResUNet30``, text conditioning (the frozen caption embedding,
  detached), L1 on the waveform, AMSGrad + LR schedule; ``val_step`` is
  the same loss in eval mode.
- ``NegQueryAudioSepTask``: the single-window (512,) model conditioned on
  the fusion of a positive and a negative caption embedding
  (``NegQueryFusion``). The fusion is trainable: its weight is in the
  optimizer and in the checkpoint (the reference's lazily made projection
  is neither).

Batches are {'stfts': {'mixture': {win: (mag, cos, sin)}, ...},
'target_waveform': (B, 1, L)} with tensors on the task's device.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from lass_torch.losses import l1
from lass_torch.train.checkpoint import SeparatorCheckpoint


def negative_captions(pos_caps: Sequence[str],
                      mixture_component_texts) -> List[str]:
    """Each item's negative caption: the second caption of its mixture's
    components, '' where there is none (reference
    audiosep_with_neg_query.py:57-70)."""
    if mixture_component_texts is None:
        return [""] * len(pos_caps)
    negs = [lst[1] if isinstance(lst, (list, tuple)) and len(lst) > 1 else ""
            for lst in mixture_component_texts]
    if len(negs) != len(pos_caps):
        negs = (negs + [""] * len(pos_caps))[:len(pos_caps)]
    return negs


class NegQueryFusion(nn.Module):
    """concat(pos, neg) (B, 2 * D) -> Linear(2D -> joint, no bias,
    xavier-uniform) -> L2-normalised with max(norm, 1e-12)."""

    def __init__(self, joint_embed_dim: int = 512, query_dim: int = 512):
        super().__init__()
        self.fusion = nn.Linear(2 * query_dim, joint_embed_dim, bias=False)
        nn.init.xavier_uniform_(self.fusion.weight)

    def forward(self, pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
        out = self.fusion(torch.cat([pos, neg], dim=-1).float())
        norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        return out / torch.clamp(norm, min=1e-12)


def stft_input(batch: Dict, wins: Sequence[int]) -> Dict[str, Dict]:
    """The model's STFT inputs from a batch's mixture role."""
    mix = batch["stfts"]["mixture"]
    return {"stft_mixture_mag": {w: mix[w][0] for w in wins},
            "stft_mixture_cos": {w: mix[w][1] for w in wins},
            "stft_mixture_sin": {w: mix[w][2] for w in wins}}


class MultiSTFTAudioSepTask(SeparatorCheckpoint):
    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 scheduler: torch.optim.lr_scheduler.LRScheduler,
                 loss_fn: Optional[Callable] = None):
        """model: a MultiSTFTResUNet30; optimizer and scheduler from
        ``lass_torch.train.optim.build_optimizer`` over ``parameters()``."""
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.loss_fn = loss_fn or l1
        self.wins = tuple(model.win_lengths)
        self.step = 0

    def parameters(self) -> List[nn.Parameter]:
        return [p for m in self.modules().values() for p in m.parameters()]

    def condition(self, condition) -> torch.Tensor:
        """The model's condition from the frozen query embedding."""
        return condition.detach()

    def _loss(self, batch: Dict, condition) -> torch.Tensor:
        inputs = stft_input(batch, self.wins)
        inputs["condition"] = self.condition(condition)
        target = batch["target_waveform"][:, 0]
        out = self.model(inputs, target.shape[-1])
        return self.loss_fn(out["waveform"][:, 0], target)

    def train_step(self, batch: Dict, condition
                   ) -> Dict[str, torch.Tensor]:
        """One update in train mode (BatchNorm on the batch's statistics).
        Returns {'train_loss', 'grad_norm'} as 0-d tensors on the device."""
        for m in self.modules().values():
            m.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(batch, condition)
        loss.backward()
        grad_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad.float())
             for p in self.parameters() if p.grad is not None]))
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return {"train_loss": loss.detach(), "grad_norm": grad_norm.detach()}

    @torch.no_grad()
    def val_step(self, batch: Dict, condition) -> torch.Tensor:
        """The loss in eval mode (running BatchNorm statistics)."""
        for m in self.modules().values():
            m.eval()
        return self._loss(batch, condition)


class NegQueryAudioSepTask(MultiSTFTAudioSepTask):
    """The condition is the (pos, neg) embedding pair; the model should be
    a single-window MultiSTFTResUNet30, win_lengths=(512,) (the
    reference's desired_win_len, audiosep_with_neg_query.py:90-94)."""

    def __init__(self, model: nn.Module, fusion: NegQueryFusion,
                 optimizer: torch.optim.Optimizer,
                 scheduler: torch.optim.lr_scheduler.LRScheduler,
                 loss_fn: Optional[Callable] = None):
        """optimizer over ``parameters()``: the model's and the fusion's."""
        super().__init__(model, optimizer, scheduler, loss_fn)
        self.fusion = fusion

    def modules(self) -> Dict[str, nn.Module]:
        return {"model": self.model, "neg_query_fusion": self.fusion}

    def condition(self, condition: Tuple[torch.Tensor, torch.Tensor]
                  ) -> torch.Tensor:
        pos, neg = condition
        return self.fusion(pos.detach(), neg.detach())
