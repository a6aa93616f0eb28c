"""Linear-probe training (the task of scripts/linear_probe.py): only the
probe head ``lp_layer`` trains, Adam (0.9, 0.999, 1e-8) with decoupled
weight decay under a LambdaLR multiplier, on ``lp_loss``; the MLP head's
dropout draws from a CPU generator seeded from (seed, step)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from lass_torch.evaluation.linear_probe import lp_loss
from lass_torch.tasks.clap_pretrain import step_generator
from lass_torch.train.checkpoint import TaskCheckpoint


class ProbeTask(TaskCheckpoint):
    """``probe`` (a ``LinearProbe``), its optimizer and schedule over
    ``lp_layer``, the step; ``schedule`` maps the update count (from 0) to
    the learning-rate multiplier."""

    def __init__(self, probe: nn.Module, loss: str = "bce", lr: float = 1e-4,
                 weight_decay: float = 0.0,
                 schedule: Optional[Callable[[int], float]] = None,
                 seed: int = 0):
        self.probe = probe
        self.loss_fn = lp_loss(loss)
        self.optimizer = torch.optim.AdamW(
            probe.lp_layer.parameters(), lr=lr, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, schedule or (lambda step: 1.0))
        self.seed = seed
        self.step = 0

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.probe.state_dict()

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        self.probe.load_state_dict(sd)

    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """batch: 'waveform' (B, L) and 'class_label' (B, C) on the probe's
        device. Returns {'lp_loss'} as a 0-d tensor, unsynchronised."""
        self.probe.train()
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.probe(batch["waveform"],
                            generator=step_generator(self.seed, self.step))
        loss = self.loss_fn(logits, batch["class_label"])
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return {"lp_loss": loss.detach()}
