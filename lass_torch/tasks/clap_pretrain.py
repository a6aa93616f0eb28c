"""CLAP contrastive pretraining (counterpart of
lass_tpu/tasks/clap_pretrain.py).

The reference's open_clip/loss.py ClipLoss (:125-317, the mlp_loss=False
path) with two logit scales, each initialised to ln(1 / 0.07)
(open_clip/model.py:572-573) and clamped at ln(100) after every update
(training/train.py:156-160). One step: both encoders forward (the audio
tower in train mode: batch statistics, spec-augment, PANN's dropout),
the symmetric InfoNCE, backward, AdamW under a LambdaLR multiplier, the
clamp.

The optimizer is the JAX CLI's chain (scripts/clap_pretrain.py:105-110):
``scale_by_adam(b1, b2, eps)``, ``add_decayed_weights(wd)``, the learning
rate times the schedule at the update count. That is ``torch.optim.AdamW``
over every parameter, the logit scales included (the chain decays every
leaf), with the schedule's first update at index 0; a parameter off the
loss's path (HTSAT's classification head) gets a zero grad, as optax
hands it, so it decays too. The audio tower's train-mode draws come from
a CPU generator seeded from (seed, step).

In a process group (``lass_torch.parallel``) the step is the global
batch's, as lass_tpu's data-sharded jit computes it: ``clip_loss`` gathers
both embeddings over the ranks with this rank's rows keeping their graph
(open_clip's gather_features with gather_with_grad=False, loss.py:27-113)
and takes the G x G logits and the mean over the G rows, so every rank
computes the same loss; the towers' grads, each rank's through its own
rows, are summed over the ranks (``sum_gradients``), while the logit
scales' are already whole on every rank. BatchNorm takes global
statistics and the train-mode draws are drawn at the global batch's
shape, each rank keeping its rows (``lass_torch.parallel.host.row_span``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lass_torch.parallel.host import gather_rows, host_info
from lass_torch.parallel.mesh import sum_gradients
from lass_torch.train.checkpoint import TaskCheckpoint

INIT_LOGIT_SCALE = math.log(1 / 0.07)
MAX_LOGIT_SCALE = math.log(100.0)


def clip_loss(audio_embeds: torch.Tensor, text_embeds: torch.Tensor,
              logit_scale_a: torch.Tensor, logit_scale_t: torch.Tensor
              ) -> torch.Tensor:
    """Symmetric InfoNCE with two scales (open_clip/loss.py:229-247); row i
    of each embedding is a true pair. In a process group, over the global
    batch (module docstring)."""
    audio_embeds = global_rows(audio_embeds)
    text_embeds = global_rows(text_embeds)
    labels = torch.arange(audio_embeds.shape[0], device=audio_embeds.device)
    logits_a = logit_scale_a.exp() * audio_embeds @ text_embeds.T
    logits_t = logit_scale_t.exp() * text_embeds @ audio_embeds.T
    return 0.5 * (F.cross_entropy(logits_a, labels)
                  + F.cross_entropy(logits_t, labels))


def global_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch of ``x`` with this rank's rows in autograd's graph
    and the other ranks' as gathered values."""
    rank, world = host_info()
    if world == 1:
        return x
    full = gather_rows(x)
    b = x.shape[0]
    return torch.cat([full[:rank * b], x, full[(rank + 1) * b:]])


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s train-mode draws."""
    return torch.Generator().manual_seed(seed * 1000003 + step)


class CLAPPretrainTask(TaskCheckpoint):
    """Joint audio / text contrastive training of the CLAP encoders.

    ``audio_encoder`` (``CLAPAudioEncoder`` or ``CLAPPANNAudioEncoder``)
    and ``text_encoder`` (``CLAPTextEncoder``) on one device; ``schedule``
    maps the update count (from 0) to the learning-rate multiplier."""

    def __init__(self, audio_encoder: nn.Module, text_encoder: nn.Module,
                 lr: float = 1e-4, betas: Tuple[float, float] = (0.9, 0.99),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 schedule: Optional[Callable[[int], float]] = None,
                 seed: int = 0):
        self.audio_encoder = audio_encoder
        self.text_encoder = text_encoder
        device = next(audio_encoder.parameters()).device
        self.logit_scale_a = nn.Parameter(torch.tensor(
            INIT_LOGIT_SCALE, dtype=torch.float32, device=device))
        self.logit_scale_t = nn.Parameter(torch.tensor(
            INIT_LOGIT_SCALE, dtype=torch.float32, device=device))
        self.optimizer = torch.optim.AdamW(
            self.parameters(), lr=lr, betas=betas, eps=eps,
            weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, schedule or (lambda step: 1.0))
        self.seed = seed
        self.step = 0

    def parameters(self):
        return [*self.audio_encoder.parameters(),
                *self.text_encoder.parameters(),
                self.logit_scale_a, self.logit_scale_t]

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """A CLAP checkpoint's flat keys: ``audio_branch.*``,
        ``audio_projection.*``, ``text_branch.*``, ``text_projection.*``,
        ``logit_scale_a``, ``logit_scale_t`` (BN running statistics
        included)."""
        return {**self.audio_encoder.state_dict(),
                **self.text_encoder.state_dict(),
                "logit_scale_a": self.logit_scale_a.detach(),
                "logit_scale_t": self.logit_scale_t.detach()}

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        audio_keys = set(self.audio_encoder.state_dict())
        self.audio_encoder.load_state_dict(
            {k: v for k, v in sd.items() if k in audio_keys})
        self.text_encoder.load_state_dict(
            {k: v for k, v in sd.items() if k not in audio_keys
             and not k.startswith("logit_scale_")})
        with torch.no_grad():
            self.logit_scale_a.copy_(sd["logit_scale_a"])
            self.logit_scale_t.copy_(sd["logit_scale_t"])

    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """batch: 'waveform' (B, L) at 48 kHz, 'input_ids' and
        'attention_mask' (B, S), on the encoders' device; the audio
        tower's draws from ``step_generator(seed, step)``. Returns the loss
        and both scales (exp, after the clamp) as tensors, unsynchronised."""
        self.audio_encoder.train()
        self.text_encoder.train()
        self.optimizer.zero_grad(set_to_none=True)
        audio = self.audio_encoder(
            batch["waveform"], generator=step_generator(self.seed, self.step))
        text = self.text_encoder(batch["input_ids"], batch["attention_mask"])
        loss = clip_loss(audio, text, self.logit_scale_a, self.logit_scale_t)
        loss.backward()
        for p in self.parameters():
            if p.grad is None:  # off the loss's path (HTSAT's tscam_conv):
                # optax hands it a zero grad, so it decays
                p.grad = torch.zeros_like(p)
        sum_gradients([*self.audio_encoder.parameters(),
                       *self.text_encoder.parameters()])
        self.optimizer.step()
        self.scheduler.step()
        with torch.no_grad():
            self.logit_scale_a.clamp_(max=MAX_LOGIT_SCALE)
            self.logit_scale_t.clamp_(max=MAX_LOGIT_SCALE)
        self.step += 1
        return {"contrastive_loss": loss.detach(),
                "logit_scale_a": self.logit_scale_a.detach().exp(),
                "logit_scale_t": self.logit_scale_t.detach().exp()}

    @torch.no_grad()
    def embed(self, waveform: torch.Tensor, input_ids: torch.Tensor,
              attention_mask: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode normalized (audio, text) embeddings; the encoders go
        back to train mode with the next step."""
        self.audio_encoder.eval()
        self.text_encoder.eval()
        return (self.audio_encoder(waveform),
                self.text_encoder(input_ids, attention_mask))
