"""AudioSep training task (counterpart of lass_tpu/tasks/audiosep.py).

One step: mix the batch on its device, condition on the (frozen, hence
detached) caption embedding, run the separator in train mode (BatchNorm
normalises with the batch's statistics and updates its running ones, torch
semantics, momentum 0.01), L1 on the waveform, backward, AMSGrad step and
LR-schedule step. The state is the task's model, optimizer, scheduler and
step counter.

In a process group (``lass_torch.parallel``) the batch is each rank's
rows of the global batch and the step is the global batch's: the model
runs under DistributedDataParallel (``model`` stays the bare module, for
checkpoints and evaluation), BatchNorm takes global statistics, ``mix``
gathers the ranks' waveforms in rank order, mixes the global batch with
global-size draws from the generator (the same seed and state on every
rank) and keeps this rank's rows, and the loss it returns is the global
mean.

Two step flavours, as in the JAX package:
- ``train_step(batch, generator)``: batch = {'waveform', 'condition'}; the
  mixer draws from ``generator`` (text-only conditioning);
- ``train_step_premixed(batch)``: batch = {'mixture', 'segment',
  'condition'} (hybrid conditioning, precomputed pipelines, tests).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from lass_torch.data.mixer import SegmentMixer
from lass_torch.losses import get_loss_function
from lass_torch.parallel.host import all_reduce_mean, gather_rows, local_rows
from lass_torch.parallel.mesh import data_parallel
from lass_torch.train.checkpoint import SeparatorCheckpoint


def _decode_wire(waveform: torch.Tensor) -> torch.Tensor:
    """int16 wire batches (PCM samples scaled by 32768) -> float32, exact;
    float batches pass through."""
    if waveform.dtype == torch.int16:
        return waveform.float() * (1.0 / 32768.0)
    return waveform


class AudioSepTask(SeparatorCheckpoint):
    def __init__(self, model: torch.nn.Module, mixer: SegmentMixer,
                 optimizer: torch.optim.Optimizer,
                 scheduler: torch.optim.lr_scheduler.LRScheduler,
                 loss_fn: Optional[Callable] = None):
        """model: {'mixture', 'condition'} -> {'waveform'}; optimizer and
        scheduler from ``lass_torch.train.optim.build_optimizer`` over the
        model's parameters."""
        self.model = model
        self.train_model = data_parallel(model)
        self.mixer = mixer
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.loss_fn = loss_fn or get_loss_function("l1_wav")
        self.step = 0

    def _update(self, mixtures: torch.Tensor, segments: torch.Tensor,
                condition: torch.Tensor) -> Dict[str, torch.Tensor]:
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        out = self.train_model({"mixture": mixtures,
                                "condition": condition.detach()})
        loss = self.loss_fn({"segment": out["waveform"][:, 0]},
                            {"segment": segments[:, 0]})
        loss.backward()
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return {"train_loss": all_reduce_mean(loss.detach()),
                "grad_norm": grad_norm.detach()}

    def train_step(self, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """batch: {'waveform': (B, 1, L) float32 or int16 wire,
        'condition': (B, 512)}. Returns {'train_loss', 'grad_norm'} as
        0-d tensors on the model's device (read them when logging)."""
        mixtures, segments = self.mix(batch["waveform"], generator)
        return self._update(mixtures, segments, batch["condition"])

    def train_step_premixed(self, batch: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
        """batch: {'mixture', 'segment': (B, 1, L), 'condition': (B, 512)}."""
        return self._update(batch["mixture"], batch["segment"],
                            batch["condition"])

    def mix(self, waveforms: torch.Tensor, generator: torch.Generator
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's rows of the global batch's (mixtures, segments)."""
        mixtures, segments = self.mixer(
            gather_rows(_decode_wire(waveforms)), generator)
        return local_rows(mixtures), local_rows(segments)

    @torch.no_grad()
    def eval_forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Inference forward with the running BatchNorm statistics:
        (B, C, L) -> (B, C, L)."""
        self.model.eval()
        return self.model(batch)["waveform"]
