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

The task holds a (data x model) grid (``grid=``, the one the model was
sharded over by ``lass_torch.parallel.tensor.shard_model``; by default
``make_grid(1)``, which has no model axis and whose data group is every
rank). The batch of every step, and of ``mix``'s output, is this rank's
data rank's rows (the ranks of a model group hold the same rows;
``gather_model_rows`` assembles them from the ranks' own and
``own_rows`` takes a rank's own back out): what spans the batch (DDP,
BatchNorm, the mix, the loss's mean) spans the data group, the replicated
parameters' grads and BatchNorm's running statistics are averaged over
the model group, and ``grad_norm`` is the norm of the whole grad. The
checkpoint state is the whole model's and the whole moments' (gathered
over the model group; restoring cuts this rank's slices).

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
from lass_torch.parallel import tensor
from lass_torch.parallel.host import all_reduce_mean, gather_rows, local_rows
from lass_torch.parallel.mesh import Grid, data_parallel, make_grid
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
                 loss_fn: Optional[Callable] = None,
                 grid: Optional[Grid] = None):
        """model: {'mixture', 'condition'} -> {'waveform'}; optimizer and
        scheduler from ``lass_torch.train.optim.build_optimizer`` over the
        model's parameters. ``grid``: the grid ``model`` was sharded over
        (``shard_model``); None: ``make_grid(1)``."""
        self.model = model
        self.grid = grid if grid is not None else make_grid(1)
        self.train_model = data_parallel(model, self.grid.data)
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
        tensor.average_replicated(self.model, self.grid)
        grad_norm = tensor.grad_norm(self.model, self.grid)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return {"train_loss": all_reduce_mean(loss.detach(),
                                              self.grid.data),
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
            gather_rows(_decode_wire(waveforms), self.grid.data),
            generator)
        return (local_rows(mixtures, self.grid.data),
                local_rows(segments, self.grid.data))

    def gather_model_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """This rank's own rows (b, ...) -> its data rank's (M * b, ...):
        the model group's rows in rank order (int16 wire batches decoded
        first); ``rows`` itself at M = 1."""
        if self.grid.model_size == 1:
            return rows
        return gather_rows(_decode_wire(rows), self.grid.model)

    def own_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """The inverse of ``gather_model_rows``: the data rank's rows
        (M * b, ...) -> this rank's own (b, ...)."""
        if self.grid.model_size == 1:
            return rows
        return local_rows(rows, self.grid.model)

    @torch.no_grad()
    def eval_forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Inference forward with the running BatchNorm statistics:
        (B, C, L) -> (B, C, L)."""
        self.model.eval()
        return self.model(batch)["waveform"]
