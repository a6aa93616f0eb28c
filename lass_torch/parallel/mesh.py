"""The data axis of lass_tpu's mesh (lass_tpu/parallel/mesh.py) over
PyTorch's default process group. There is no model axis: a ResUNet30 fits
one card whole (tensor parallelism waits in ROADMAP.md).

- ``data_parallel``: the separator's step. Each rank's loss is the mean
  over its rows, so the mean of the ranks' grads (DistributedDataParallel's
  all-reduce) is the grad of the global batch's mean loss.
- ``sum_gradients``: the contrastive step. Every rank computes the same
  global loss, each through the graph of its own rows only, so the grads
  of the towers' parameters are summed over the ranks.

BatchNorm's statistics are global by themselves (``lass_torch.nn.layers``),
so DDP's buffer broadcast, which would copy rank 0's running statistics
over the others', is off.
"""
from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from lass_torch.parallel.host import is_distributed


def data_parallel(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` under DistributedDataParallel over the default group, or
    ``module`` itself in a single-process run."""
    if not is_distributed():
        return module
    return DistributedDataParallel(module, broadcast_buffers=False)


def sum_gradients(parameters: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's grad over the ranks, in place, as one
    all-reduce (a no-op in a single-process run). Every rank must pass the
    same parameters, each with a grad."""
    if not is_distributed():
        return
    grads = [p.grad for p in parameters]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
