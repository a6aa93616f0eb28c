"""lass_tpu's (data x model) mesh (lass_tpu/parallel/mesh.py) over
PyTorch's default process group.

- ``data_parallel``: the separator's step. Each rank's loss is the mean
  over its rows, so the mean of the ranks' grads (DistributedDataParallel's
  all-reduce, over the data group under a grid) is the grad of the global
  batch's mean loss.
- ``sum_gradients``: the contrastive step. Every rank computes the same
  global loss, each through the graph of its own rows only, so the grads
  of the towers' parameters are summed over the ranks.
- ``make_grid``: the model axis. W ranks form a D x M grid, rank r at data
  rank ``r // M`` and model rank ``r % M`` (JAX's ``reshape(n // mp,
  mp)``); the ranks of one model group (one data rank) hold the same rows
  and each one slice of the wide layers, the ranks of one data group (one
  model rank) hold different rows. ``shard_layout`` is ``_spec_for``'s
  rule in the port's layouts; ``lass_torch.parallel.tensor`` holds the
  sharded layers.

BatchNorm's statistics are global by themselves (``lass_torch.nn.layers``),
so DDP's buffer broadcast, which would copy rank 0's running statistics
over the others', is off.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from lass_torch.parallel.host import group_info, is_distributed

# lass_tpu's thresholds: conv kernels whose last axis (a conv's outputs, a
# transposed conv's inputs) is 256 or more, the fused FiLM's 1024 or more
# columns
TP_MIN_CHANNELS = 256
TP_MIN_FILM = 1024


def data_parallel(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """``module`` under DistributedDataParallel over ``group`` (None: the
    default group), or ``module`` itself where the group is one rank."""
    if group_info(group)[1] == 1:
        return module
    return DistributedDataParallel(module, broadcast_buffers=False,
                                   process_group=group)


def sum_gradients(parameters: Iterable[torch.nn.Parameter],
                  group=None) -> None:
    """Sum every parameter's grad over the ranks of ``group`` (None: every
    rank), in place, as one all-reduce (a no-op in a single-process run).
    Every rank must pass the same parameters, each with a grad."""
    if not is_distributed():
        return
    grads = [p.grad for p in parameters]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@dataclass
class Grid:
    """This rank's place in a D x M grid: ``data`` is its data group (the
    ranks of its model rank, one a data rank), ``model`` its model group
    (the ranks of its data rank). At M = 1 (``make_grid(1)``: no model
    axis) ``data`` is None, the default group, and ``model`` is None too:
    what runs over the model group returns at once there."""
    data: object
    model: object
    data_rank: int
    data_size: int
    model_rank: int
    model_size: int


def make_grid(model_parallel: int) -> Grid:
    """Split the default group into D = W / M data ranks x M model ranks
    (every rank must call this, in the same order as its other group
    creations; M = 1 creates no group). Raises where W is not a multiple
    of M, as ``make_mesh`` does (a single process counts as W = 1)."""
    rank, world = group_info()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} devices not divisible by model_parallel="
                         f"{model_parallel}")
    if model_parallel == 1:
        return Grid(None, None, rank, world, 0, 1)
    m = model_parallel
    d = world // m
    data, _ = dist.new_subgroups_by_enumeration(
        [[i * m + j for i in range(d)] for j in range(m)])
    model, _ = dist.new_subgroups_by_enumeration(
        [[i * m + j for j in range(m)] for i in range(d)])
    data_rank, data_size = group_info(data)
    model_rank, model_size = group_info(model)
    return Grid(data, model, data_rank, data_size, model_rank, model_size)


def shard_layout(model: torch.nn.Module,
                 min_channels: int = TP_MIN_CHANNELS,
                 min_film: int = TP_MIN_FILM) -> Dict[str, int]:
    """{parameter name: the dim sharded over the model axis}, lass_tpu's
    ``_spec_for`` in the port's layouts: the fused FiLM weight's rows (the
    JAX kernel's columns) where there are ``min_film`` or more, and every
    4-D conv weight's dim 0 where it is ``min_channels`` or more. Dim 0 is
    the JAX kernel's last axis: a conv's output channels, but a transposed
    conv's input channels (flax's ``transpose_kernel`` layout is (kh, kw,
    out, in)). Everything else is replicated."""
    layout = {}
    for name, p in model.named_parameters():
        if p.dim() == 2 and "film" in name and p.shape[0] >= min_film:
            layout[name] = 0
        elif p.dim() == 4 and p.shape[0] >= min_channels:
            layout[name] = 0
    return layout
