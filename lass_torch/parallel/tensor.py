"""Tensor parallelism over a grid's model axis (lass_tpu shards the same
weights over its mesh's 'model' axis and lets GSPMD place the
collectives; here they are explicit).

``shard_model(model, grid)`` swaps a sharded layer in for every weight of
``lass_torch.parallel.mesh.shard_layout``; each holds its slice of dim 0
of that weight (model rank m the m-th of M equal slices) under the same
parameter name, so the model's names, and from_jax's and the checkpoints'
mapping, are unchanged:

- ``ColumnConv2d`` (a conv's output channels) and ``ColumnFiLM`` (the
  fused FiLM's rows): the input goes in whole (``_CopyToModel``: identity,
  and in the backward pass the sum of the ranks' partial input grads),
  the layer computes its channels and ``_GatherFromModel`` all-gathers
  them along the channel axis; the bias, replicated, is added after.
  The gather's backward pass returns the local slice of the incoming grad:
  what follows the layer is computed alike on every rank of the model
  group, so each already holds the whole grad
  (``torch.distributed.nn.functional.all_gather`` would sum it over the
  ranks instead, scaling the grads by M).
- ``RowConvTranspose2d`` (a transposed conv's input channels, as flax's
  kernel layout puts them last): ``_ScatterToModel`` takes the rank's
  input channels (its backward pass all-gathers the input grad),
  the layer computes a partial output and ``_ReduceFromModel`` sums the
  partials over the model group in float32.

Everything else runs replicated on the ranks of a model group, on the
same rows; BatchNorm normalises over the grid's data group. The
replicated parameters' grads and BatchNorm's running statistics are
averaged over the model group after the data group's reduction
(``average_replicated``), so the parameters and statistics stay bitwise
equal however the card's kernels round in each process. Optimizer moments follow
their parameters' local shapes, so optimizer memory shards too;
``full_state_dict`` / ``full_optimizer_state`` gather the whole model and
moments for a checkpoint (every rank of a model group must call them
together), ``local_state_dict`` / ``local_optimizer_state`` cut a whole
one to this rank's slices. At M = 1 (``make_grid(1)``) every function
here returns at once, or returns its input.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from lass_torch.models.film import FusedFiLM, split_film
from lass_torch.nn.layers import BatchNorm
from lass_torch.parallel.mesh import (
    TP_MIN_CHANNELS, TP_MIN_FILM, Grid, shard_layout)


def gather_full(t: torch.Tensor, dim: int, grid: Grid) -> torch.Tensor:
    """The model group's slices of a tensor, concatenated along ``dim``."""
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(grid.model_size)]
    dist.all_gather(parts, t, group=grid.model)
    return torch.cat(parts, dim)


def local_part(t: torch.Tensor, dim: int, grid: Grid) -> torch.Tensor:
    """This model rank's slice of a whole tensor along ``dim`` (a copy)."""
    if t.shape[dim] % grid.model_size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {grid.model_size} equal slices")
    return t.chunk(grid.model_size, dim)[grid.model_rank].clone()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, grid):
        ctx.dim, ctx.grid = dim, grid
        return gather_full(x, dim, grid)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.grid.model_size, ctx.dim)[ctx.grid.model_rank], \
            None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, grid):
        ctx.dim, ctx.grid = dim, grid
        return x.chunk(grid.model_size, dim)[grid.model_rank]

    @staticmethod
    def backward(ctx, g):
        return gather_full(g, ctx.dim, ctx.grid), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        total = x.to(torch.float32, copy=True)
        dist.all_reduce(total, group=group)
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class ColumnConv2d(nn.Module):
    """``lass_torch.nn.layers.Conv2d`` with its output channels split over
    the model group (the bias replicated)."""

    shard_dim = 0

    def __init__(self, conv: nn.Conv2d, grid: Grid):
        super().__init__()
        self.grid = grid
        self.stride, self.padding = conv.stride, conv.padding
        self.weight = nn.Parameter(local_part(conv.weight.data, 0, grid))
        self.bias = conv.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.grid.model)
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                     self.padding)
        y = _GatherFromModel.apply(y, 1, self.grid)
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype)[:, None, None]


class RowConvTranspose2d(nn.Module):
    """``lass_torch.nn.layers.ConvTranspose2d`` (no bias) with its input
    channels split over the model group."""

    shard_dim = 0

    def __init__(self, conv: nn.ConvTranspose2d, grid: Grid):
        super().__init__()
        self.grid = grid
        self.stride = conv.stride
        self.weight = nn.Parameter(local_part(conv.weight.data, 0, grid))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _ScatterToModel.apply(x, 1, self.grid)
        y = F.conv_transpose2d(x, self.weight.to(x.dtype), None,
                               self.stride)
        return _ReduceFromModel.apply(y, self.grid.model)


class ColumnFiLM(nn.Module):
    """``FusedFiLM`` with its weight's rows split over the model group (the
    bias replicated); the same nested beta dict."""

    shard_dim = 0

    def __init__(self, film: FusedFiLM, grid: Grid):
        super().__init__()
        self.grid, self.spec = grid, film.spec
        self.weight = nn.Parameter(local_part(film.weight.data, 0, grid))
        self.bias = film.bias

    def forward(self, condition: torch.Tensor) -> Dict[str, Any]:
        x = _CopyToModel.apply(condition.float(), self.grid.model)
        flat = _GatherFromModel.apply(F.linear(x, self.weight), 1, self.grid)
        return split_film(flat + self.bias, self.spec)


_SHARDED = {FusedFiLM: ColumnFiLM, nn.ConvTranspose2d: RowConvTranspose2d,
            nn.Conv2d: ColumnConv2d}


def _sharded_type(module: nn.Module):
    for kind, sharded in _SHARDED.items():
        if isinstance(module, kind):
            return sharded
    return None


def shard_model(model: nn.Module, grid: Grid,
                min_channels: int = TP_MIN_CHANNELS,
                min_film: int = TP_MIN_FILM) -> nn.Module:
    """Swap the sharded layers into ``model`` (in place; the model's whole
    weights must be the same on every rank) and put its BatchNorms on the
    grid's data group; returns the model. Build the optimizer after."""
    if grid.model_size == 1:
        return model
    if any(getattr(m, "quantize", False) for m in model.modules()):
        raise NotImplementedError("int8 (quantize) with tensor parallelism")
    layout = shard_layout(model, min_channels, min_film)
    for name in layout:
        path, _, leaf = name.rpartition(".")
        parent_name, _, child = path.rpartition(".")
        parent = model.get_submodule(parent_name)
        module = getattr(parent, child)
        sharded = _sharded_type(module)
        if sharded is None or leaf != "weight":
            raise NotImplementedError(
                f"{name}: no tensor-parallel form of "
                f"{type(module).__name__}")
        setattr(parent, child, sharded(module, grid))
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = grid.data
    return model


def sharded_dims(model: nn.Module) -> Dict[str, int]:
    """{parameter name: sharded dim} of a model after ``shard_model``."""
    return {f"{name}.weight": m.shard_dim for name, m in model.named_modules()
            if isinstance(m, tuple(_SHARDED.values()))}


def full_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor],
                    grid: Grid) -> Dict[str, torch.Tensor]:
    """``sd`` (the sharded model's state dict) with every slice gathered."""
    if grid.model_size == 1:
        return sd
    dims = sharded_dims(model)
    return {k: gather_full(v, dims[k], grid) if k in dims else v
            for k, v in sd.items()}


def local_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor],
                     grid: Grid) -> Dict[str, torch.Tensor]:
    """A whole state dict cut to this rank's slices."""
    if grid.model_size == 1:
        return sd
    dims = sharded_dims(model)
    return {k: local_part(v, dims[k], grid) if k in dims else v
            for k, v in sd.items()}


def _moment_dims(model: nn.Module, state: Dict[str, Any]) -> Dict[int, int]:
    """{optimizer parameter index: sharded dim}; the optimizer must hold
    the model's parameters in ``named_parameters`` order."""
    names = [n for n, _ in model.named_parameters()]
    indices = [i for g in state["param_groups"] for i in g["params"]]
    if len(indices) != len(names):
        raise ValueError("the optimizer does not hold exactly the model's "
                         "parameters")
    dims = sharded_dims(model)
    return {i: dims[n] for i, n in zip(indices, names) if n in dims}


def _map_moments(model, state, fn):
    dims = _moment_dims(model, state)
    out = dict(state)
    out["state"] = {
        i: {k: fn(v, dims[i]) if i in dims and torch.is_tensor(v)
            and v.dim() > 0 else v for k, v in s.items()}
        for i, s in state["state"].items()}
    return out


def full_optimizer_state(model: nn.Module, state: Dict[str, Any],
                         grid: Grid) -> Dict[str, Any]:
    """An optimizer state dict with the sharded parameters' moments
    gathered."""
    if grid.model_size == 1:
        return state
    return _map_moments(model, state,
                        lambda v, dim: gather_full(v, dim, grid))


def local_optimizer_state(model: nn.Module, state: Dict[str, Any],
                          grid: Grid) -> Dict[str, Any]:
    """A whole optimizer state dict cut to this rank's slices."""
    if grid.model_size == 1:
        return state
    return _map_moments(model, state,
                        lambda v, dim: local_part(v, dim, grid))


def average_replicated(model: nn.Module, grid: Grid) -> None:
    """Average the replicated parameters' grads and the BatchNorms' running
    statistics (which every rank of the model group updates in its own
    forward pass) over the model group, in place, as one all-reduce."""
    if grid.model_size == 1:
        return
    dims = sharded_dims(model)
    tensors = [p.grad for n, p in model.named_parameters()
               if n not in dims and p.grad is not None]
    tensors += [t for m in model.modules() if isinstance(m, BatchNorm)
                for t in (m.running_mean, m.running_var)]
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=grid.model)
    flat /= grid.model_size
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def grad_norm(model: nn.Module, grid: Grid) -> torch.Tensor:
    """The global grad norm: each replicated parameter counted once, the
    sharded slices' squares summed over the model group."""
    dims = sharded_dims(model)
    squares = {True: [], False: []}
    for n, p in model.named_parameters():
        if p.grad is not None:
            squares[n in dims].append(p.grad.float().square().sum())
    zero = torch.zeros((), device=next(model.parameters()).device)
    sharded = torch.stack(squares[True]).sum() if squares[True] else zero
    if grid.model_size > 1:
        dist.all_reduce(sharded, group=grid.model)
    replicated = (torch.stack(squares[False]).sum() if squares[False]
                  else zero)
    return torch.sqrt(replicated + sharded)
