"""Optimizer and LR schedules (counterpart of lass_tpu/train/optim.py).

The reference's own optimizer: ``torch.optim.AdamW(amsgrad=True)`` with
betas (0.9, 0.999), eps 1e-8 and weight decay 0 (torch's default is 0.01),
its learning rate scaled per update by a ``LambdaLR`` multiplier. The
scheduler steps once after each optimizer step, so the k-th update
(k from 0) runs at ``learning_rate * lam(k)``, as the JAX package's
``scale_by_learning_rate`` applies the schedule at its update count.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch


def linear_warm_up(warm_up_steps: int, reduce_lr_steps: int) -> Callable:
    def schedule(step: int) -> float:
        if step <= warm_up_steps:
            return step / warm_up_steps
        return 0.9 ** math.floor(step / reduce_lr_steps)

    return schedule


def constant_warm_up(warm_up_steps: int, reduce_lr_steps: int) -> Callable:
    del reduce_lr_steps

    def schedule(step: int) -> float:
        if step < warm_up_steps:
            return 1e-3
        if step < 2 * warm_up_steps:
            return 1e-2
        if step < 3 * warm_up_steps:
            return 1e-1
        return 1.0

    return schedule


def cosine_warm_up(warm_up_steps: int, total_steps: int) -> Callable:
    """Linear warm-up, then cosine decay to 0 (the CLAP pretraining
    schedule); returns the multiplier."""

    def schedule(step: int) -> float:
        if step < warm_up_steps:
            return (step + 1) / warm_up_steps
        es = max(total_steps - warm_up_steps, 1)
        return 0.5 * (1 + math.cos(math.pi * (step - warm_up_steps) / es))

    return schedule


def get_lr_schedule(lr_lambda_type: str, warm_up_steps: int,
                    reduce_lr_steps: int) -> Callable:
    if lr_lambda_type == "linear_warm_up":
        return linear_warm_up(warm_up_steps, reduce_lr_steps)
    if lr_lambda_type == "constant_warm_up":
        return constant_warm_up(warm_up_steps, reduce_lr_steps)
    if lr_lambda_type == "cosine_warm_up":
        # reduce_lr_steps doubles as the total step count for the cosine
        return cosine_warm_up(warm_up_steps, reduce_lr_steps)
    raise NotImplementedError(f"lr_lambda_type '{lr_lambda_type}'")


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    optimizer_type: str, learning_rate: float,
                    lr_lambda_type: str, warm_up_steps: int,
                    reduce_lr_steps: int
                    ) -> Tuple[torch.optim.AdamW,
                               torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler); call ``scheduler.step()`` after every
    ``optimizer.step()``."""
    if optimizer_type != "AdamW":
        raise NotImplementedError(f"optimizer '{optimizer_type}'")
    optimizer = torch.optim.AdamW(params, lr=learning_rate,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.0, amsgrad=True)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, get_lr_schedule(lr_lambda_type, warm_up_steps,
                                   reduce_lr_steps))
    return optimizer, scheduler
