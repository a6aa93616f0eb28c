"""Loss registry (counterpart of lass_tpu/losses.py): L1 in float32."""
from __future__ import annotations

from typing import Callable, Dict

import torch


def l1(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(output.float() - target.float()))


def l1_wav(output_dict: Dict, target_dict: Dict) -> torch.Tensor:
    return l1(output_dict["segment"], target_dict["segment"])


_LOSSES: Dict[str, Callable] = {"l1_wav": l1_wav}


def get_loss_function(loss_type: str) -> Callable:
    if loss_type not in _LOSSES:
        raise NotImplementedError(f"loss '{loss_type}' not registered")
    return _LOSSES[loss_type]
