"""Batched separation inference (counterpart of ``SeparationInference`` in
lass_tpu/evaluation/dcase.py). The DCASE evaluator, long-audio chunking
and int8 inference are later slices."""
from __future__ import annotations

import numpy as np
import torch


class SeparationInference:
    """Binds a separator and a query encoder on one device."""

    def __init__(self, model: torch.nn.Module, query_encoder,
                 pad_multiple: int = 160, device: str = "cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.query_encoder = query_encoder
        self.pad_multiple = pad_multiple

    def separate(self, mixtures, conditions) -> np.ndarray:
        """(B, C, L) mixtures and (B, 512) conditions (numpy or tensors) ->
        (B, C, L) float32 numpy. L is zero-padded to a multiple of the hop
        for the forward and cropped back after."""
        mixtures = torch.as_tensor(mixtures, dtype=torch.float32)
        length = mixtures.shape[-1]
        padded = -(-length // self.pad_multiple) * self.pad_multiple
        with torch.inference_mode():
            mixtures = mixtures.to(self.device)
            if padded != length:
                mixtures = torch.nn.functional.pad(
                    mixtures, (0, padded - length))
            out = self.model({
                "mixture": mixtures,
                "condition": torch.as_tensor(conditions).to(
                    self.device, torch.float32)})["waveform"]
            return out[..., :length].cpu().numpy()
