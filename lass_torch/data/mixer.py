"""On-device mixture creation (counterpart of lass_tpu/data/mixer.py).

Each clip of the batch is mixed with the next ``mix_num - 1`` clips of the
same batch (partner i of clip n is clip (n + i) % B): every partner is
energy-matched to the clip (ratio clamped to [0.02, 50]) and scaled by a
random integer gain in [lower_db, higher_db] dB; the summed noise is
loudness-normalised once more against the clip with a last random gain;
where the mixture's peak exceeds 1, both mixture and clip are rescaled by
0.9 / peak.

The random draws are split from the arithmetic: ``draw`` takes them from
an explicit ``torch.Generator`` on the batch's device, ``mix`` applies
given draws, so two implementations can be fed the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SegmentMixer:
    max_mix_num: int = 2
    lower_db: int = -10
    higher_db: int = 10

    def draw(self, batch: int, generator: torch.Generator
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mix_num (B,) int64 in [2, max_mix_num], gains_db
        (B, max_mix_num - 1) float32, final_db (B,) float32), the dB draws
        integers in [lower_db, higher_db], on the generator's device."""
        if self.max_mix_num < 2:
            raise ValueError("max_mix_num must be >= 2")
        dev = generator.device
        mix_num = torch.randint(2, self.max_mix_num + 1, (batch,),
                                generator=generator, device=dev)
        gains_db = torch.randint(self.lower_db, self.higher_db + 1,
                                 (batch, self.max_mix_num - 1),
                                 generator=generator, device=dev).float()
        final_db = torch.randint(self.lower_db, self.higher_db + 1, (batch,),
                                 generator=generator, device=dev).float()
        return mix_num, gains_db, final_db

    def mix(self, waveforms: torch.Tensor, mix_num: torch.Tensor,
            gains_db: torch.Tensor, final_db: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """waveforms (B, ..., L) -> (mixtures, segments), float32, same
        shape, from the given draws."""
        x = waveforms.float()
        b = x.shape[0]
        bcast = (b,) + (1,) * (x.dim() - 1)
        dims = tuple(range(1, x.dim()))
        energy = torch.mean(x * x, dim=dims)
        ref_energy = torch.clamp(energy, min=1e-10)
        noise = torch.zeros_like(x)
        for i in range(1, gains_db.shape[1] + 1):
            partner = torch.roll(x, -i, dims=0)
            partner_energy = torch.roll(energy, -i, dims=0)
            ratio = torch.clamp(torch.sqrt(partner_energy / ref_energy),
                                0.02, 50.0)
            gain = 10.0 ** (gains_db[:, i - 1] / 20.0)
            scale = torch.where(i <= mix_num - 1, gain / ratio,
                                torch.zeros_like(gain))
            noise = noise + partner * scale.reshape(bcast)
        noise_energy = torch.mean(noise * noise, dim=dims)
        ratio = torch.clamp(torch.sqrt(noise_energy / ref_energy), 0.02, 50.0)
        gain = 10.0 ** (final_db / 20.0)
        noise = noise * (gain / ratio).reshape(bcast)
        mixture = x + noise
        peak = torch.amax(torch.abs(mixture), dim=dims)
        rescale = torch.where(peak > 1.0, 0.9 / peak,
                              torch.ones_like(peak)).reshape(bcast)
        return mixture * rescale, x * rescale

    def __call__(self, waveforms: torch.Tensor, generator: torch.Generator
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.mix(waveforms, *self.draw(waveforms.shape[0], generator))
