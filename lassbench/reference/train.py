"""AudioSep's training step, plain float32: the batch worked out again from
the corpus files, the mixer, the train-mode separator, L1, the backward
and AdamW (amsgrad), with the recipe's learning-rate schedule.

- Rows: epoch e's order is ``np.random.default_rng(seed + e)``'s shuffle of
  the datafile's entries; step k takes the next ``batch`` of them; each
  clip (PCM16, mono) is resampled to the configuration's rate on the host
  when it was written at another, then cropped at a start drawn from
  ``np.random.default_rng((seed, e, index))`` (or zero-padded) to
  ``segment_seconds``.
- Mixer: clip n is mixed with clips n+1 .. n+mix_num-1 of the batch, each
  energy-matched (ratio clamped to [0.02, 50]) at a random integer gain in
  [lower_db, higher_db] dB; the summed noise is matched again at a last
  random gain; mixture and source are rescaled by 0.9 / peak where the
  mixture's peak exceeds 1. Draws: ``torch.randint`` on a generator on the
  device seeded by ``seed + 1``, per step: mix_num (B,) in [2, max], the
  gains (B, max - 1), the last gains (B,).
- Step: the separator in train mode (batch statistics), the mean absolute
  error of the waveform, gradients, then AdamW with betas (0.9, 0.999),
  eps 1e-8, no weight decay, amsgrad, at ``learning_rate * lam(k)`` for
  update k (``constant_warm_up``: 1e-3, 1e-2, 1e-1 over each
  ``warm_up_steps``, then 1).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from lassbench.reference import separator
from lassbench.signals import read_wav_pcm16, resample_np

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def batch_rows(entries: Sequence[Dict], seed: int, step: int, batch: int,
               rate: int, seconds: float) -> Tuple[np.ndarray, List[str]]:
    """Step ``step``'s (0-based) rows: (B, 1, L) float32 and captions."""
    n = len(entries)
    per_epoch = n // batch
    epoch, j = divmod(step, per_epoch)
    order = np.arange(n)
    np.random.default_rng(int(seed) + epoch).shuffle(order)
    length = int(seconds * rate)
    waves, caps = [], []
    for i in order[j * batch:(j + 1) * batch]:
        audio, clip_rate = read_wav_pcm16(entries[i]["wav"])
        if clip_rate != rate:
            audio = resample_np(audio, clip_rate, rate)
        rng = np.random.default_rng((int(seed), epoch, int(i)))
        if len(audio) > length:
            start = int(rng.integers(0, len(audio) - length + 1))
            audio = audio[start:start + length]
        else:
            audio = np.pad(audio, (0, length - len(audio)))
        waves.append(audio.astype(np.float32)[None])
        caps.append(entries[i]["caption"])
    return np.stack(waves), caps


def mixer_draws(gen: torch.Generator, b: int, max_mix: int, lower: int,
                higher: int):
    dev = gen.device
    mix_num = torch.randint(2, max_mix + 1, (b,), generator=gen, device=dev)
    gains = torch.randint(lower, higher + 1, (b, max_mix - 1),
                          generator=gen, device=dev).float()
    final = torch.randint(lower, higher + 1, (b,), generator=gen,
                          device=dev).float()
    return mix_num, gains, final


def mix(x: torch.Tensor, mix_num, gains_db, final_db):
    """(B, 1, L) -> (mixtures, sources)."""
    b = x.shape[0]
    energy = (x * x).mean(dim=(1, 2))
    ref = torch.clamp(energy, min=1e-10)
    noise = torch.zeros_like(x)
    for i in range(1, gains_db.shape[1] + 1):
        ratio = torch.clamp(torch.sqrt(torch.roll(energy, -i) / ref),
                            0.02, 50.0)
        gain = 10.0 ** (gains_db[:, i - 1] / 20.0)
        scale = torch.where(i <= mix_num - 1, gain / ratio,
                            torch.zeros_like(gain))
        noise = noise + torch.roll(x, -i, dims=0) * scale.view(b, 1, 1)
    ratio = torch.clamp(torch.sqrt((noise * noise).mean(dim=(1, 2)) / ref),
                        0.02, 50.0)
    noise = noise * (10.0 ** (final_db / 20.0) / ratio).view(b, 1, 1)
    mixture = x + noise
    peak = mixture.abs().amax(dim=(1, 2))
    rescale = torch.where(peak > 1.0, 0.9 / peak,
                          torch.ones_like(peak)).view(b, 1, 1)
    return mixture * rescale, x * rescale


def lr_lambda(kind: str, warm_up: int, k: int) -> float:
    if kind != "constant_warm_up":
        raise NotImplementedError(kind)
    if k < warm_up:
        return 1e-3
    if k < 2 * warm_up:
        return 1e-2
    if k < 3 * warm_up:
        return 1e-1
    return 1.0


def is_param(key: str) -> bool:
    return not key.endswith(BUFFERS)


def train(sd: Dict[str, torch.Tensor], cfg: Dict,
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          seed: int, device, quant=None) -> Dict:
    """``len(batches)`` steps from weights ``sd`` on (waveforms (B, 1, L),
    conditions (B, 512)) on the device -> {'losses': [...], 'grads1':
    {key: the first step's gradient}, 'delta': {key: the parameters'
    change over all the steps}}."""
    t = cfg["train"]
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in sd.items() if is_param(k)}
    state = {k: v for k, v in sd.items() if not is_param(k)}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    vmax = {k: torch.zeros_like(v) for k, v in params.items()}
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    out = {"losses": [], "grads1": {}}
    for k, (wave, cond) in enumerate(batches):
        draws = mixer_draws(gen, wave.shape[0], t["max_mix_num"],
                            t["lower_db"], t["higher_db"])
        mixture, source = mix(wave.float(), *draws)
        sep = separator.separate({**params, **state}, mixture, cond,
                                 training=True, checkpointed=True,
                                 quant=quant)
        loss = (sep[:, 0] - source[:, 0]).abs().mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        out["losses"].append(float(loss.detach()))
        if k == 0:
            out["grads1"] = {key: g.detach().clone()
                             for key, g in zip(params, grads)}
        lr = t["learning_rate"] * lr_lambda(t["lr_lambda_type"],
                                            t["warm_up_steps"], k)
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** (k + 1), 1 - b2 ** (k + 1)
        with torch.no_grad():
            for (key, p), g in zip(params.items(), grads):
                m[key].mul_(b1).add_(g, alpha=1 - b1)
                v2[key].mul_(b2).addcmul_(g, g, value=1 - b2)
                torch.maximum(vmax[key], v2[key], out=vmax[key])
                denom = vmax[key].sqrt() / (c2 ** 0.5) + ADAM_EPS
                p.addcdiv_(m[key], denom, value=-lr / c1)
    out["delta"] = {k: (p.detach() - sd[k]) for k, p in params.items()}
    return out
