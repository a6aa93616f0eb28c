"""Operations a unit of work needs, counted on the plain reference.

``FlopCounterMode`` over the reference's functions on the ``meta``
device, at the cell's shapes: every matrix product and convolution of the
forward (and, for a train step, of the backward: twice the forward's,
as the counter has it), with no recomputation, whatever implements the
program. FFTs, elementwise work and the optimizer are not counted.
Each precision's count is divided by its own peak (``yardstick``).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from lassbench.reference import audio, separator, text


def _meta_state(shapes, requires_grad=False):
    return {k: torch.empty(s, device="meta",
                           dtype=torch.long if k.endswith(
                               "num_batches_tracked") else torch.float32,
                           requires_grad=requires_grad and not k.endswith(
                               "num_batches_tracked"))
            for k, s in shapes}


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def separator_flops(cfg: Dict, batch: int, train: bool = False) -> int:
    """The UNet and FiLM of one batch of ``segment_seconds`` clips: the
    forward, or forward + backward."""
    sd = _meta_state(separator.param_shapes(cfg["condition_size"]),
                     requires_grad=train)
    frames = int(cfg["segment_seconds"] * cfg["sampling_rate"]) \
        // separator.HOP + 1
    t_pad = -(-frames // 32) * 32

    def run():
        cond = torch.empty(batch, cfg["condition_size"], device="meta")
        film = separator.film_betas(sd, cond)
        x = torch.empty(batch, 1, t_pad, separator.BINS - 1, device="meta")
        out = separator.unet(sd, x, film, training=train)
        if train:
            out.sum().backward()

    return _count(run)


def text_flops(cfg: Dict, batch: int) -> int:
    """The text tower's forward over ``batch`` captions of ``pad_to``
    tokens."""
    sd = _meta_state(text.param_shapes(cfg))

    def run():
        ids = torch.zeros(batch, cfg["pad_to"], dtype=torch.long,
                          device="meta")
        text.embed(sd, cfg, ids, ids)

    return _count(run)


def audio_flops(cfg: Dict, batch: int) -> int:
    """HTSAT + projection over ``batch`` 10 s clips (the log-mel's mel
    matrix and the bicubic stretch included, the FFT not)."""
    with torch.device("meta"):
        tower = audio.AudioTower(cfg)
    tower = tower.to("meta")  # the index and mask constants too
    mel = cfg["mel"]
    frames = int(cfg["clip_seconds"] * mel["sample_rate"]) \
        // mel["hop_length"] + 1

    def run():
        spec = torch.empty(batch, frames, mel["n_fft"] // 2 + 1,
                           device="meta")
        fb = torch.empty(mel["n_fft"] // 2 + 1, mel["n_mels"], device="meta")
        m = spec @ fb
        branch = tower.audio_branch
        size = cfg["spec_size"]
        ratio = size // mel["n_mels"]
        m = torch.empty(size * ratio, frames, device="meta") @ m
        x = torch.empty(batch, 1, size, size, device="meta")
        x = branch.patch_embed.proj(x)
        x = branch.patch_embed.norm(x.flatten(2).transpose(1, 2))
        for layer in branch.layers:
            x = layer(x)
        tower.audio_projection(branch.norm(x).mean(1))

    return _count(run)
