"""Chunked long-audio separation (counterpart of lass_tpu/models/chunk.py).

A long mixture is split into overlapping NL + NC + NR windows (defaults
1 s + 3 s + 1 s at RATE = 32000: the reference hardcodes 32 kHz here even
for the 16 kHz model, so a window is 160 000 samples, 10 s at 16 kHz;
reference resunet.py:655-714). Every window is separated with the same
condition, and the central NC regions are stitched (the first window also
keeps its left edge, the last its right tail).

``chunk_inference`` copies each group of windows to the host and stitches
there in NumPy: it is the oracle. ``chunk_inference_device`` keeps the
windows, the group forwards and the stitch on the mixture's device with no
host round-trip between groups; every group is zero-padded to
``max_batch`` windows, so all forwards run at one shape.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ChunkConfig:
    NL: float = 1.0
    NC: float = 3.0
    NR: float = 1.0
    RATE: int = 32000  # reference default (resunet.py:657-662)

    def samples(self):
        """(nl, nc, nr, window) in samples."""
        nl, nc, nr = (int(s * self.RATE) for s in (self.NL, self.NC, self.NR))
        return nl, nc, nr, nl + nc + nr


def _windows(mixture: torch.Tensor, nc: int, window: int) -> torch.Tensor:
    """(1, 1, L) with L > window -> (n_chunks, window) windows at hop nc
    over the mixture zero-padded to (n_chunks - 1) * nc + window."""
    length = mixture.shape[-1]
    n_chunks = int(np.ceil((length - window) / nc)) + 1
    padded_len = (n_chunks - 1) * nc + window
    xp = F.pad(mixture, (0, padded_len - length))[0, 0]
    return xp.unfold(0, window, nc)


def chunk_inference(apply_fn, mixture: torch.Tensor, condition: torch.Tensor,
                    cfg: ChunkConfig = ChunkConfig(),
                    max_batch: int = 16) -> np.ndarray:
    """apply_fn: ({'mixture': (B, 1, W), 'condition': (B, 512)}) ->
    (B, 1, W) tensor. mixture: (1, 1, L); condition: (1, 512). Returns
    numpy (1, L)."""
    nl, nc, nr, window = cfg.samples()
    length = mixture.shape[-1]
    if length <= window:
        out = apply_fn({"mixture": mixture, "condition": condition})
        return out.cpu().numpy()[:, 0, :length]

    chunks = _windows(mixture, nc, window)
    n_chunks = chunks.shape[0]
    outs = []
    for i in range(0, n_chunks, max_batch):
        part = chunks[i:i + max_batch, None, :]
        cond = condition.expand(part.shape[0], condition.shape[-1])
        outs.append(apply_fn({"mixture": part, "condition": cond}
                             ).cpu().numpy())
    sep = np.concatenate(outs, axis=0)[:, 0]  # (n_chunks, window)

    out = np.zeros((n_chunks - 1) * nc + window, np.float32)
    for i in range(n_chunks):
        s = i * nc
        lo = 0 if i == 0 else nl
        hi = window if i == n_chunks - 1 else window - nr
        out[s + lo:s + hi] = sep[i, lo:hi]
    return out[None, :length]


def chunk_inference_device(apply_fn, mixture: torch.Tensor,
                           condition: torch.Tensor,
                           cfg: ChunkConfig = ChunkConfig(),
                           max_batch: int = 16) -> torch.Tensor:
    """``chunk_inference`` on the mixture's device; returns (1, L) there.

    The stitch is a reshape: consecutive windows' kept regions
    [nl, window - nr), plus the first window's left edge and the last
    window's right tail, tile [0, padded_len) exactly, because the hop
    equals window - nl - nr."""
    nl, nc, nr, window = cfg.samples()
    length = mixture.shape[-1]
    if length <= window:
        out = apply_fn({"mixture": mixture, "condition": condition})
        return out[:, 0, :length]

    chunks = _windows(mixture, nc, window)
    n_chunks = chunks.shape[0]
    groups = -(-n_chunks // max_batch)
    chunks = F.pad(chunks, (0, 0, 0, groups * max_batch - n_chunks))
    cond = condition.expand(max_batch, condition.shape[-1])
    sep = torch.empty_like(chunks)
    for g in range(groups):
        rows = slice(g * max_batch, (g + 1) * max_batch)
        sep[rows] = apply_fn({"mixture": chunks[rows, None, :],
                              "condition": cond})[:, 0]
    sep = sep[:n_chunks]
    out = torch.cat([sep[0, :nl], sep[:, nl:window - nr].reshape(-1),
                     sep[-1, window - nr:]])
    return out[None, :length]
