"""Offline STFT precompute (counterpart of lass_tpu/data/precompute.py;
CLI ``python -m lass_torch.precompute_stfts``).

Two phases, as in the reference's scripts/precompute_stfts.py:

1. ``generate_recipes``: walk the dataset in order, batch by batch, and
   record per item which partners mix in (``(j + i) % B`` wrap-around
   within its batch, as ``SegmentMixer`` pairs) with integer dB gains,
   keyed by audio path. The draws are numpy's (``default_rng(seed)``) in
   lass_tpu's order, so both packages write the same recipes.
2. ``compute_stfts``: reload the audio (``default_rng(0)`` for the crops,
   as lass_tpu), mix by the recipes (energy-matched gains and declipping,
   ``lass_torch.data.mixer``'s math with the recipe's gains) and run the
   per-window STFT bank (``process_batch``, on the device), then write
   ``batch_%06d.npz`` files from a background thread behind a bounded
   queue, each to a temporary name renamed into place.

The files' schema, key names and (B, T, F, C) layout are lass_tpu's, so
either package reads what the other wrote.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from lass_torch.dsp.stft import multi_resolution_spectrogram_phase


def generate_recipes(dataset, batch_size: int, max_mix_num: int,
                     lower_db: int, higher_db: int, seed: int = 1234
                     ) -> Dict:
    """-> {"recipes": {path: recipe}, "meta": {...}}; sequential,
    unshuffled traversal like the reference (:250-350), deduped by path."""
    rng = np.random.default_rng(seed)
    recipes: Dict[str, Dict] = {}
    n = len(dataset)
    paths = [dataset.items[i]["wav"] for i in range(n)]
    captions = [dataset.items[i]["caption"] for i in range(n)]

    for start in range(0, n - batch_size + 1, batch_size):
        for j in range(batch_size):
            idx = start + j
            path = paths[idx]
            if path in recipes:
                continue
            mix_num = int(rng.integers(2, max_mix_num + 1))
            partners = []
            for i in range(1, mix_num):
                p_idx = start + (j + i) % batch_size
                partners.append({
                    "wav": paths[p_idx],
                    "caption": captions[p_idx],
                    "gain_db": int(rng.integers(lower_db, higher_db + 1)),
                })
            recipes[path] = {
                "caption": captions[idx],
                "partners": partners,
                "noise_gain_db": int(rng.integers(lower_db, higher_db + 1)),
            }
    return {
        "recipes": recipes,
        "meta": {"batch_size": batch_size, "max_mix_num": max_mix_num,
                 "lower_db": lower_db, "higher_db": higher_db, "seed": seed},
    }


def mix_from_recipe(segment: torch.Tensor, partners: torch.Tensor,
                    partner_gains: torch.Tensor, noise_gain: torch.Tensor,
                    partner_mask: torch.Tensor):
    """Recipe mixing, batched: SegmentMixer's math with the recipe's gains.
    segment (B, L); partners (B, P, L); partner_gains, partner_mask (B, P);
    noise_gain (B,); gains in dB. -> (mixture, segment), each (B, L)."""
    seg_energy = torch.clamp(torch.mean(segment ** 2, dim=-1), min=1e-10)
    p_energy = torch.mean(partners ** 2, dim=-1)  # (B, P)
    ratio = torch.clamp(torch.sqrt(p_energy / seg_energy[:, None]),
                        0.02, 50.0)
    gain = 10.0 ** (partner_gains / 20.0)
    scaled = partners * (partner_mask * gain / ratio)[..., None]
    noise = torch.sum(scaled, dim=1)  # (B, L)

    n_energy = torch.mean(noise ** 2, dim=-1)
    ratio2 = torch.clamp(torch.sqrt(n_energy / seg_energy), 0.02, 50.0)
    noise = noise * (10.0 ** (noise_gain / 20.0) / ratio2)[:, None]

    mixture = segment + noise
    peak = torch.amax(torch.abs(mixture), dim=-1)
    rescale = torch.where(peak > 1.0, 0.9 / peak,
                          torch.ones_like(peak))[:, None]
    return mixture * rescale, segment * rescale


@torch.no_grad()
def process_batch(segment: torch.Tensor, partners: torch.Tensor,
                  partner_gains: torch.Tensor, noise_gain: torch.Tensor,
                  partner_mask: torch.Tensor, win_lengths: Sequence[int],
                  hop_length: int = 160):
    """The device part of one batch: the recipe mix, then the STFT bank of
    the mixture and of the (rescaled) segment. -> (mixture, segment,
    {win: (mag, cos, sin)} of each)."""
    mixture, seg = mix_from_recipe(segment, partners, partner_gains,
                                   noise_gain, partner_mask)
    mix_stfts = multi_resolution_spectrogram_phase(
        mixture[:, None, :], tuple(win_lengths), hop_length)
    seg_stfts = multi_resolution_spectrogram_phase(
        seg[:, None, :], tuple(win_lengths), hop_length)
    return mixture, seg, mix_stfts, seg_stfts


class _AsyncWriter:
    """Bounded-queue background npz writer (reference :125-142)."""

    def __init__(self, maxsize: int = 10):
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.errors: List[Exception] = []
        self.thread.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            path, payload = item
            try:
                np.savez(path + ".tmp.npz", **payload)
                os.replace(path + ".tmp.npz", path)
            except Exception as exc:  # surfaced at close()
                self.errors.append(exc)

    def submit(self, path: str, payload: Dict[str, np.ndarray]):
        self.q.put((path, payload))

    def close(self):
        self.q.put(None)
        self.thread.join()
        if self.errors:
            raise self.errors[0]


def batch_payload(texts: List[str], comp_texts: List[List[str]],
                  seg: torch.Tensor, mix_stfts: Dict, seg_stfts: Dict,
                  win_lengths: Sequence[int], hop_length: int,
                  store_dtype=np.float32) -> Dict[str, np.ndarray]:
    """One file's arrays, copied to the host, in lass_tpu's schema."""
    payload: Dict[str, np.ndarray] = {
        "target_waveform": np.asarray(seg[:, None, :].cpu().numpy(),
                                      store_dtype),
        "text": np.asarray(texts),
        "mixture_component_texts": _ragged_to_array(comp_texts),
        "stft_hop_length": np.asarray(hop_length),
        "stft_win_lengths": np.asarray(list(win_lengths)),
    }
    for name, bank in [("mixture", mix_stfts), ("segment", seg_stfts)]:
        for w in win_lengths:
            for part, a in zip(("mag", "cos", "sin"), bank[int(w)]):
                payload[f"stft_{name}_{w}_{part}"] = np.asarray(
                    a.cpu().numpy(), store_dtype)
    return payload


def compute_stfts(dataset, recipes: Dict, out_dir: str,
                  win_lengths: Sequence[int] = (256, 512, 2048),
                  hop_length: int = 160, batch_size: int = 16,
                  max_batches: Optional[int] = None,
                  store_dtype=np.float32, device: str = "cuda") -> int:
    """Apply recipes + STFT bank on ``device``; write batch_%06d.npz.
    Returns the number of files."""
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    recipe_map = recipes["recipes"]
    max_partners = max(
        (len(r["partners"]) for r in recipe_map.values()), default=1)

    path_to_index = {dataset.items[i]["wav"]: i for i in range(len(dataset))}

    def load_wave(path: str, rng) -> Optional[np.ndarray]:
        idx = path_to_index.get(path)
        if idx is None:
            return None
        item = dataset.__getitem__(idx, rng=rng)
        return None if item is None else item["waveform"][0]

    def upload(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    writer = _AsyncWriter()
    rng = np.random.default_rng(0)
    batch_idx = 0
    entries = list(recipe_map.items())
    skipped = 0
    try:
        for start in range(0, len(entries), batch_size):
            if max_batches is not None and batch_idx >= max_batches:
                break
            chunk = entries[start:start + batch_size]
            seg_list, partner_list, gains, ngains, masks = [], [], [], [], []
            texts, comp_texts = [], []
            for path, recipe in chunk:
                seg = load_wave(path, rng)
                if seg is None:
                    skipped += 1
                    continue
                p_waves = np.zeros((max_partners, seg.shape[-1]), np.float32)
                p_gains = np.zeros(max_partners, np.float32)
                p_mask = np.zeros(max_partners, np.float32)
                names = [recipe["caption"]]
                for k, partner in enumerate(recipe["partners"]):
                    w = load_wave(partner["wav"], rng)
                    if w is None:
                        continue
                    p_waves[k] = w
                    p_gains[k] = partner["gain_db"]
                    p_mask[k] = 1.0
                    names.append(partner["caption"])
                seg_list.append(seg)
                partner_list.append(p_waves)
                gains.append(p_gains)
                ngains.append(recipe["noise_gain_db"])
                masks.append(p_mask)
                texts.append(recipe["caption"])
                comp_texts.append(names)
            if not seg_list:
                continue

            _, seg, mix_stfts, seg_stfts = process_batch(
                upload(np.stack(seg_list)), upload(np.stack(partner_list)),
                upload(np.stack(gains)), upload(ngains),
                upload(np.stack(masks)), win_lengths, hop_length)
            writer.submit(
                os.path.join(out_dir, f"batch_{batch_idx:06d}.npz"),
                batch_payload(texts, comp_texts, seg, mix_stfts, seg_stfts,
                              win_lengths, hop_length, store_dtype))
            batch_idx += 1
    finally:
        writer.close()
    if skipped:
        print(f"precompute: skipped {skipped} unloadable items")
    return batch_idx


def _ragged_to_array(rows: List[List[str]]) -> np.ndarray:
    width = max(len(r) for r in rows)
    out = np.full((len(rows), width), "", dtype=object)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out.astype(str)


def save_recipes(recipes: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(recipes, f, indent=1)


def load_recipes(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)
