"""DCASE 2024 Task 9 evaluation and batched separation inference
(counterpart of lass_tpu/evaluation/dcase.py).

- ``load_mono`` and ``make_snr_mixture``: 16 kHz mono loading and the
  SNR-scaled mixture with the reference's declip at 0.9 applied to both
  the source and the mixture (reference dcase_evaluator.py:76-89).
- ``DCASEEvaluator``: CSV rows (source, noise, snr, caption) -> mean
  SI-SDR, SDRi and SDR over the set. Rows go through the separator in
  batches of one shape, (batch_size, 1, fixed_len): the ragged final batch
  and its captions are padded to batch_size, and ``fixed_len`` only grows
  (hop-rounded) when a longer clip arrives, so cuDNN's algorithm choices
  for the shape stay cached. ``calibrate`` is the int8 protocol: the
  scales over the first batches, then one pack. With ``data_parallel``
  in a process group (``lass_torch.parallel``), rank r separates batches
  r, r + W, ... (each the batch one card would form, so its clips
  separate exactly as there), the per-clip metrics are summed over the
  ranks into the set's table in CSV order, and every rank returns the
  one-card means.
- ``SeparationInference``: a separator and a caption encoder on one
  device; ``separate`` (one batch), ``separate_long`` (chunked, on the
  device: ``lass_torch/models/chunk.py``), and ``calibrate`` / ``pack`` for
  a model built with ``quantize=True`` (``lass_torch/ops/quant.py``).
"""
from __future__ import annotations

import csv
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lass_torch.audio.io import read_audio
from lass_torch.audio.resample import resample_np
from lass_torch.evaluation.metrics import calculate_sdr, calculate_sisdr
from lass_torch.models.chunk import ChunkConfig, chunk_inference_device
from lass_torch.ops import quant
from lass_torch.parallel.host import host_info, sum_over_ranks


def load_mono(path: str, sampling_rate: int) -> np.ndarray:
    audio, rate = read_audio(path)
    mono = audio.mean(axis=0) if audio.shape[0] > 1 else audio[0]
    if rate != sampling_rate:
        mono = resample_np(mono, rate, sampling_rate)
    return mono.astype(np.float32)


def make_snr_mixture(source: np.ndarray, noise: np.ndarray, snr_db: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """SNR-scaled mixture + declip; returns the (possibly rescaled) source
    and the mixture (reference dcase_evaluator.py:76-89)."""
    n = min(len(source), len(noise))
    source, noise = source[:n].copy(), noise[:n].copy()
    source_power = np.mean(source ** 2)
    noise_power = np.mean(noise ** 2)
    desired = source_power / (10 ** (snr_db / 10))
    noise = noise * np.sqrt(desired / max(noise_power, 1e-20))
    mixture = source + noise
    peak = np.max(np.abs(mixture))
    if peak > 1:
        source *= 0.9 / peak
        mixture *= 0.9 / peak
    return source, mixture


class DCASEEvaluator:
    def __init__(self, sampling_rate: int = 16000,
                 eval_indexes: str = "lass_synthetic_validation.csv",
                 audio_dir: str = "lass_validation",
                 batch_size: int = 16,
                 pad_seconds: float = 10.0,
                 data_parallel: bool = False):
        self.sampling_rate = sampling_rate
        self.data_parallel = data_parallel
        with open(eval_indexes) as f:
            self.eval_list = list(csv.reader(f))[1:]
        self.audio_dir = audio_dir
        self.batch_size = batch_size
        self._fixed_len = int(round(sampling_rate * pad_seconds))
        # seconds of the last __call__: host loading and mixing, caption
        # embedding + separation (ends in a copy to the host), metrics
        self.timing: Dict[str, float] = {}

    def _load_rows(self, rows):
        """-> (sources, mixtures, captions) of the rows."""
        sources, mixtures, captions = [], [], []
        for source_name, noise_name, snr, caption in rows:
            src = load_mono(os.path.join(self.audio_dir, f"{source_name}.wav"),
                            self.sampling_rate)
            noi = load_mono(os.path.join(self.audio_dir, f"{noise_name}.wav"),
                            self.sampling_rate)
            src, mix = make_snr_mixture(src, noi, int(snr))
            sources.append(src)
            mixtures.append(mix)
            captions.append(caption)
        return sources, mixtures, captions

    def _batch(self, mixtures, captions):
        """The mixtures zero-padded into (batch_size, 1, fixed_len) and the
        captions padded to batch_size with the first one."""
        batch = np.zeros((self.batch_size, 1, self._fixed_len), np.float32)
        for i, m in enumerate(mixtures):
            batch[i, 0, :min(len(m), self._fixed_len)] = m[:self._fixed_len]
        return batch, captions + [captions[0]] * (self.batch_size
                                                  - len(captions))

    def calibrate(self, pl_model, num_batches: int = 4) -> None:
        """Int8 calibration over the first ``num_batches`` eval batches
        (a model built with quantize=True), then one pack on the last of
        them (``SeparationInference.pack``). Several batches matter: the
        per-channel ranges are FiLM-conditioned and swing across queries,
        and the amax accumulates over calls. Not with ``data_parallel``
        (nor in lass_tpu)."""
        if self.data_parallel:
            raise NotImplementedError(
                "int8 calibration with data_parallel evaluation")
        last = None
        for start in range(0, min(len(self.eval_list),
                                  num_batches * self.batch_size),
                           self.batch_size):
            _, mixtures, captions = self._load_rows(
                self.eval_list[start:start + self.batch_size])
            batch, captions = self._batch(mixtures, captions)
            conditions = pl_model.query_encoder.get_query_embed(
                modality="text", text=captions)
            pl_model.calibrate(batch, conditions)
            last = (batch, conditions)
        pl_model.pack(*last)

    def __call__(self, pl_model) -> Tuple[float, float, float]:
        """pl_model: an object with .query_encoder.get_query_embed and
        .separate(mixtures (B, 1, L), conditions) -> (B, 1, L) numpy (see
        SeparationInference). Returns (mean SI-SDR, mean SDRi, mean SDR),
        the reference's order."""
        rank, world = host_info() if self.data_parallel else (0, 1)
        # per-clip (SI-SDR, SDRi, SDR), this rank's rows filled in
        table = np.zeros((len(self.eval_list), 3))
        timing = dict.fromkeys(("load_s", "separate_s", "metrics_s"), 0.0)

        starts = range(0, len(self.eval_list), self.batch_size)
        for start in starts[rank::world]:
            t0 = time.perf_counter()
            sources, mixtures, captions = self._load_rows(
                self.eval_list[start:start + self.batch_size])
            lengths = [len(m) for m in mixtures]
            max_len = max(lengths)
            if max_len > self._fixed_len:
                self._fixed_len = -(-max_len // 160) * 160
            batch, captions = self._batch(mixtures, captions)
            t1 = time.perf_counter()
            conditions = pl_model.query_encoder.get_query_embed(
                modality="text", text=captions)
            separated = np.asarray(pl_model.separate(batch, conditions))
            t2 = time.perf_counter()
            for i, (src, mix) in enumerate(zip(sources, mixtures)):
                est = separated[i, 0, :lengths[i]]
                sdr_no_sep = calculate_sdr(ref=src, est=mix)
                sdr = calculate_sdr(ref=src, est=est)
                table[start + i] = (calculate_sisdr(ref=src, est=est),
                                    sdr - sdr_no_sep, sdr)
            timing["load_s"] += t1 - t0
            timing["separate_s"] += t2 - t1
            timing["metrics_s"] += time.perf_counter() - t2

        if world > 1:
            table = sum_over_ranks(table)
        self.timing = timing
        # each column's mean as one contiguous row: numpy's pairwise sum,
        # as over a list of the clips' values
        sisdr, sdri, sdr = table.T.copy().mean(axis=1)
        return float(sisdr), float(sdri), float(sdr)


class SeparationInference:
    """Binds a separator and a query encoder on one device."""

    def __init__(self, model: torch.nn.Module, query_encoder,
                 pad_multiple: int = 160, device: str = "cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.query_encoder = query_encoder
        self.pad_multiple = pad_multiple

    def _forward(self, mixtures, conditions) -> torch.Tensor:
        """(B, C, L) and (B, 512), numpy or tensors -> (B, C, L) float32 on
        the device. L is zero-padded to a multiple of the hop for the
        forward and cropped back after."""
        mixtures = torch.as_tensor(mixtures, dtype=torch.float32)
        length = mixtures.shape[-1]
        padded = -(-length // self.pad_multiple) * self.pad_multiple
        with torch.inference_mode():
            mixtures = F.pad(mixtures.to(self.device), (0, padded - length))
            out = self.model({
                "mixture": mixtures,
                "condition": torch.as_tensor(conditions).to(
                    self.device, torch.float32)})["waveform"]
            return out[..., :length]

    def separate(self, mixtures, conditions) -> np.ndarray:
        """(B, C, L) mixtures and (B, 512) conditions (numpy or tensors) ->
        (B, C, L) float32 numpy."""
        return self._forward(mixtures, conditions).cpu().numpy()

    def separate_long(self, mixture, condition, chunk_cfg=None,
                      max_batch: int = 16) -> np.ndarray:
        """A (1, 1, L) mixture of any length and its (1, 512) condition ->
        (1, L) numpy: overlapping windows in groups of ``max_batch`` on the
        device, stitched there (``chunk_inference_device``; reference
        ResUNet30.chunk_inference, resunet.py:655-714)."""
        mixture = torch.as_tensor(mixture, dtype=torch.float32).to(
            self.device)
        condition = torch.as_tensor(condition).to(self.device, torch.float32)
        with torch.inference_mode():
            out = chunk_inference_device(
                lambda d: self.model(d)["waveform"], mixture, condition,
                chunk_cfg or ChunkConfig(), max_batch)
            return out.cpu().numpy()

    def _quant_layers(self):
        layers = quant.quant_layers(self.model)
        if not layers:
            raise ValueError(
                "the model records no int8 scales: build it with "
                "quantize=True (load_ss_model(..., quantize=True))")
        return layers

    def calibrate(self, mixtures, conditions) -> None:
        """Int8 calibration (a model built with quantize=True): the float
        forward of one batch, recording each quantized conv's input amax.
        Call it with several representative batches: the amax accumulates.
        It drops any pack, which the new scales make stale; until ``pack``
        runs, the int8 forward quantizes its weights in the forward."""
        self._quant_layers()
        quant.set_mode(self.model, "calibrate")
        try:
            self._forward(mixtures, conditions)
        finally:
            quant.set_mode(self.model, "int8")

    def pack(self, mixtures, conditions, bias_correction: bool = True
             ) -> None:
        """After calibration: quantize every int8 conv's weight once and,
        with ``bias_correction``, record its per-channel bias correction
        over this batch (``lass_torch/ops/quant.py``). Later forwards read
        the pack. Always recomputed from the current weights and scales."""
        if not all(layer.calibrated for layer in self._quant_layers()):
            raise ValueError("pack() needs calibrated scales: calibrate() "
                             "first")
        quant.set_mode(self.model, "pack", bias_correction)
        try:
            self._forward(mixtures, conditions)
        finally:
            quant.set_mode(self.model, "int8")
