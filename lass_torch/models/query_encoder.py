"""CLAP query encoder (counterpart of lass_tpu/models/query_encoder.py),
the reference CLAP_Encoder API (models/clap_encoder.py:93-106):
``get_query_embed(modality, audio=, text=, use_text_ratio=, seed=)`` ->
(B, 512) normalized conditioning vectors on the encoder's device.

- 'text': host tokenization -> RoBERTa + text_projection + L2 normalise,
  behind a per-caption LRU. The encoder is frozen, so a caption's
  embedding is a pure function of the string and rows assembled from the
  cache equal recomputed ones. The cache is guarded by a lock: serving
  threads share one encoder.
- 'audio' (after ``attach_audio_encoder``): resample to 48 kHz on the
  device, fill or crop to ``clip_samples``, HTSAT + audio_projection + L2
  normalise. The WHOLE batch is embedded: the reference embeds only the
  first item (a return inside its loop, clap_encoder.py:74-76), which is
  not reproduced.
- 'hybird' [sic, the reference's spelling]: one coin per call against
  ``use_text_ratio``, from ``np.random.default_rng(seed)`` when a seed is
  given, else from the encoder's own generator.
"""
from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from lass_torch.models.clap.htsat import HTSATConfig
from lass_torch.models.clap.model import CLAPAudioEncoder, CLAPTextEncoder
from lass_torch.models.clap.roberta import RobertaConfig
from lass_torch.models.clap.tokenizer import (
    RobertaBPETokenizer, WhitespaceFallbackTokenizer)

logger = logging.getLogger("lass_torch.query_encoder")


class CLAPQueryEncoder:
    encoder_type = "CLAP"

    def __init__(
        self,
        text_state_dict: Optional[Dict[str, torch.Tensor]] = None,
        tokenizer: Optional[Callable] = None,
        roberta_cfg: RobertaConfig = RobertaConfig(),
        joint_embed_dim: int = 512,
        max_length: int = 512,
        pad_to: Optional[int] = 64,
        text_embed_cache: int = 4096,
        rng_seed: int = 0,
        device: str = "cuda",
    ):
        """text_state_dict: the CLAPTextEncoder's weights (``text_branch.*``
        + ``text_projection.*``); None builds random weights and warns.
        text_embed_cache: LRU size in captions (0 disables). rng_seed
        seeds the 'hybird' coin of calls that pass no seed. The audio
        tower is attached with ``attach_audio_encoder``."""
        self.device = torch.device(device)
        self.text_model = CLAPTextEncoder(roberta_cfg, joint_embed_dim)
        self.has_pretrained_text = text_state_dict is not None
        if text_state_dict is not None:
            self.text_model.load_state_dict(text_state_dict)
        else:
            logger.warning(
                "CLAPQueryEncoder built WITHOUT pretrained text weights — "
                "conditioning embeddings are random-init. Load a converted "
                "CLAP pack (CLAPQueryEncoder.from_npz).")
        self.text_model.to(self.device).eval()
        if tokenizer is None:
            try:
                tokenizer = RobertaBPETokenizer()
            except FileNotFoundError as exc:
                logger.warning(
                    "roberta vocab assets not found (%s) — falling back to "
                    "the hash-bucket whitespace tokenizer. Token ids will "
                    "NOT match the reference tokenizer.", exc)
                tokenizer = WhitespaceFallbackTokenizer(roberta_cfg.vocab_size)
        self.tokenizer = tokenizer
        self.using_fallback_tokenizer = isinstance(
            tokenizer, WhitespaceFallbackTokenizer)
        self.max_length = max_length
        self.pad_to = pad_to
        self._lock = threading.Lock()
        self._embed_cache_size = int(text_embed_cache)
        self._embed_cache: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        self.embed_cache_hits = 0
        self.embed_cache_misses = 0
        self._rng = np.random.default_rng(rng_seed)
        # the random crops of clips longer than clip_samples (fusion)
        self._crop_rng = np.random.default_rng(rng_seed)
        self.audio_model: Optional[CLAPAudioEncoder] = None
        self.has_pretrained_audio = False

    @classmethod
    def from_npz(cls, path: str, roberta_cfg: RobertaConfig = RobertaConfig(),
                 htsat_cfg: Optional[HTSATConfig] = None,
                 **kwargs) -> "CLAPQueryEncoder":
        """Build from a CLAP pack of scripts/convert_checkpoint.py
        (``--kind clap``): the text branch and, when the pack has one
        (``audio/params/...``, ``audio/batch_stats/...``), the HTSAT audio
        branch at ``htsat_cfg`` (default HTSAT-base) and the default
        ``attach_audio_encoder`` rates."""
        from lass_torch.convert.checkpoint_io import load_npz_variables
        from lass_torch.convert.from_jax import (
            clap_audio_state_dict_from_jax, clap_text_state_dict_from_jax)

        pack = load_npz_variables(path)
        sd = clap_text_state_dict_from_jax(pack["text"]["params"],
                                           roberta_cfg.num_hidden_layers)
        enc = cls(text_state_dict=sd, roberta_cfg=roberta_cfg, **kwargs)
        if "audio" in pack:
            htsat_cfg = htsat_cfg or HTSATConfig()
            enc.attach_audio_encoder(
                clap_audio_state_dict_from_jax(pack["audio"],
                                               htsat_cfg.depths),
                htsat_cfg)
        return enc

    def attach_audio_encoder(self, audio_state_dict: Optional[
                                 Dict[str, torch.Tensor]] = None,
                             htsat_cfg: Optional[HTSATConfig] = None,
                             sampling_rate: int = 32000,
                             clip_samples: int = 480000) -> None:
        """Wire the CLAP audio tower: (B, L) or (B, 1, L) audio at
        ``sampling_rate`` -> 48 kHz (clap_encoder.py:59-61) -> filled or
        cropped to ``clip_samples`` (training/data.py:451-563) -> HTSAT +
        audio_projection -> normalized (B, 512).

        audio_state_dict: a CLAPAudioEncoder state dict (``audio_branch.*``
        + ``audio_projection.*``); None builds random weights and warns.
        The default rate is the reference's 32 kHz, which LASS's 16 kHz
        data does not have: callers with 16 kHz audio pass
        ``sampling_rate=16000``."""
        cfg = htsat_cfg or HTSATConfig()
        model = CLAPAudioEncoder(cfg)
        self.has_pretrained_audio = audio_state_dict is not None
        if audio_state_dict is not None:
            model.load_state_dict(audio_state_dict)
        else:
            logger.warning(
                "CLAP audio tower attached WITHOUT pretrained weights — "
                "audio conditioning embeddings are random-init.")
        self.audio_model = model.to(self.device).eval()
        self.sampling_rate = sampling_rate
        self.clip_samples = clip_samples

    def embed_text_batch(self, texts: Sequence[str]) -> torch.Tensor:
        """Tokenize and encode, bypassing the cache."""
        tok = self.tokenizer(list(texts), max_length=self.max_length,
                             pad_to=self.pad_to)
        ids = torch.from_numpy(tok["input_ids"]).long().to(self.device)
        mask = torch.from_numpy(tok["attention_mask"]).long().to(self.device)
        with torch.inference_mode():
            return self.text_model(ids, mask)

    def _get_text_embed(self, texts: Sequence[str]) -> torch.Tensor:
        if not self._embed_cache_size:
            return self.embed_text_batch(texts)
        cache = self._embed_cache
        with self._lock:
            if all(t in cache for t in texts):
                self.embed_cache_hits += 1
                for t in texts:  # refresh LRU order
                    cache.move_to_end(t)
                return torch.stack([cache[t] for t in texts])
            self.embed_cache_misses += 1
        # miss: embed the WHOLE batch outside the lock, cache every row
        out = self.embed_text_batch(texts)
        with self._lock:
            for t, row in zip(texts, out):
                cache[t] = row.clone()
                cache.move_to_end(t)
            while len(cache) > self._embed_cache_size:
                cache.popitem(last=False)
        return out

    def _get_audio_embed(self, audio) -> torch.Tensor:
        """(B, L) or (B, 1, L) audio at ``sampling_rate``, numpy or a
        tensor on any device -> (B, 512). A clip whose 48 kHz length is
        clip_samples, as every 10 s clip's is, stays on the device; other
        lengths are filled or cropped on the host (``prepare_audio_*``),
        and a fusion-enabled tower builds its mel stacks there."""
        from lass_torch.audio.resample import resample
        from lass_torch.models.clap.audio_features import (
            prepare_audio_batch, prepare_audio_fusion)

        model = self.audio_model
        wave = torch.as_tensor(audio)
        if wave.dim() == 3:
            wave = wave[:, 0]
        with torch.inference_mode():
            wave48 = resample(wave.to(self.device, torch.float32),
                              self.sampling_rate, 48000)
            cfg = model.audio_branch.cfg
            if cfg.enable_fusion:
                stacks = [prepare_audio_fusion(
                    w, self.clip_samples, mel_cfg=cfg.mel, rng=self._crop_rng)
                    for w in wave48.cpu().numpy()]
                return model(
                    mel_fusion=torch.from_numpy(np.stack(
                        [m for m, _, _ in stacks])).to(self.device),
                    longer=torch.tensor([lg for _, lg, _ in stacks],
                                        device=self.device))
            if wave48.shape[-1] != self.clip_samples:
                wave48 = torch.from_numpy(prepare_audio_batch(
                    wave48.cpu().numpy(), self.clip_samples)).to(self.device)
            return model(wave48)

    def get_query_embed(self, modality: str, audio=None,
                        text: Optional[Sequence[str]] = None,
                        use_text_ratio: float = 0.5,
                        seed: Optional[int] = None,
                        text_neg: Optional[Sequence[str]] = None):
        """The reference CLAP_Encoder API: 'text' (``text``: B captions),
        'audio' (``audio``: (B, L) or (B, 1, L) at ``sampling_rate``) or
        'hybird' (both; audio when the coin's draw exceeds
        ``use_text_ratio``). -> (B, 512) on the encoder's device.
        'text' with ``text_neg`` (the negative-query variant) -> the
        (pos, neg) pair of (B, 512) embeddings, which
        ``lass_torch.tasks.audiosep_variants.NegQueryFusion`` fuses."""
        if modality == "text" and text_neg is not None:
            return self._get_text_embed(text), self._get_text_embed(text_neg)
        if modality == "text":
            return self._get_text_embed(text)
        if modality not in ("audio", "hybird"):  # reference spelling kept
            raise NotImplementedError(f"modality '{modality}'")
        if self.audio_model is None:
            raise NotImplementedError(
                f"modality {modality!r} needs the CLAP audio tower (HTSAT): "
                "call attach_audio_encoder() first")
        if modality == "hybird":
            if seed is not None:
                draw = np.random.default_rng(seed).random()
            else:
                with self._lock:
                    draw = self._rng.random()
            if draw <= use_text_ratio:
                return self._get_text_embed(text)
        return self._get_audio_embed(audio)
