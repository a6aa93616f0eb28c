"""CLAP query encoder, text modality (counterpart of
lass_tpu/models/query_encoder.py): ``get_query_embed('text', text=[...])``
-> (B, 512) normalized conditioning vectors on the encoder's device.

Host tokenization -> RoBERTa + text_projection + L2 normalise, behind a
per-caption LRU. The encoder is frozen, so a caption's embedding is a pure
function of the string and rows assembled from the cache equal recomputed
ones. The cache is guarded by a lock: serving threads share one encoder.
The audio and 'hybird' modalities (HTSAT audio tower) are a later slice.
"""
from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence

import torch

from lass_torch.models.clap.model import CLAPTextEncoder
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
        device: str = "cuda",
    ):
        """text_state_dict: the CLAPTextEncoder's weights (``text_branch.*``
        + ``text_projection.*``); None builds random weights and warns.
        text_embed_cache: LRU size in captions (0 disables)."""
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

    @classmethod
    def from_npz(cls, path: str, roberta_cfg: RobertaConfig = RobertaConfig(),
                 **kwargs) -> "CLAPQueryEncoder":
        """Build from a CLAP pack of scripts/convert_checkpoint.py
        (``--kind clap``). Only the text branch is read; the pack's audio
        branch waits for the audio-tower slice."""
        from lass_torch.convert.checkpoint_io import load_npz_variables
        from lass_torch.convert.from_jax import clap_text_state_dict_from_jax

        pack = load_npz_variables(path)
        sd = clap_text_state_dict_from_jax(pack["text"]["params"],
                                           roberta_cfg.num_hidden_layers)
        return cls(text_state_dict=sd, roberta_cfg=roberta_cfg, **kwargs)

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

    def get_query_embed(self, modality: str, audio=None,
                        text: Optional[Sequence[str]] = None,
                        use_text_ratio: float = 0.5,
                        seed: Optional[int] = None) -> torch.Tensor:
        """The reference CLAP_Encoder API; only ``modality='text'`` is
        ported so far."""
        if modality == "text":
            return self._get_text_embed(text)
        if modality in ("audio", "hybird"):  # reference spelling kept
            raise NotImplementedError(
                f"modality {modality!r} needs the CLAP audio tower (HTSAT), "
                "which lass_torch does not have yet")
        raise NotImplementedError(f"modality '{modality}'")
