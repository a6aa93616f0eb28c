"""Byte-level BPE tokenizer (GPT-2 family) with RoBERTa specials, and a
hash fallback for runs without vocab assets.

The port's own copy of the roberta and fallback tokenizers of
lass_tpu/models/clap/tokenizer.py. No vocab is downloaded: the assets
(vocab.json + merges.txt, the standard GPT-2/roberta format) come from
``RobertaBPETokenizer(vocab_path, merges_path)`` or the
``LASS_TPU_ROBERTA_VOCAB_DIR`` environment variable.

Output contract matches the reference call
``tokenizer(text, padding='max_length', truncation=True, max_length=512)``:
ids ``[<s>] + bpe + [</s>]`` truncated to max_length (keeping the closing
</s>), padded with <pad>=1, plus an attention mask. Padding length is
configurable because the encoder output is padding-invariant.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

try:
    import regex as _re

    _PAT = _re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
        r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
except ImportError:  # the regex module is optional; ASCII classes then
    import re as _re

    _PAT = _re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+|"""
        r""" ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+""")

BOS_ID = 0
PAD_ID = 1
EOS_ID = 2
UNK_ID = 3


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class RobertaBPETokenizer:
    def __init__(self, vocab_path: Optional[str] = None,
                 merges_path: Optional[str] = None):
        if vocab_path is None:
            root = os.environ.get("LASS_TPU_ROBERTA_VOCAB_DIR")
            if root:
                vocab_path = os.path.join(root, "vocab.json")
                merges_path = os.path.join(root, "merges.txt")
        if vocab_path is None or merges_path is None:
            raise FileNotFoundError(
                "RoBERTa vocab assets required: pass vocab_path/merges_path "
                "or set LASS_TPU_ROBERTA_VOCAB_DIR")
        with open(vocab_path) as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#version") and len(l.split()) == 2]
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: List[str] = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in _PAT.findall(text):
            mapped = "".join(self.byte_encoder[b]
                             for b in chunk.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.encoder.get(piece, UNK_ID))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int = 512,
                 pad_to: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        """Batch-encode with <s>...</s>, truncation, padding, mask.

        pad_to=None pads to max_length (reference behavior); otherwise pads
        to max(longest, pad_to) rounded up — outputs are
        padding-invariant, so a small pad_to keeps inference short.
        """
        encoded = []
        for t in texts:
            body = self.encode(t)[: max_length - 2]
            encoded.append([BOS_ID] + body + [EOS_ID])
        if pad_to is None:
            target = max_length
        else:
            longest = max(len(e) for e in encoded)
            target = min(max_length,
                         max(pad_to, -(-longest // pad_to) * pad_to))
        ids = np.full((len(texts), target), PAD_ID, np.int32)
        mask = np.zeros((len(texts), target), np.int32)
        for i, e in enumerate(encoded):
            e = e[:target]
            ids[i, :len(e)] = e
            mask[i, :len(e)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class WhitespaceFallbackTokenizer:
    """Deterministic hash tokenizer for tests/smoke runs without vocab
    assets. NOT the roberta vocab — embeddings from it are only meaningful
    with models trained against it."""

    def __init__(self, vocab_size: int = 50265):
        self.vocab_size = vocab_size

    def __call__(self, texts: Sequence[str], max_length: int = 512,
                 pad_to: Optional[int] = 64) -> Dict[str, np.ndarray]:
        import hashlib

        encoded = []
        for t in texts:
            ids = [BOS_ID]
            for w in t.lower().split()[: max_length - 2]:
                h = int(hashlib.md5(w.encode()).hexdigest(), 16)
                ids.append(4 + h % (self.vocab_size - 5))
            ids.append(EOS_ID)
            encoded.append(ids)
        longest = max(len(e) for e in encoded)
        pad_to = pad_to or longest
        target = min(max_length, max(pad_to, -(-longest // pad_to) * pad_to))
        ids = np.full((len(texts), target), PAD_ID, np.int32)
        mask = np.zeros((len(texts), target), np.int32)
        for i, e in enumerate(encoded):
            e = e[:target]
            ids[i, :len(e)] = e
            mask[i, :len(e)] = 1
        return {"input_ids": ids, "attention_mask": mask}
