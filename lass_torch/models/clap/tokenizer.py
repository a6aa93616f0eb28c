"""Caption tokenizers for the CLAP text branches, and a hash fallback for
runs without vocab assets: the port's own copy of
lass_tpu/models/clap/tokenizer.py.

- ``RobertaBPETokenizer``: byte-level BPE (GPT-2 family) with RoBERTa's
  specials; vocab.json + merges.txt from its arguments or the
  ``LASS_TPU_ROBERTA_VOCAB_DIR`` environment variable;
- ``BartBPETokenizer``: the same algorithm and special ids over
  bart-base's assets, from ``LASS_TPU_BART_VOCAB_DIR``;
- ``WordPieceTokenizer``: BERT's (bert-base-uncased) basic + WordPiece
  pipeline over a vocab.txt from ``LASS_TPU_BERT_VOCAB``.

No vocab is downloaded.

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
import unicodedata
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
        encoded = [[BOS_ID] + self.encode(t)[: max_length - 2] + [EOS_ID]
                   for t in texts]
        return _pad_batch(encoded, _padded_length(encoded, max_length,
                                                  pad_to), PAD_ID)


def _padded_length(encoded: List[List[int]], max_length: int,
                   pad_to: Optional[int]) -> int:
    """max_length when pad_to is None, else the longest row rounded up to
    a multiple of pad_to (at least pad_to), at most max_length."""
    if pad_to is None:
        return max_length
    longest = max(len(e) for e in encoded)
    return min(max_length, max(pad_to, -(-longest // pad_to) * pad_to))


def _pad_batch(encoded: List[List[int]], target: int, pad_id: int
               ) -> Dict[str, np.ndarray]:
    """Rows cut or padded with pad_id to target, and their mask."""
    ids = np.full((len(encoded), target), pad_id, np.int32)
    mask = np.zeros((len(encoded), target), np.int32)
    for i, e in enumerate(encoded):
        e = e[:target]
        ids[i, :len(e)] = e
        mask[i, :len(e)] = 1
    return {"input_ids": ids, "attention_mask": mask}


class BartBPETokenizer(RobertaBPETokenizer):
    """The BART branch's tokenizer (reference open_clip/bert.py:29-31,
    training/data.py tmodel='bart'): facebook/bart-base has RoBERTa's
    byte-level BPE and special ids (<s>=0, <pad>=1, </s>=2) over its own
    assets, vocab.json + merges.txt, from the arguments or
    ``LASS_TPU_BART_VOCAB_DIR``."""

    def __init__(self, vocab_path: Optional[str] = None,
                 merges_path: Optional[str] = None):
        if vocab_path is None:
            root = os.environ.get("LASS_TPU_BART_VOCAB_DIR")
            if root:
                vocab_path = os.path.join(root, "vocab.json")
                merges_path = os.path.join(root, "merges.txt")
        if vocab_path is None or merges_path is None:
            raise FileNotFoundError(
                "BART vocab assets required: pass vocab_path/merges_path "
                "or set LASS_TPU_BART_VOCAB_DIR")
        super().__init__(vocab_path, merges_path)


def _is_punctuation(ch: str) -> bool:
    """BERT's punctuation: every non-alphanumeric ASCII printable, and
    Unicode's P* categories."""
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    """The CJK Unified Ideographs blocks BERT splits into single tokens."""
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class WordPieceTokenizer:
    """The BERT branch's tokenizer (bert-base-uncased; reference
    open_clip/bert.py:1-3, training/data.py tmodel='bert'): HF
    BertTokenizer's basic pipeline (drop control characters, space out CJK
    ideographs, lower case and strip accents by NFD, split punctuation),
    then greedy longest-match-first WordPiece with '##' continuations; a
    word over ``max_word_chars`` characters is [UNK]. The vocab (vocab.txt,
    one token per line; [PAD], [UNK], [CLS] and [SEP] read from it) comes
    from the argument or ``LASS_TPU_BERT_VOCAB``. The output adds
    ``token_type_ids``, all zeros (one segment per caption)."""

    def __init__(self, vocab_path: Optional[str] = None,
                 do_lower_case: bool = True, max_word_chars: int = 100):
        vocab_path = vocab_path or os.environ.get("LASS_TPU_BERT_VOCAB")
        if vocab_path is None:
            raise FileNotFoundError(
                "BERT WordPiece vocab required: pass vocab_path or set "
                "LASS_TPU_BERT_VOCAB (path to vocab.txt)")
        with open(vocab_path, encoding="utf-8") as f:
            self.vocab: Dict[str, int] = {
                line.rstrip("\n"): i for i, line in enumerate(f)}
        self.pad_id = self.vocab["[PAD]"]
        self.unk_id = self.vocab["[UNK]"]
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.do_lower_case = do_lower_case
        self.max_word_chars = max_word_chars

    def _basic(self, text: str) -> List[str]:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD:
                continue
            cat = unicodedata.category(ch)
            if cat.startswith("C") and ch not in "\t\n\r":
                continue
            if _is_cjk(cp):
                chars.append(f" {ch} ")
            elif ch in "\t\n\r" or cat == "Zs":
                chars.append(" ")
            else:
                chars.append(ch)
        tokens: List[str] = []
        for word in "".join(chars).split():
            if self.do_lower_case:
                word = "".join(
                    c for c in unicodedata.normalize("NFD", word.lower())
                    if unicodedata.category(c) != "Mn")
            piece: List[str] = []
            for ch in word:
                if _is_punctuation(ch):
                    if piece:
                        tokens.append("".join(piece))
                        piece = []
                    tokens.append(ch)
                else:
                    piece.append(ch)
            if piece:
                tokens.append("".join(piece))
        return tokens

    def _wordpiece(self, token: str) -> List[int]:
        if len(token) > self.max_word_chars:
            return [self.unk_id]
        pieces: List[int] = []
        start = 0
        while start < len(token):
            end = len(token)
            while end > start:
                sub = token[start:end] if start == 0 \
                    else "##" + token[start:end]
                if sub in self.vocab:
                    break
                end -= 1
            if end == start:
                return [self.unk_id]
            pieces.append(self.vocab[sub])
            start = end
        return pieces

    def encode(self, text: str) -> List[int]:
        return [i for tok in self._basic(text) for i in self._wordpiece(tok)]

    def __call__(self, texts: Sequence[str], max_length: int = 512,
                 pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
        encoded = [[self.cls_id] + self.encode(t)[: max_length - 2]
                   + [self.sep_id] for t in texts]
        out = _pad_batch(encoded, _padded_length(encoded, max_length,
                                                 pad_to), self.pad_id)
        out["token_type_ids"] = np.zeros_like(out["input_ids"])
        return out


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
        return _pad_batch(encoded, _padded_length(encoded, max_length,
                                                  pad_to or longest), PAD_ID)
