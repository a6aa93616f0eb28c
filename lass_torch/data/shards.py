"""Tar-shard streaming dataset (counterpart of lass_tpu/data/shards.py,
the same host code): the reference's webdataset pipeline
(models/CLAP/training/data.py:676-826 get_wds_dataset), the subset it
uses:

- brace-pattern shard lists (``path/{000000..000042}.tar``) and globs;
- the deterministic epoch-seeded shard shuffle (wds.detshuffle: seed +
  epoch);
- shard splitting by host (wds.split_by_node, ``process_index`` /
  ``process_count``) and by worker (wds.split_by_worker);
- tar streaming with per-key sample grouping and a log-and-continue error
  handler (wds.tarfile_to_samples(handler=log_and_continue));
- the bounded-buffer sample shuffle (wds.shuffle bufsize/initial);
- the sample preprocess of training/data.py (:564-673): the int16
  round trip, get_audio_features' fill and truncation
  (``prepare_audio`` / ``prepare_audio_fusion``), text-augment selection
  (none/all/augment_only), a random caption of several, an optional
  multi-hot ``class_label`` from the json ``tag`` list;
- numpy batch collation (collate_fn :655-673) and the with_epoch batch
  accounting from sizes.json (get_dataset_size :350-377, sample_prop
  :383-410).

Members decode as WAV or FLAC by their magic bytes
(``lass_torch.audio.io.read_audio_bytes``), on the iterating thread;
``decode_s`` sums the seconds spent decoding. For a given seed and epoch
the sample order is lass_tpu's when one worker reads the shards (several
worker threads interleave their shards in arrival order, in both
packages). ``shard_epochs`` chains a CLI's epochs of such datasets.
"""
from __future__ import annotations

import glob as _glob
import json
import logging
import math
import os
import random
import re
import tarfile
import threading
import time
from dataclasses import dataclass, field
from queue import Queue
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

_BRACE = re.compile(r"\{(\d+)\.\.(\d+)\}")

# wds defaults (training/data.py:377-380)
SHARD_SHUFFLE_SIZE = 2000
SHARD_SHUFFLE_INITIAL = 500
SAMPLE_SHUFFLE_SIZE = 5000
SAMPLE_SHUFFLE_INITIAL = 1000
# audio members a sample may hold when no audio_ext is given, in order
AUDIO_EXTS = ("wav", "flac")


def expand_shards(patterns: Sequence[str]) -> List[str]:
    """Brace ranges (``{000000..000042}``, zero-padded like wds) + glob.

    Braces expand recursively (wds braceexpand supports multiple ranges in
    one pattern, e.g. ``a{0..1}/b{00..02}.tar``)."""
    out: List[str] = []
    for pat in patterns:
        m = _BRACE.search(pat)
        if m:
            lo, hi = m.group(1), m.group(2)
            width = len(lo)
            for i in range(int(lo), int(hi) + 1):
                out.extend(expand_shards(
                    [pat[:m.start()] + str(i).zfill(width) + pat[m.end():]]))
        elif any(ch in pat for ch in "*?["):
            out.extend(sorted(_glob.glob(pat)))
        else:
            out.append(pat)
    return out


def get_dataset_size(shards: Sequence[str],
                     sizefilepath: Optional[str] = None):
    """(num_samples, num_shards) from sizes.json next to the shards
    (reference get_dataset_size, training/data.py:350-377). Returns
    num_samples=None when no size info exists."""
    if not shards:
        return None, 0
    path = sizefilepath or os.path.join(os.path.dirname(shards[0]),
                                        "sizes.json")
    if not os.path.exists(path):
        return None, len(shards)
    with open(path, "r", encoding="utf-8") as f:
        sizes = json.load(f)
    total = sum(int(sizes[os.path.basename(s)]) for s in shards
                if os.path.basename(s) in sizes)
    return (total or None), len(shards)


def sample_prop(shards: Sequence[str], proportion: float,
                sizefilepath: Optional[str] = None, seed: int = 0):
    """Sample a proportion of the shard list (reference sample_prop,
    training/data.py:383-410). Returns (num_samples, shards)."""
    shards = list(shards)
    k = int(len(shards) * proportion)
    rng = random.Random(seed)
    picked = rng.sample(shards, k)
    num, _ = get_dataset_size(picked, sizefilepath)
    return num, picked


def detshuffle(items: List, seed: int, epoch: int) -> List:
    """Deterministic epoch-dependent shuffle (wds.detshuffle semantics:
    rng keyed by seed + epoch so every host draws the same order)."""
    out = list(items)
    random.Random(seed + epoch).shuffle(out)
    return out


def log_and_continue(exn: Exception) -> bool:
    logging.warning("tar-shard pipeline: %r — skipping", exn)
    return True


def iter_tar_samples(path: str, handler=log_and_continue
                     ) -> Iterator[Dict[str, bytes]]:
    """Stream one tar shard, grouping consecutive members that share a key
    (basename up to the first dot) into {'__key__', '__url__', ext: bytes}
    dicts — wds.tarfile_to_samples' grouping rule."""
    try:
        tf = tarfile.open(path, "r|*")  # streaming mode: no random access
    except (OSError, tarfile.TarError) as exn:
        if handler(exn):
            return
        raise
    current: Dict[str, bytes] = {}
    key = None
    with tf:
        while True:
            try:
                member = tf.next()
                if member is None:
                    break
                if not member.isfile():
                    continue
                name = member.name
                base, dot, ext = name.partition(".")
                if not dot:
                    continue
                payload = tf.extractfile(member).read()
            except (OSError, tarfile.TarError) as exn:
                if handler(exn):
                    break
                raise
            if key is not None and base != key:
                yield current
                current = {}
            key = base
            current["__key__"] = key
            current["__url__"] = path
            current[ext.lower()] = payload
    if current:
        yield current


def _int16_roundtrip(x: np.ndarray) -> np.ndarray:
    """int16_to_float32(float32_to_int16(x)) (training/data.py:310-320):
    the reference quantizes every clip through int16 on load — clip to
    [-1, 1], scale by 32767, truncate to int16, scale back."""
    q = (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
    return (q / 32767.0).astype(np.float32)


@dataclass
class TarShardDataset:
    """Iterable over preprocessed samples from tar shards.

    Mirrors the reference train pipeline order: detshuffle(shards) →
    split_by_node → split_by_worker → tarfile_to_samples → shuffle →
    preprocess → batch. ``train=False`` drops the shuffles and the node
    split (reference eval branch, data.py:746-754).
    """

    shards: Sequence[str]
    batch_size: int = 32
    max_len: int = 480000
    data_filling: str = "repeatpad"
    data_truncating: str = "rand_trunc"
    text_augment_selection: Optional[str] = None
    class_index_dict: Optional[Dict[str, int]] = None
    # None: the sample's "wav" member, else its "flac" one (lass_tpu reads
    # only "wav" members unless told otherwise)
    audio_ext: Optional[str] = None
    text_ext: str = "json"
    train: bool = True
    num_workers: int = 4
    seed: int = 0
    epoch: int = 0
    shuffle_buffer: int = SAMPLE_SHUFFLE_SIZE
    shuffle_initial: int = SAMPLE_SHUFFLE_INITIAL
    process_index: Optional[int] = None
    process_count: Optional[int] = None
    num_samples: Optional[int] = field(default=None)
    sizefilepath: Optional[str] = None

    def __post_init__(self):
        self.decode_s = 0.0
        self.shards = expand_shards(list(self.shards))
        if self.num_samples is None:
            self.num_samples, _ = get_dataset_size(
                self.shards, self.sizefilepath)

    # --- accounting (reference data.py:779-800 with_epoch math) ---
    def num_batches(self, world_size: int = 1) -> Optional[int]:
        if self.num_samples is None:
            return None
        if not self.train:
            return math.ceil(self.num_samples / self.batch_size)
        global_bs = self.batch_size * world_size
        num_batches = math.ceil(self.num_samples / global_bs)
        workers = max(1, self.num_workers)
        return math.ceil(num_batches / workers) * workers

    # --- pipeline ---
    def _host_shards(self) -> List[str]:
        shards = list(self.shards)
        if self.train:
            shards = detshuffle(shards, self.seed, self.epoch)
        if self.process_index is not None and (self.process_count or 1) > 1:
            shards = shards[self.process_index::self.process_count]
        return shards

    def _iter_raw(self) -> Iterator[Dict[str, bytes]]:
        """Worker threads stream disjoint shard slices into one queue."""
        shards = self._host_shards()
        workers = max(1, min(self.num_workers, len(shards) or 1))
        if workers == 1:
            for shard in shards:
                yield from iter_tar_samples(shard)
            return
        q: Queue = Queue(maxsize=4 * self.batch_size)
        done = object()

        def pump(worker_id: int):
            try:
                for shard in shards[worker_id::workers]:
                    for sample in iter_tar_samples(shard):
                        q.put(sample)
            finally:
                q.put(done)

        threads = [threading.Thread(target=pump, args=(i,), daemon=True)
                   for i in range(workers)]
        for t in threads:
            t.start()
        finished = 0
        while finished < workers:
            item = q.get()
            if item is done:
                finished += 1
            else:
                yield item

    def _iter_shuffled(self) -> Iterator[Dict[str, bytes]]:
        if not self.train:
            yield from self._iter_raw()
            return
        rng = random.Random(self.seed + self.epoch + 1)
        initial = min(self.shuffle_initial, self.shuffle_buffer)
        buf: List[Dict[str, bytes]] = []

        def pick():
            i = rng.randrange(len(buf))
            buf[i], buf[-1] = buf[-1], buf[i]
            return buf.pop()

        # wds._shuffle semantics: keep filling toward `bufsize` (consuming
        # an extra item per yield while below it), start yielding once
        # `initial` items are buffered — steady-state buffer == bufsize.
        it = self._iter_raw()
        for sample in it:
            buf.append(sample)
            if len(buf) < self.shuffle_buffer:
                try:
                    buf.append(next(it))
                except StopIteration:
                    pass
            if len(buf) >= initial:
                yield pick()
        while buf:
            yield pick()

    def preprocess(self, sample: Dict[str, bytes],
                   rng: np.random.Generator) -> Optional[Dict]:
        """training/data.py preprocess (:564-673) on one raw sample."""
        from lass_torch.audio.io import read_audio_bytes
        from lass_torch.models.clap.audio_features import (
            prepare_audio, prepare_audio_fusion)

        ext = self.audio_ext or next(
            (e for e in AUDIO_EXTS if e in sample), None)
        if ext not in sample or self.text_ext not in sample:
            return None
        start = time.perf_counter()
        try:
            wav, sr = read_audio_bytes(sample[ext], mono=True)
        except ValueError as exn:
            log_and_continue(exn)
            return None
        finally:
            self.decode_s += time.perf_counter() - start
        audio = _int16_roundtrip(wav[0])

        out: Dict = {"__key__": sample["__key__"],
                     "__url__": sample["__url__"],
                     "audio_orig_sr": sr}
        if self.data_truncating == "fusion":
            mel_fusion, longer, audio = prepare_audio_fusion(
                audio, self.max_len, self.data_filling, rng=rng)
            out["mel_fusion"] = mel_fusion
            out["longer"] = longer
        else:
            audio = prepare_audio(audio, self.max_len, self.data_filling,
                                  self.data_truncating, rng=rng)
        out["waveform"] = audio

        raw = json.loads(sample[self.text_ext].decode("utf-8"))
        sel = self.text_augment_selection
        if sel in (None, "none"):
            texts = raw["text"]
        elif sel == "all":
            texts = raw.get("text_augment_all") or raw["text"]
        elif sel == "augment_only":
            texts = raw.get("text_augment_t5") or raw["text"]
        else:
            raise NotImplementedError(f"text_augment_selection {sel}")
        out["full_text"] = texts
        if isinstance(texts, list) and texts and isinstance(texts[0], str) \
                and len(texts) > 1:
            texts = texts[int(rng.integers(0, len(texts)))]
        elif isinstance(texts, list) and texts:
            texts = texts[0]
        out["raw_text"] = texts

        if self.class_index_dict is not None:
            label = np.zeros(len(self.class_index_dict), np.float32)
            for tag in raw.get("tag", []):
                label[self.class_index_dict[tag]] = 1.0
            out["class_label"] = label
        out["audio_name"] = f"{sample['__key__']}.{ext}"
        out["text_name"] = f"{sample['__key__']}.{self.text_ext}"
        return out

    def __iter__(self) -> Iterator[Dict]:
        """Yields collated numpy batches. Train epochs yield only full
        batches (wds.batched(partial=False)); eval keeps the tail."""
        rng = np.random.default_rng(self.seed + 7919 * (self.epoch + 1))
        batch: List[Dict] = []
        for raw in self._iter_shuffled():
            item = self.preprocess(raw, rng)
            if item is None:
                continue
            batch.append(item)
            if len(batch) == self.batch_size:
                yield collate(batch)
                batch = []
        if batch and not self.train:
            yield collate(batch)


def shard_epochs(make_dataset: Callable[[int], "TarShardDataset"],
                 stats: Dict[str, float]) -> Iterator[Dict]:
    """The batches of ``make_dataset(epoch)`` for epoch 0, 1, ...;
    ``stats["decode_s"]`` gains each dataset's decode seconds as its
    batches come. Raises on an epoch with no batch: train epochs drop
    partial batches, so shards smaller than one batch would loop forever."""
    epoch = 0
    while True:
        ds = make_dataset(epoch)
        yielded = 0
        for batch in ds:
            stats["decode_s"] += ds.decode_s
            ds.decode_s = 0.0
            yield batch
            yielded += 1
        if yielded == 0:
            raise RuntimeError(
                f"train shards produced zero full batches (batch_size="
                f"{ds.batch_size}): check the shard pattern or the batch "
                f"size")
        epoch += 1


def collate(batch: List[Dict]) -> Dict:
    """numpy analog of the reference collate_fn (training/data.py:655-673):
    arrays stack, scalars become arrays, strings stay lists."""
    out: Dict = {}
    for k in batch[0]:
        v = batch[0][k]
        if isinstance(v, np.ndarray):
            out[k] = np.stack([b[k] for b in batch])
        elif isinstance(v, (bool, np.bool_)):
            out[k] = np.asarray([b[k] for b in batch], np.bool_)
        elif isinstance(v, (int, float, np.integer, np.floating)):
            out[k] = np.asarray([b[k] for b in batch])
        else:
            out[k] = [b[k] for b in batch]
    return out
