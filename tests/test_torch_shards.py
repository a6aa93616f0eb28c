"""lass_torch's tar shards and FLAC decoder against lass_tpu's, on the CPU
(host code, numpy on both sides; everything must be equal):

- FLAC: every stream shape of tests/test_audio.py (encoder output, mono and
  stereo, several blocks; the hand-authored LPC, left/right/mid-side,
  escape, constant + wasted-bits and 8- and 24-bit frames of its
  ``_author_flac``) decodes to lass_tpu's arrays, with and without the mono
  mix; the encoder writes lass_tpu's bytes; ``read_audio`` and
  ``read_audio_bytes`` sniff WAV and FLAC alike;
- the shard pipeline: brace and glob expansion, sizes.json accounting,
  ``sample_prop``, ``detshuffle``, the sample shuffle buffer, the host
  split, train and eval epochs, and ``TarShardDataset``'s batches (sample
  order, waveforms, captions, labels, the fusion mel stack) for given
  seeds and epochs, over WAV and FLAC members.
"""
import io
import json
import os
import tarfile

import numpy as np
import pytest

from lass_tpu.audio import flac as jax_flac
from lass_tpu.audio import io as jax_io
from lass_tpu.data import shards as jax_shards
from lass_torch.audio import flac, io as port_io
from lass_torch.data import shards
from lass_torch.data.synth import make_synth_shards
from test_audio import _author_flac, _verbatim
from torch_threads import torch_threads_per_worker  # noqa: F401


def _lpc_stream():
    """tests/test_audio.py's LPC frame: order 3, 7-bit coefficients."""
    rng = np.random.RandomState(7)
    n, order, shift, coeffs = 64, 3, 5, [37, -21, 9]
    x = (rng.randn(n) * 3000).astype(np.int64)
    res = [int(x[i]) - (int(sum(c * x[i - 1 - j]
                                for j, c in enumerate(coeffs))) >> shift)
           for i in range(order, n)]

    def sub(bw, sub_bps):
        bw.write(0, 1)
        bw.write(0x20 | (order - 1), 6)
        bw.write(0, 1)
        for w in x[:order]:
            bw.write(int(w), sub_bps)
        bw.write(7 - 1, 4)
        bw.write(shift, 5)
        for c in coeffs:
            bw.write(c, 7)
        bw.write(0, 2)
        bw.write(0, 4)
        bw.write(6, 4)
        jax_flac._write_rice(bw, np.asarray(res), 6)

    return _author_flac([sub], n)


def _escape_streams():
    """A FIXED order-0 subframe with an escaped 8-bit partition, one with
    the all-zero escape, and a CONSTANT subframe with two wasted bits."""
    vals = np.clip(np.random.RandomState(3).randn(32) * 50, -127,
                   127).astype(np.int64)

    def escaped(raw_bits):
        def sub(bw, sub_bps):
            bw.write(0, 1)
            bw.write(8, 6)
            bw.write(0, 1)
            bw.write(0, 2)
            bw.write(0, 4)
            bw.write(15, 4)
            bw.write(raw_bits, 5)
            for v in vals if raw_bits else ():
                bw.write(int(v), 8)
        return sub

    def const_wasted(bw, sub_bps):
        bw.write(0, 1)
        bw.write(0, 6)
        bw.write(1, 1)
        bw.write(1, 2)
        bw.write(25, sub_bps - 2)

    return [_author_flac([escaped(8)], 32), _author_flac([escaped(0)], 32),
            _author_flac([const_wasted], 32)]


def flac_streams():
    rng = np.random.RandomState(0)
    streams = [
        jax_flac.encode_flac((rng.randn(1, 10000) * 8000).clip(
            -32768, 32767).astype(np.int16), 16000),
        jax_flac.encode_flac(((rng.rand(2, 5000) * 2 - 1) * 0.7).astype(
            np.float32), 44100),
        _lpc_stream(), *_escape_streams()]
    left = (np.random.RandomState(1).randn(48) * 900).astype(np.int64)
    right = (np.random.RandomState(2).randn(48) * 900).astype(np.int64)
    side, mid = left - right, (left + right) >> 1
    for code, subs in ((8, (left, side)), (9, (side, right)),
                       (10, (mid, side))):
        streams.append(_author_flac([_verbatim(s) for s in subs], 48,
                                    chan_code=code))
    for bps, size_code in ((8, 1), (24, 6)):
        lim = (1 << (bps - 1)) - 1
        vals = np.clip(np.random.RandomState(bps).randn(24)
                       * (1 << (bps - 3)), -lim, lim).astype(np.int64)
        streams.append(_author_flac([_verbatim(vals)], 24, bps=bps,
                                    size_code=size_code))
    return streams


@pytest.mark.parametrize("mono", [False, True])
def test_flac_decode_equals_jax(mono):
    for i, blob in enumerate(flac_streams()):
        got, sr = flac.decode_flac_bytes(blob, mono)
        ref, sr_ref = jax_flac.decode_flac_bytes(blob, mono)
        assert sr == sr_ref and got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref, err_msg=f"stream {i}")
        got, _ = port_io.read_audio_bytes(blob, mono)
        np.testing.assert_array_equal(got, ref, err_msg=f"stream {i}")


def test_flac_encoder_and_files_equal_jax(tmp_path, rng):
    x = ((rng.rand(2, 9000) * 2 - 1) * 0.6).astype(np.float32)
    assert flac.encode_flac(x, 48000) == jax_flac.encode_flac(x, 48000)
    for name, write in (("a.flac", flac.write_flac),
                        ("a.wav", port_io.write_wav)):
        path = str(tmp_path / name)
        write(path, x, 48000)
        for mono in (False, True):
            got, sr = port_io.read_audio(path, mono)
            ref, sr_ref = jax_io.read_audio(path, mono)
            assert sr == sr_ref == 48000
            np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="unrecognized"):
        port_io.read_audio_bytes(b"\x00" * 64)


# ----------------------------------------------------------------- shards

def _tar(path, members):
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def shard_sets(tmp_path_factory):
    """Five WAV shards of 4 clips (0.5 s at 16 kHz, tags of 2 of 5
    classes, two captions each), and the same clips as FLAC members."""
    root = tmp_path_factory.mktemp("shards")
    wav = make_synth_shards(str(root / "wav"), num_shards=5, per_shard=4,
                            seconds=0.5, sample_rate=16000, num_classes=5,
                            tags_per_clip=2, seed=1)
    fl = make_synth_shards(str(root / "flac"), num_shards=5, per_shard=4,
                           seconds=0.5, sample_rate=16000, num_classes=5,
                           tags_per_clip=2, audio_format="flac", seed=1)
    with open(root / "wav" / "classes.json") as f:
        classes = json.load(f)
    # a shard with a bad member: skipped by the log-and-continue handler
    _tar(str(root / "bad.tar"), [("x.wav", b"not audio"),
                                 ("x.json", b'{"text": ["x"]}')])
    return str(root), wav, fl, classes


def test_expand_sizes_and_proportion_equal_jax(shard_sets, tmp_path):
    root, wav, _, _ = shard_sets
    for pats in ([wav], ["/x/{0..1}/t-{00..02}.tar"],
                 [os.path.join(root, "wav", "*.tar")]):
        assert shards.expand_shards(pats) == jax_shards.expand_shards(pats)
    listed = shards.expand_shards([wav])
    assert shards.get_dataset_size(listed) == \
        jax_shards.get_dataset_size(listed) == (20, 5)
    assert shards.get_dataset_size([str(tmp_path / "t.tar")]) == (None, 1)
    for prop, seed in ((0.4, 3), (0.6, 9)):
        assert shards.sample_prop(listed, prop, seed=seed) == \
            jax_shards.sample_prop(listed, prop, seed=seed)
    for seed, epoch in ((0, 0), (5, 1), (5, 2)):
        assert shards.detshuffle(listed, seed, epoch) == \
            jax_shards.detshuffle(listed, seed, epoch)


@pytest.mark.parametrize("initial,buffer", [(3, 7), (10, 50), (1000, 5000)])
def test_sample_shuffle_equals_jax(initial, buffer):
    """The shuffle buffer alone, over 60 numbered items."""
    out = []
    for module in (shards, jax_shards):
        ds = module.TarShardDataset.__new__(module.TarShardDataset)
        ds.train, ds.seed, ds.epoch = True, 4, 2
        ds.shuffle_buffer, ds.shuffle_initial = buffer, initial
        items = [{"i": i} for i in range(60)]
        ds._iter_raw = lambda items=items: iter(items)
        out.append([x["i"] for x in module.TarShardDataset._iter_shuffled(ds)])
    assert out[0] == out[1] and sorted(out[0]) == list(range(60))


def _keys_and_batches(module, pattern, **kw):
    ds = module.TarShardDataset(shards=[pattern], **kw)
    batches = list(ds)
    return [k for b in batches for k in b["__key__"]], batches


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for key in r:
            if isinstance(r[key], np.ndarray):
                np.testing.assert_array_equal(g[key], r[key], err_msg=key)
            elif key != "audio_name":
                assert g[key] == r[key], key


@pytest.mark.parametrize("case", [
    dict(seed=0, epoch=0, batch_size=3),
    dict(seed=7, epoch=2, batch_size=4, shuffle_initial=2,
         shuffle_buffer=6),
    dict(seed=7, epoch=1, batch_size=2, process_index=1, process_count=2,
         shuffle_initial=3, shuffle_buffer=5),
    dict(seed=1, epoch=0, batch_size=3, train=False),
    dict(seed=3, epoch=0, batch_size=2, data_filling="pad",
         text_augment_selection="all", max_len=12000),
    dict(seed=3, epoch=1, batch_size=2, data_truncating="fusion",
         max_len=6000, shuffle_initial=4, shuffle_buffer=8),
])
def test_tar_shard_batches_equal_jax(case, shard_sets):
    """lass_tpu's sample order and batches for a seed and epoch (one
    reader: several worker threads interleave shards as they arrive, in
    both packages), class labels included; a long clip truncated to
    max_len, or through the fusion stack."""
    root, wav, _, classes = shard_sets
    kw = {"max_len": 16000, "num_workers": 1, "class_index_dict": classes,
          **case}
    keys, got = _keys_and_batches(shards, wav, **kw)
    ref_keys, ref = _keys_and_batches(jax_shards, wav, **kw)
    assert keys == ref_keys and len(keys) >= 8
    _assert_batches_equal(got, ref)
    if case.get("train", True):
        assert all(len(b["__key__"]) == case["batch_size"] for b in got)
    else:  # eval keeps the tail and the shard order
        assert len(keys) == 20 and keys == sorted(keys)


def test_flac_shards_equal_jax_and_wav(shard_sets):
    """FLAC members (found without ``audio_ext``; lass_tpu reads them with
    ``audio_ext='flac'``) give lass_tpu's batches and the WAV shards'
    waveforms; the decode time is counted."""
    root, wav, fl, classes = shard_sets
    kw = dict(max_len=16000, num_workers=1, class_index_dict=classes,
              seed=2, batch_size=4)
    ds = shards.TarShardDataset(shards=[fl], **kw)
    got = list(ds)
    assert ds.decode_s > 0
    _, ref = _keys_and_batches(jax_shards, fl, audio_ext="flac", **kw)
    _assert_batches_equal(got, ref)
    assert got[0]["audio_name"][0].endswith(".flac")
    _, from_wav = _keys_and_batches(shards, wav, **kw)
    for g, w in zip(got, from_wav):
        assert g["__key__"] == w["__key__"]
        np.testing.assert_array_equal(g["waveform"], w["waveform"])


def test_bad_members_are_skipped(shard_sets):
    root, wav, _, _ = shard_sets
    bad = os.path.join(root, "bad.tar")
    kw = dict(max_len=16000, num_workers=1, seed=0, batch_size=2,
              train=False)
    keys, got = _keys_and_batches(shards, bad, **kw)
    ref_keys, _ = _keys_and_batches(jax_shards, bad, **kw)
    assert keys == ref_keys == []
    assert list(shards.iter_tar_samples(os.path.join(root, "none.tar"))) \
        == []
    ds = shards.TarShardDataset(shards=[wav], batch_size=3, num_workers=2)
    assert ds.num_batches() == jax_shards.TarShardDataset(
        shards=[wav], batch_size=3, num_workers=2).num_batches() == 8
    # two reader threads: the order depends on their timing, not the
    # count of full batches (20 samples, batches of 3)
    assert len(list(ds)) == len(list(jax_shards.TarShardDataset(
        shards=[wav], batch_size=3, num_workers=2))) == 6
