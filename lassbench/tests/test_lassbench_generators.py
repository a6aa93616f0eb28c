"""Every generator is a function of the seed: the traffic, the captions,
the corpus, the weights and the training rows."""
import numpy as np
import torch

from lassbench import signals, weights
from lassbench.runners.separate import Traffic
from lassbench.harness import Bench
from lassbench.reference import separator, train
from lassbench.tests.conftest import shrink


def _traffic(workload, seed):
    bench = shrink(Bench.load(workload))
    return Traffic(bench.config, bench.traffic, seed)


def test_separation_traffic_follows_the_seed():
    for workload in ("sep_text_b16", "sep_audio_b16"):
        a, b = _traffic(workload, 2 ** 31 + 7), _traffic(workload, 2 ** 31 + 7)
        c = _traffic(workload, 2 ** 31 + 8)
        for i in range(4):
            (ma, qa), (mb, qb), (mc, _) = a.batch(i), b.batch(i), c.batch(i)
            np.testing.assert_array_equal(ma, mb)
            assert np.array_equal(np.asarray(qa), np.asarray(qb))
            assert not np.array_equal(ma, mc)


def test_captions_never_repeat():
    t = _traffic("sep_text_b16", 11)
    seen = [c for i in range(600) for c in t.captions(i)]
    assert len(set(seen)) == len(seen)


def test_same_sizes_whatever_the_seed():
    a, b = _traffic("sep_text_b16", 1), _traffic("sep_text_b16", 99)
    assert a.mixtures.shape == b.mixtures.shape


def test_weights_follow_the_seed():
    shapes = separator.param_shapes()[:12]
    a = weights.seeded_state(shapes, 5, "separator", "cpu")
    b = weights.seeded_state(shapes, 5, "separator", "cpu")
    c = weights.seeded_state(shapes, 6, "separator", "cpu")
    assert list(a) == [k for k, _ in shapes]
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["film.weight"], c["film.weight"])
    var = a["base.bn0.running_var"]
    assert float(var.min()) >= 0.5 and float(var.max()) <= 1.5


def test_corpus_and_rows_follow_the_seed(tmp_path):
    args = (4, 16000, 0.6, 1.0, 0.5, 32000, 3)
    d1 = signals.write_corpus(str(tmp_path / "a"), *args)
    d2 = signals.write_corpus(str(tmp_path / "b"), *args)
    e1, e2 = signals.corpus_entries(d1), signals.corpus_entries(d2)
    assert [e["caption"] for e in e1] == [e["caption"] for e in e2]
    w1, c1 = train.batch_rows(e1, 77, 0, 2, 16000, 0.5)
    w2, c2 = train.batch_rows(e2, 77, 0, 2, 16000, 0.5)
    np.testing.assert_array_equal(w1, w2)
    assert c1 == c2 and w1.shape == (2, 1, 8000)
    w3, _ = train.batch_rows(e1, 78, 0, 2, 16000, 0.5)
    assert not np.array_equal(w1, w3)


def test_wav_round_trip(tmp_path):
    x = (np.random.default_rng(0).standard_normal(1000) * 0.1).astype(
        np.float32)
    signals.write_wav_pcm16(str(tmp_path / "x.wav"), x, 32000)
    y, rate = signals.read_wav_pcm16(str(tmp_path / "x.wav"))
    assert rate == 32000 and np.max(np.abs(y - x)) < 1e-4
