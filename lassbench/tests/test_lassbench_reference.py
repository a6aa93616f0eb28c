"""The plain reference agrees with the port at a tiny size on the CPU, in
float32: the separator (eval and train mode), the text tower and its
tokenizer, the audio tower with its resampling and log-mel, the mixer and
the host resampler."""
import numpy as np
import pytest
import torch

from lassbench import runners, signals
from lassbench.harness import Bench
from lassbench.reference import audio as ref_audio
from lassbench.reference import separator as ref_sep
from lassbench.reference import text as ref_text
from lassbench.reference import train as ref_train
from lassbench.tests.conftest import shrink


def rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def cfg():
    return shrink(Bench.load("sep_audio_b16")).config


@pytest.mark.parametrize("training", [False, True])
def test_separator(cfg, training):
    from lass_torch.models.resunet import ResUNet30

    torch.manual_seed(0)
    sd = runners.separator_state(cfg, 31, "cpu")
    model = ResUNet30(compute_dtype=torch.float32)
    model.load_state_dict(sd)
    model.train(training)
    gen = torch.Generator().manual_seed(1)
    mix = 0.1 * torch.randn(2, 1, 5120, generator=gen)
    cond = torch.nn.functional.normalize(torch.randn(2, 512, generator=gen))
    with torch.no_grad():
        got = model({"mixture": mix, "condition": cond})["waveform"]
        want = ref_sep.separate(sd, mix, cond, training=training)
    assert rel(got, want) < 1e-4


def test_text_tower(cfg):
    from lass_torch.models.clap.tokenizer import WhitespaceFallbackTokenizer

    caps = ["a dog barking in the distance", "rain on a tin roof x1"]
    port = WhitespaceFallbackTokenizer(cfg["text"]["vocab_size"])(
        caps, pad_to=cfg["text"]["pad_to"])
    ids, mask = ref_text.tokenize(caps, cfg["text"]["vocab_size"],
                                  cfg["text"]["pad_to"])
    np.testing.assert_array_equal(port["input_ids"], ids)
    np.testing.assert_array_equal(port["attention_mask"], mask)
    enc = runners.query_encoder({k: v for k, v in cfg.items()
                                 if k != "audio"}, 41, "cpu")
    got = enc.get_query_embed("text", text=caps)
    want = ref_text.embed_captions(runners.text_state(cfg, 41, "cpu"),
                                   cfg["text"], caps, "cpu")
    assert float((got - want).norm(dim=-1).max()) < 1e-5


def test_audio_tower(cfg):
    enc = runners.query_encoder(cfg, 43, "cpu")
    rng = np.random.default_rng(0)
    clips = signals.clip_pool(rng, 2, cfg["audio"]["clip_seconds"], 16000)
    got = enc.get_query_embed("audio", audio=clips)
    tower = ref_audio.build(cfg["audio"], runners.audio_state(cfg, 43, "cpu"),
                            "cpu")
    with torch.no_grad():
        want = tower(torch.from_numpy(clips), 16000)
    assert float((got - want).norm(dim=-1).max()) < 1e-4


def test_mixer():
    from lass_torch.data.mixer import SegmentMixer

    gen = torch.Generator().manual_seed(3)
    x = 0.2 * torch.randn(5, 1, 800, generator=gen)
    x[2] *= 8  # a row whose mixture clips
    draws = ref_train.mixer_draws(torch.Generator().manual_seed(9), 5, 3,
                                  -10, 10)
    port = SegmentMixer(3, -10, 10).draw(5, torch.Generator().manual_seed(9))
    for a, b in zip(draws, port):
        assert torch.equal(a, b)
    got = SegmentMixer(3, -10, 10).mix(x, *port)
    want = ref_train.mix(x, *draws)
    for a, b in zip(got, want):
        assert rel(a, b) < 1e-6


def test_host_resampler():
    from lass_torch.audio.resample import resample_np

    x = np.random.default_rng(1).standard_normal(3217).astype(np.float32)
    np.testing.assert_allclose(signals.resample_np(x, 32000, 16000),
                               resample_np(x, 32000, 16000), atol=1e-6)
