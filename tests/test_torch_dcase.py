"""lass_torch's DCASE evaluator vs lass_tpu's on a made-up CSV and wav set
(3 rows of 1 s at batch 2, so the last batch is ragged), through the same
seeded separator weights (converted to the JAX layout) and the same
captions' embeddings; the evaluator's int8 protocol; the two CLIs.

Tolerances: SI-SDR, SDRi and SDR within 1e-3 dB of the JAX evaluator's
(float32 forwards that agree to about 4e-6 move a dB value by about
2e-5); int8 (calibrate, then pack) within 0.1 dB of float on every
metric, the JAX package's own gate (tests/test_dcase.py)."""
import csv
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.convert.torch_to_jax import convert_resunet30
from lass_tpu.evaluation.dcase import (
    DCASEEvaluator as JaxEvaluator, SeparationInference as JaxInference)
from lass_tpu.models.film import resunet30_film_spec as jax_film_spec
from lass_tpu.models.resunet import ResUNet30 as JaxResUNet30
from lass_torch import dcase_evaluator, separate
from lass_torch.audio import io as port_io
from lass_torch.convert.checkpoint_io import save_ss_checkpoint, unpack_film
from lass_torch.evaluation.dcase import DCASEEvaluator, SeparationInference
from lass_torch.models import query_encoder
from lass_torch.models.clap.roberta import RobertaConfig
from lass_torch.models.clap.tokenizer import WhitespaceFallbackTokenizer
from lass_torch.models.resunet import ResUNet30
from torch_threads import torch_threads_per_worker  # noqa: F401

CLAPQueryEncoder = query_encoder.CLAPQueryEncoder


class CaptionEmbeddings:
    """A query encoder stub: a seeded (512,) vector per caption, as numpy,
    which both packages' evaluators take."""

    def get_query_embed(self, modality, text=None, **kwargs):
        assert modality == "text"
        return np.stack([np.random.RandomState(zlib.crc32(t.encode())).randn(
            512).astype(np.float32) for t in text])


class Identity(CaptionEmbeddings):
    """Separation == mixture, so SDRi must be 0; records batch shapes."""

    def __init__(self):
        self.query_encoder = self
        self.shapes = []

    def separate(self, mixtures, conditions):
        self.shapes.append((mixtures.shape, np.asarray(conditions).shape))
        return mixtures


@pytest.fixture(scope="module")
def eval_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.RandomState(3)
    t = np.arange(16000, dtype=np.float32) / 16000
    with open(root / "eval.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["source", "noise", "snr", "caption"])
        for i, snr in enumerate((-5, 0, 5)):
            tone = 0.3 * np.sin(2 * np.pi * (300 + 200 * i) * t)
            port_io.write_wav(str(root / f"src{i}.wav"), tone[None], 16000)
            port_io.write_wav(str(root / f"noise{i}.wav"),
                              0.2 * rng.randn(1, 16000).astype(np.float32),
                              16000)
            w.writerow([f"src{i}", f"noise{i}", str(snr), f"tone {i}"])
    return str(root / "eval.csv"), str(root)


def _seeded_separator(quantize=False):
    torch.manual_seed(0)
    model = ResUNet30(quantize=quantize)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.3, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
                mod.bias.normal_(0, 0.1, generator=gen)
        model.film.bias.normal_(0, 0.1, generator=gen)
    return model


def _port_run(eval_set, quantize=False):
    evaluator = DCASEEvaluator(16000, *eval_set, batch_size=2,
                               pad_seconds=1.0)
    sep = SeparationInference(_seeded_separator(quantize),
                              CaptionEmbeddings(), device="cpu")
    if quantize:
        evaluator.calibrate(sep)
    return evaluator(sep)


@pytest.fixture(scope="module")
def port_float(eval_set):
    return _port_run(eval_set)


def test_evaluator_matches_jax(eval_set, port_float):
    variables = convert_resunet30(
        {k: v.numpy() for k, v in unpack_film(
            _seeded_separator().state_dict()).items()}, jax_film_spec())
    model = JaxResUNet30(freq_fold=1, dsp_precision=jax.lax.Precision.HIGHEST)
    ref = JaxEvaluator(16000, *eval_set, batch_size=2, pad_seconds=1.0)(
        JaxInference(model, jax.tree_util.tree_map(jnp.asarray, variables),
                     CaptionEmbeddings()))
    print(f"(SI-SDR, SDRi, SDR): port {port_float}, JAX {ref}")
    np.testing.assert_allclose(port_float, ref, rtol=0, atol=1e-3)


def test_identity_gives_zero_sdri_at_one_shape(eval_set):
    stub = Identity()
    evaluator = DCASEEvaluator(16000, *eval_set, batch_size=2,
                               pad_seconds=0.5)
    sisdr, sdri, sdr = evaluator(stub)
    np.testing.assert_allclose(sdri, 0.0, atol=1e-5)
    assert np.isfinite(sisdr) and np.isfinite(sdr)
    # 1 s clips bump the 0.5 s pad once, hop-rounded; the ragged last
    # batch is padded to the batch size
    assert stub.shapes == [((2, 1, 16000), (2, 512))] * 2
    assert set(evaluator.timing) == {"load_s", "separate_s", "metrics_s"}


def test_int8_within_a_tenth_of_a_db_of_float(eval_set, port_float):
    q = _port_run(eval_set, quantize=True)
    print(f"(SI-SDR, SDRi, SDR): float {port_float}, int8 {q}")
    assert np.all(np.abs(np.subtract(q, port_float)) < 0.1)


def _small_query_encoder(device="cpu", **kwargs):
    cfg = RobertaConfig(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128)
    return CLAPQueryEncoder(
        roberta_cfg=cfg, device=device,
        tokenizer=WhitespaceFallbackTokenizer(1000))


def test_evaluator_cli_takes_dsp_precision(tmp_path, monkeypatch):
    """The root CLI's --dsp_precision (its choices), set on the config the
    separator is built from; parser and config only, no model run."""
    from lass_torch.convert import checkpoint_io
    from lass_torch.evaluation import dcase

    class Stop(Exception):
        pass

    def load_ss_model(cfg, *args, **kwargs):
        raise Stop(cfg.model.dsp_precision)

    monkeypatch.setattr(checkpoint_io, "load_ss_model", load_ss_model)
    monkeypatch.setattr(dcase, "DCASEEvaluator",
                        lambda **kwargs: types.SimpleNamespace(
                            data_parallel=False))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("task_name: AudioSep\n")
    argv = ["--checkpoint_path", "x.ckpt", "--config_yaml", str(cfg),
            "--device", "cpu"]
    for value in ("default", "high", "highest"):
        with pytest.raises(Stop, match=f"^{value}$"):
            dcase_evaluator.main(argv + ["--dsp_precision", value])
    with pytest.raises(Stop, match="^high$"):  # the config's default
        dcase_evaluator.main(argv)
    with pytest.raises(SystemExit):
        dcase_evaluator.main(argv + ["--dsp_precision", "low"])


def test_clis_on_cpu(eval_set, tmp_path, monkeypatch, capsys):
    """python -m lass_torch.dcase_evaluator and python -m
    lass_torch.separate --chunked --quantize --config A, in-process, with a
    small caption encoder in place of the full-width one. The evaluator
    scores the set's first row at batch 1: the CLI pads every clip to 10 s,
    so each row costs a 10 s forward on the CPU (the batching and the
    ragged last batch: test_evaluator_matches_jax)."""
    monkeypatch.setattr(query_encoder, "CLAPQueryEncoder",
                        _small_query_encoder)
    ckpt = str(tmp_path / "sep.ckpt")
    save_ss_checkpoint(_seeded_separator(), ckpt)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("task_name: AudioSep\ndata:\n    sampling_rate: 16000\n"
                   "    segment_seconds: 1\nmodel:\n    compute_dtype: "
                   "float32\n")
    csv_path, audio_dir = eval_set
    one_row = tmp_path / "one_row.csv"
    with open(csv_path) as f:
        one_row.write_text("".join(f.readlines()[:2]))
    sisdr, sdri, sdr = dcase_evaluator.main([
        "--checkpoint_path", ckpt, "--config_yaml", str(cfg),
        "--eval_indexes", str(one_row), "--audio_dir", audio_dir,
        "--batch_size", "1", "--device", "cpu"])
    assert np.isfinite([sisdr, sdri, sdr]).all()
    assert "SDR: " in capsys.readouterr().out

    mix = tmp_path / "mix.wav"
    port_io.write_wav(str(mix), 0.1 * np.random.RandomState(2).randn(
        1, 12000).astype(np.float32), 16000)
    out = tmp_path / "sep.wav"
    separate.main(["--checkpoint_path", ckpt, "--input", str(mix),
                   "--query", "a tone", "--output", str(out),
                   "--config_yaml", str(cfg), "--device", "cpu",
                   "--chunked", "--quantize", "--config", "A"])
    audio, sr = port_io.read_wav(str(out))
    assert sr == 16000 and audio.shape == (1, 12000)
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0
