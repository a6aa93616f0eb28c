"""lass_torch's PANN towers (Cnn14 / Cnn10 / Cnn6) against lass_tpu's, on
the CPU: the eval forward of Cnn14 and Cnn10 at the JAX package's golden
config (16 kHz, n_fft 256, hop 160, 64 mels, B=2 x 1 s), Cnn6 in train
mode (batch statistics, spec-augment, dropout) plain and with 1D and 2D
fusion, the CLAP PANN encoder, and the port's own dropout.

Same weights: random values in the JAX package's variable tree, through
``lass_torch.convert.from_jax.pann_state_dict_from_jax``. Same draws: the
spec-augment stripes as in tests/test_torch_clap_pretrain.py, and flax's
``nn.Dropout`` and the port's ``dropout`` both monkeypatched to apply
masks drawn here with numpy, in call order (JAX's NHWC masks transposed
for the port's NCHW activations). Tolerance: rel err <= 1e-4 for every
output and every updated running statistic (the JAX package's float32
bound against the torch reference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.dsp.mel import LogMelConfig as JaxMelConfig
from lass_tpu.models.clap import pann as jax_pann
from lass_tpu.models.clap.model import (
    CLAPPANNAudioEncoder as JaxPANNEncoder)
from lass_torch.convert import from_jax
from lass_torch.dsp.mel import LogMelConfig
from lass_torch.models.clap import pann
from lass_torch.models.clap.model import CLAPPANNAudioEncoder
from lass_torch.nn.layers import dropout
from test_torch_clap_pretrain import draw, same_stripes
from test_torch_htsat import jax_variables, rel
from torch_threads import torch_threads_per_worker  # noqa: F401

REL = 1e-4
# tests/test_pann.py's golden config
MEL = dict(sample_rate=16000, n_fft=256, hop_length=160, n_mels=64)


def configs(model_name, fusion_type=None):
    fusion = dict(enable_fusion=True, fusion_type=fusion_type) \
        if fusion_type else {}
    return (pann.PANNConfig(model_name, mel=LogMelConfig(**MEL), **fusion),
            jax_pann.PANNConfig(model_name, mel=JaxMelConfig(**MEL),
                                **fusion))


def inputs(rng, fusion_type, b=2):
    if fusion_type:
        mel = (-40 + 15 * rng.randn(b, 4, 101, 64)).astype(np.float32)
        return dict(mel_fusion=mel, longer=np.array([True, False][:b]))
    t = np.arange(16000) / 16000.0
    return dict(waveform=(0.2 * np.sin(2 * np.pi * 440 * t)
                          + 0.1 * rng.randn(b, 16000)).astype(np.float32))


def build(model_name, fusion_type, rng):
    cfg, jcfg = configs(model_name, fusion_type)
    jmodel = jax_pann.PANN(jcfg)
    x = inputs(rng, fusion_type)
    variables = jax_variables(jmodel, rng, **{k: jnp.asarray(v)
                                              for k, v in x.items()})
    model = getattr(pann, model_name)(cfg)  # Cnn14 / Cnn10 / Cnn6
    assert model.cfg == cfg
    model.load_state_dict(from_jax.pann_state_dict_from_jax(variables))
    return jmodel, variables, model, x


class Masks:
    """Dropout masks drawn at flax's calls (NHWC) and replayed, in the
    same order, at the port's (NCHW)."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.drawn, self.replayed = [], 0

    def flax_dropout(self, rate, deterministic=False):
        def apply(x):
            if deterministic:
                return x
            keep = self.rng.rand(*x.shape) >= rate
            self.drawn.append(keep)
            return jnp.where(keep, x / (1.0 - rate), 0)
        return apply

    def port_dropout(self, x, p, generator=None):
        keep = self.drawn[self.replayed]
        self.replayed += 1
        if keep.ndim == 4:
            keep = keep.transpose(0, 3, 1, 2)
        return torch.where(torch.from_numpy(np.ascontiguousarray(keep)),
                           x / (1.0 - p), torch.zeros((), dtype=x.dtype))


@pytest.mark.parametrize("model_name", ["Cnn14", "Cnn10"])
def test_eval_forward_matches_jax(model_name, rng):
    jmodel, variables, model, x = build(model_name, None, rng)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x["waveform"]))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x["waveform"]))
    assert sorted(got) == sorted(ref)
    width = {"Cnn14": 2048, "Cnn10": 1024}[model_name]
    assert got["embedding"].shape == (2, width)
    assert got["fine_grained_embedding"].shape == ref[
        "fine_grained_embedding"].shape
    for key in ref:
        assert rel(got[key].numpy(), ref[key]) <= REL, key


@pytest.mark.parametrize("fusion_type", [None, "aff_1d", "iaff_2d"])
def test_cnn6_train_mode_matches_jax(fusion_type, rng, monkeypatch):
    jmodel, variables, model, x = build("Cnn6", fusion_type, rng)
    same_stripes(monkeypatch, draw(rng, 2, 101, 64))
    masks = Masks(11)
    monkeypatch.setattr(jax_pann.nn, "Dropout", masks.flax_dropout)
    monkeypatch.setattr(pann, "dropout", masks.port_dropout)
    ref, mutated = jax.jit(lambda v, kw: jmodel.apply(
        v, train=True, mutable=["batch_stats"],
        rngs={"specaug": jax.random.PRNGKey(0),
              "dropout": jax.random.PRNGKey(1)}, **kw))(
        variables, {k: jnp.asarray(v) for k, v in x.items()})
    with torch.no_grad():
        got = model.train()(**{k: torch.from_numpy(v) for k, v in x.items()})
    assert len(masks.drawn) == masks.replayed == 4 + 2
    for key in ref:
        assert rel(got[key].numpy(), ref[key]) <= REL, key
    stats = from_jax.pann_state_dict_from_jax(
        {"params": variables["params"], **mutated})
    running = [k for k in stats if "running_" in k]
    assert len(running) == 2 * (1 + 4) + {None: 0, "aff_1d": 2 + 8,
                                          "iaff_2d": 2 + 12}[fusion_type]
    own = model.state_dict()
    for key in running:
        assert rel(own[key].numpy(), stats[key].numpy()) <= REL, key


def test_clap_pann_encoder_matches_jax(rng):
    """CLAPPANNAudioEncoder (Cnn6 here): PANN embedding, projection, L2
    normalise; the converter's keys are the port's."""
    cfg, jcfg = configs("Cnn6")
    jenc = JaxPANNEncoder(pann_cfg=jcfg)
    x = inputs(rng, None)["waveform"]
    variables = jax_variables(jenc, rng, jnp.asarray(x))
    ref = jax.jit(jenc.apply)(variables, jnp.asarray(x))
    sd = from_jax.clap_pann_audio_state_dict_from_jax(variables)
    enc = CLAPPANNAudioEncoder(cfg)
    assert sorted(sd) == sorted(enc.state_dict())
    enc.load_state_dict(sd)
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(x))
    assert rel(got.numpy(), ref) <= REL
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_port_dropout_draws():
    """Keep rate about 1 - p, kept values scaled by 1 / (1 - p), one
    generator state one mask; the PANN's train-mode forward repeats from
    one CPU generator seed and not from another."""
    x = torch.ones(200, 100)
    a = dropout(x, 0.2, torch.Generator().manual_seed(3))
    b = dropout(x, 0.2, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1.25))
    model = pann.PANN(configs("Cnn6")[0]).train()
    wave = torch.from_numpy(inputs(np.random.RandomState(0), None)["waveform"])
    with torch.no_grad():
        outs = [model(wave, generator=torch.Generator().manual_seed(s))[
            "embedding"] for s in (4, 4, 5)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[2])
