"""lass_torch's log-mel front end and device resampler against lass_tpu's,
on the CPU.

Tolerances: log-mel within 1e-3 dB (JAX computes the power spectrum by a
HIGHEST-precision DFT matmul, the port by an FFT: float32 power errors of
~1e-6 relative, ~1e-5 dB); the numpy host paths are the same float64 code
and must be equal; the resampler within 1e-5 relative (one float32 conv
on each side).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.audio.resample import resample as jax_resample
from lass_tpu.dsp import mel as jax_mel
from lass_torch.audio.resample import resample, resample_np
from lass_torch.dsp import mel
from torch_threads import torch_threads_per_worker  # noqa: F401

# the HTSAT-base front end, the tests' TINY HTSAT's, and one with top_db
CONFIGS = {
    "base": {},
    "tiny": dict(n_fft=256, n_mels=32),
    "top_db": dict(n_fft=512, n_mels=48, fmax=None, top_db=80.0),
}


def _cfgs(name):
    return (mel.LogMelConfig(**CONFIGS[name]),
            jax_mel.LogMelConfig(**CONFIGS[name]))


def _clip(rng, n=2, length=48000):
    t = np.arange(length) / 48000.0
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t)
    return (tone + 0.05 * rng.randn(n, length)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_filterbank_equals_jax(name):
    cfg, jcfg = _cfgs(name)
    ref = jax_mel.mel_filterbank(jcfg.sample_rate, jcfg.n_fft, jcfg.n_mels,
                                 jcfg.fmin, jcfg.fmax)
    np.testing.assert_array_equal(cfg.filterbank(), ref)
    np.testing.assert_array_equal(mel.hz_to_mel(np.array([30.0, 4000.0])),
                                  jax_mel.hz_to_mel(np.array([30.0, 4000.0])))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_log_mel_matches_jax(name, rng):
    cfg, jcfg = _cfgs(name)
    x = _clip(rng)
    got = mel.log_mel_spectrogram(torch.from_numpy(x), cfg).numpy()
    ref = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(x), jcfg))
    assert got.shape == ref.shape == (2, 101, cfg.n_mels)
    assert np.abs(got - ref).max() <= 1e-3
    # silence sits at the amin floor
    silence = mel.log_mel_spectrogram(torch.zeros(1, 4800), cfg)
    torch.testing.assert_close(silence, torch.full_like(silence, -100.0))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_log_mel_np_equals_jax(name, rng):
    cfg, jcfg = _cfgs(name)
    x = _clip(rng, 1, 30011)[0]
    np.testing.assert_array_equal(mel.log_mel_spectrogram_np(x, cfg),
                                  jax_mel.log_mel_spectrogram_np(x, jcfg))


@pytest.mark.parametrize("orig", [16000, 32000])
def test_device_resample_matches_jax(orig, rng):
    x = (0.1 * rng.randn(2, 1, orig // 2 + 7)).astype(np.float32)
    got = resample(torch.from_numpy(x), orig, 48000).numpy()
    ref = np.asarray(jax_resample(jnp.asarray(x), orig, 48000))
    host = resample_np(x, orig, 48000)
    assert got.shape == ref.shape == host.shape == (
        2, 1, -(-x.shape[-1] * 3 * 16000 // orig))
    for other in (ref, host):
        assert np.linalg.norm(got - other) <= 1e-5 * np.linalg.norm(other)
    same = torch.from_numpy(x)
    assert resample(same, orig, orig) is same
