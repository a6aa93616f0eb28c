"""lass_torch DSP vs lass_tpu.dsp.stft at HIGHEST precision.

Tolerance: 1e-5 of the largest magnitude. Both sides compute in float32
(FFT on the port's side, exact-f32 DFT matmuls on the JAX side); their
rounding differs at the 1e-7 level relative to the peak.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_torch.dsp import stft as P
from torch_threads import torch_threads_per_worker  # noqa: F401

J = importlib.import_module("lass_tpu.dsp.stft")
HI = jax.lax.Precision.HIGHEST
TOL = 1e-5


def _close(got, ref):
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(np.asarray(got) - ref).max() <= TOL * scale


@pytest.mark.parametrize("length", [4000, 4321])
def test_stft_matches_jax(rng, length):
    x = rng.randn(2, 3, length).astype(np.float32)
    jr, ji = J.stft(jnp.asarray(x), precision=HI)
    pr, pi = P.stft(torch.from_numpy(x))
    assert pr.shape == jr.shape == (2, 3, J.STFTConfig().num_frames(length),
                                    513)
    _close(pr, jr)
    _close(pi, ji)


@pytest.mark.parametrize("truncated", [False, True])
def test_istft_matches_jax(rng, truncated):
    t, length = 26, 4000
    f = 512 if truncated else 513
    re = rng.randn(2, t, f).astype(np.float32)
    im = rng.randn(2, t, f).astype(np.float32)
    ref = J.istft(jnp.asarray(re), jnp.asarray(im), length, precision=HI,
                  truncated_nyquist=truncated)
    got = P.istft(torch.from_numpy(re), torch.from_numpy(im), length,
                  truncated_nyquist=truncated)
    assert got.shape == ref.shape == (2, length)
    _close(got, ref)


def test_stft_istft_round_trip(rng):
    x = rng.randn(1, 4800).astype(np.float32)
    re, im = P.stft(torch.from_numpy(x))
    back = P.istft(re, im, 4800)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


def test_magphase_matches_jax(rng):
    re = rng.randn(3, 5, 7).astype(np.float32)
    im = rng.randn(3, 5, 7).astype(np.float32)
    re[0, 0, 0] = im[0, 0, 0] = 0.0  # clamp path
    for got, ref in zip(P.magphase(torch.from_numpy(re), torch.from_numpy(im)),
                        J.magphase(jnp.asarray(re), jnp.asarray(im))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_wav_to_spectrogram_complex_layout(rng):
    x = rng.randn(2, 1, 3200).astype(np.float32)
    jr, ji = J.wav_to_spectrogram_complex(jnp.asarray(x), precision=HI)
    pr, pi = P.wav_to_spectrogram_complex(torch.from_numpy(x))
    assert pr.shape == jr.shape == (2, 21, 513, 1)
    _close(pr, jr)
    _close(pi, ji)


def test_spectrogram_to_wav_matches_jax(rng):
    """B=2, C=1, 0.32 s at 16 kHz: the mixture's magnitude scaled by a
    random positive factor per bin, rebuilt with the mixture's phase."""
    x = (0.1 * rng.randn(2, 1, 5120)).astype(np.float32)
    jr, ji = J.wav_to_spectrogram_complex(jnp.asarray(x), precision=HI)
    mag = np.sqrt(np.asarray(jr) ** 2 + np.asarray(ji) ** 2)
    spec = (mag * rng.uniform(0.2, 1.5, mag.shape)).astype(np.float32)
    ref = np.asarray(J.spectrogram_to_wav(jnp.asarray(x), jnp.asarray(spec),
                                          5120, precision=HI))
    got = P.spectrogram_to_wav(torch.from_numpy(x), torch.from_numpy(spec),
                               5120).numpy()
    assert got.shape == ref.shape == (2, 1, 5120)
    assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref)
