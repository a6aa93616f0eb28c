"""lass_torch.evaluation.metrics and make_snr_mixture vs lass_tpu's on the
same seeded numpy inputs. The NumPy functions are copies, so they must be
exactly equal; batch_sdr / batch_sisdr run on torch tensors against the
jnp versions, within 1e-5 dB (float32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.evaluation import dcase as jax_dcase
from lass_tpu.evaluation import metrics as jax_metrics
from lass_torch.evaluation import dcase, metrics
from torch_threads import torch_threads_per_worker  # noqa: F401


def _pair(rng, n=4000, noise=0.3):
    ref = rng.randn(n).astype(np.float32)
    return ref, ref + noise * rng.randn(n).astype(np.float32)


@pytest.mark.parametrize("name,call", [
    ("calculate_sdr", lambda m, r, e: m.calculate_sdr(r, e)),
    ("calculate_sisdr", lambda m, r, e: m.calculate_sisdr(r, e)),
    ("calculate_segmentwise_sdr",
     lambda m, r, e: m.calculate_segmentwise_sdr(r, e, 700, True)),
    ("remove_silence",
     lambda m, r, e: m.remove_silence(r * np.float32(0.02), 16000)),
    ("repeat_to_length", lambda m, r, e: m.repeat_to_length(r[:1500], 4000)),
    ("get_mean_sdr_from_dict", lambda m, r, e: m.get_mean_sdr_from_dict(
        {"a": float(r[0]), "b": float("nan"), "c": float(e[1])})),
])
def test_numpy_metrics_equal_jax(rng, name, call):
    ref, est = _pair(rng)
    got, want = call(metrics, ref, est), call(jax_metrics, ref, est)
    if isinstance(want, tuple):
        assert got[0] == want[0] and got[1] == want[1]
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("snr,scale", [(-5, 0.1), (0, 2.0), (5, 0.5)])
def test_make_snr_mixture_equals_jax(rng, snr, scale):
    """Quiet and loud sources (the loud ones are declipped to 0.9) and a
    noise of another length."""
    src = (scale * rng.randn(5000)).astype(np.float32)
    noise = (0.3 * rng.randn(4200)).astype(np.float32)
    for got, want in zip(dcase.make_snr_mixture(src, noise, snr),
                         jax_dcase.make_snr_mixture(src, noise, snr)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("noise", [0.01, 0.3, 3.0])
def test_batch_metrics_match_jax(rng, noise):
    ref = rng.randn(3, 8000).astype(np.float32)
    est = ref + noise * rng.randn(3, 8000).astype(np.float32)
    for fn in ("batch_sdr", "batch_sisdr"):
        got = getattr(metrics, fn)(torch.from_numpy(ref),
                                   torch.from_numpy(est)).numpy()
        want = np.asarray(getattr(jax_metrics, fn)(jnp.asarray(ref),
                                                   jnp.asarray(est)))
        assert got.shape == want.shape == (3,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        # and the host metric of each row
        host = [getattr(metrics, "calculate_sdr" if fn == "batch_sdr"
                        else "calculate_sisdr")(r, e)
                for r, e in zip(ref, est)]
        np.testing.assert_allclose(got, host, rtol=0, atol=1e-4)
