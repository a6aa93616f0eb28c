"""lass_torch's six-input mask apply (B2, the port of
lass_tpu/ops/pallas_masking.py::apply_complex_mask) against the Pallas
kernel in interpret mode, its gradient against the JAX custom_vjp, and the
wrapper's rules on the CPU. The CUDA mode of lass_torch/csrc/masking.cu is
held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.

Tolerances: values 1e-6 abs (the bound tests/test_pallas_masking.py uses
for the Pallas kernel against its formula), gradients 1e-5 abs (same).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.ops.pallas_masking import apply_complex_mask as jax_mask
from lass_torch.ops import masking
from torch_threads import torch_threads_per_worker  # noqa: F401


def _inputs(rng, shape):
    """Logits, and a mixture's mag (positive), cos and sin."""
    logits = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    re, im = rng.randn(2, *shape).astype(np.float32)
    mag = np.sqrt(np.maximum(re * re + im * im, 1e-10)).astype(np.float32)
    return logits + [mag, re / mag, im / mag]


@pytest.mark.parametrize("shape", [(2, 7, 513), (3, 37, 257), (1, 300, 512)])
def test_plain_matches_pallas_kernel(rng, shape):
    args = _inputs(rng, shape)
    ref = jax_mask(*map(jnp.asarray, args), interpret=True)
    got = masking.apply_complex_mask(*map(torch.from_numpy, args))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def test_gradient_matches_jax_custom_vjp(rng):
    args = _inputs(rng, (2, 5, 64))
    w_re, w_im = rng.randn(2, 2, 5, 64).astype(np.float32)

    def jax_loss(*a):
        r, i = jax_mask(*a, interpret=True)
        return jnp.sum(r * w_re) + jnp.sum(i * w_im)

    ref = jax.grad(jax_loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, args))
    tens = [torch.from_numpy(a).requires_grad_(True) for a in args]
    r, i = masking.apply_complex_mask(*tens)
    ((r * torch.from_numpy(w_re)).sum()
     + (i * torch.from_numpy(w_im)).sum()).backward()
    for t, g in zip(tens, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5)


def test_b1_is_b2_after_the_mixture_terms(rng):
    """The two plain versions share one chain: B1 on (re, im) equals B2 on
    the mag/cos/sin it derives."""
    l0, l1, l2, re, im = [torch.from_numpy(rng.randn(2, 9, 33).astype(
        np.float32)) for _ in range(5)]
    mag = torch.sqrt(torch.clamp(re * re + im * im, min=1e-10))
    for a, b in zip(masking.mask_math_from_ri(l0, l1, l2, re, im),
                    masking.apply_complex_mask(l0, l1, l2, mag, re / mag,
                                               im / mag)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_rules_on_cpu(rng):
    args = [torch.from_numpy(a) for a in _inputs(rng, (2, 6, 16))]
    before = masking.B2_LAUNCHES
    masking.apply_complex_mask(*args)
    assert masking.B2_LAUNCHES == before  # the CPU path launches nothing
    strided = torch.zeros(2, 6, 32)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        masking.apply_complex_mask(*args[:5], strided)
    with pytest.raises(TypeError, match="float32"):
        masking.apply_complex_mask(*args[:5], args[5].double())
    with pytest.raises(ValueError, match="shape"):
        masking.apply_complex_mask(*args[:5], args[5][:, :3])
