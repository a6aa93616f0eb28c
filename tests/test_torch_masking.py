"""lass_torch mask apply vs the JAX Pallas kernel (interpret mode) and its
formula, plus the wrapper's dispatch rules. The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_kernels_cuda.py
and chip_smoke.py.

Tolerances: values 1e-6 abs (the bound tests/test_pallas_masking.py uses
for the Pallas kernel against its formula), gradients 1e-5 abs (same).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.models.resunet import (
    apply_mask_and_reconstruct as jax_mask_and_reconstruct)
from lass_tpu.ops.pallas_masking import (
    _mask_math_from_ri, apply_complex_mask_ri as jax_mask_ri)
from lass_torch.dsp.stft import STFTConfig
from lass_torch.models.resunet import apply_mask_and_reconstruct
from lass_torch.ops import masking
from torch_threads import torch_threads_per_worker  # noqa: F401

JAX_STFT = importlib.import_module("lass_tpu.dsp.stft")


def _inputs(rng, shape):
    return [rng.randn(*shape).astype(np.float32) for _ in range(5)]


@pytest.mark.parametrize("shape", [(2, 7, 513), (3, 37, 257), (1, 300, 512)])
def test_plain_matches_pallas_kernel(rng, shape):
    """Includes M = N*T not a multiple of the Pallas 256-row block and an
    odd F."""
    args = _inputs(rng, shape)
    got = masking.mask_math_from_ri(*map(torch.from_numpy, args))
    ref_kernel = jax_mask_ri(*map(jnp.asarray, args), interpret=True)
    ref_formula = _mask_math_from_ri(*map(jnp.asarray, args))
    for g, rk, rf in zip(got, ref_kernel, ref_formula):
        np.testing.assert_allclose(g.numpy(), np.asarray(rk), atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(rf), atol=1e-6)


def _jax_grads(args):
    def loss(*a):
        r, i = jax_mask_ri(*a, interpret=True)
        return jnp.sum(r ** 2 + i * 0.5)

    return jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, args))


def _torch_grads(fn, args):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    r, i = fn(*ts)
    (r ** 2 + i * 0.5).sum().backward()
    return [t.grad.numpy() for t in ts]


def test_gradients_match_jax(rng):
    args = _inputs(rng, (1, 3, 130))
    for g, r in zip(_torch_grads(masking.apply_complex_mask_ri, args),
                    _jax_grads(args)):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5)


def test_autograd_function_backward_recomputes(rng, monkeypatch):
    """The CUDA path's autograd.Function, with its launch swapped for the
    plain version so that its backward runs here."""
    monkeypatch.setattr(masking, "_launch",
                        lambda a: masking.mask_math_from_ri(*a))
    args = _inputs(rng, (2, 3, 64))
    for g, r in zip(_torch_grads(masking._MaskRI.apply, args),
                    _jax_grads(args)):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5)


def test_cpu_call_takes_plain_version(rng, monkeypatch):
    def no_launch(_):
        raise AssertionError("CPU tensors must not reach the kernel")

    monkeypatch.setattr(masking, "_launch", no_launch)
    before = masking.LAUNCHES
    args = [torch.from_numpy(a) for a in _inputs(rng, (2, 5, 16))]
    got = masking.apply_complex_mask_ri(*args)
    ref = masking.mask_math_from_ri(*args)
    assert masking.LAUNCHES == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_wrapper_rejects_what_the_kernel_cannot_take(rng):
    args = [torch.from_numpy(a) for a in _inputs(rng, (2, 5, 16))]
    with pytest.raises(TypeError):
        masking.apply_complex_mask_ri(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        masking.apply_complex_mask_ri(args[0][:, :4], *args[1:])
    with pytest.raises(ValueError):
        masking.apply_complex_mask_ri(args[0].transpose(1, 2).contiguous()
                                      .transpose(1, 2), *args[1:])
    with pytest.raises(ValueError):
        masking.apply_complex_mask_ri(args[0][None], *args[1:])


def test_mask_and_reconstruct_matches_jax(rng):
    """The model-level wrapper: logits as channel slices of the UNet output
    cropped in time, spectrum cropped 513 -> 512 bins, truncated ISTFT."""
    b, t, t_pad, length = 2, 21, 32, 3200
    logits = rng.randn(b, 3, t_pad, 512).astype(np.float32)
    re = rng.randn(b, 1, t, 513).astype(np.float32)
    im = rng.randn(b, 1, t, 513).astype(np.float32)
    got = apply_mask_and_reconstruct(
        torch.from_numpy(logits)[:, :, :t], torch.from_numpy(re),
        torch.from_numpy(im), length, STFTConfig(), 1)
    ref = jax_mask_and_reconstruct(
        jnp.asarray(logits.transpose(0, 2, 3, 1)[:, :t]),
        jnp.asarray(re.transpose(0, 2, 3, 1)),
        jnp.asarray(im.transpose(0, 2, 3, 1)), length,
        JAX_STFT.STFTConfig(), 1, precision=jax.lax.Precision.HIGHEST)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (b, 1, length)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
