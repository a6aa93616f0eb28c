"""lass_torch fused head (port of pallas_masking.apply_head_mask_folded):
the plain version against the JAX Pallas kernel in interpret mode and its
jnp oracle ``head_mask_reference``, on the logical layout (s=1, one and two
output channels) and around a fold-4 case; gradients to h, w and b; the
wrapper's error paths. The CUDA kernel is held against the plain version
on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py.

Tolerances are the JAX package's own (tests/test_pallas_masking.py): 1e-5
abs for values, rtol/atol 2e-4 for gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.ops.folded import fold_conv_kernel
from lass_tpu.ops.pallas_masking import (
    apply_head_mask_folded, head_mask_reference)
from lass_torch.ops import masking
from torch_threads import torch_threads_per_worker  # noqa: F401


def _inputs(rng, b=2, t=8, f=16, c=32, cout=1, t_pad=3):
    """h (B, T + t_pad, F, C) NHWC; after_conv (C, 3 * cout) + bias; the
    raw spectrum (B, T, F + 1) (the port crops the last bin)."""
    h = rng.randn(b, t + t_pad, f, c).astype(np.float32)
    w = (rng.randn(c, 3 * cout) * 0.1).astype(np.float32)
    bias = (rng.randn(3 * cout) * 0.1).astype(np.float32)
    re, im = (rng.randn(b, t, f + 1).astype(np.float32) for _ in range(2))
    return h, w, bias, re, im


def _port(h, w, bias, re, im, cout, requires_grad=False):
    th = torch.from_numpy(h).permute(0, 3, 1, 2)
    tw = torch.from_numpy(np.ascontiguousarray(w.T))[:, :, None, None]
    tb = torch.from_numpy(bias)
    if requires_grad:
        for t in (th, tw, tb):
            t.requires_grad_(True)
    out = masking.apply_head_mask(th, tw, tb, torch.from_numpy(re)[:, None],
                                  torch.from_numpy(im)[:, None], cout)
    return out, (th, tw, tb)


def _jax_args(h, w, bias, re, im, cout, s):
    """The JAX kernel's folded arguments (as resunet.py builds them)."""
    b, t, f = re.shape[0], re.shape[1], re.shape[2] - 1
    g = f // s
    w2d = fold_conv_kernel(jnp.asarray(w)[None, None], s)[0, 0]
    bt = jnp.tile(jnp.asarray(bias), s)
    hf = jnp.asarray(h[:, :t]).reshape(b, t, g, s * h.shape[-1])

    def spec(a):
        a = jnp.asarray(a[..., :f]).reshape(b, t, g, s)
        return jnp.repeat(a, cout, axis=-1) if cout > 1 else a

    return (hf, w2d[:, 0::3], w2d[:, 1::3], w2d[:, 2::3], bt[0::3],
            bt[1::3], bt[2::3], spec(re), spec(im))


def _unfold(a, cout):
    """JAX (B, T, G, s * cout) -> the port's (B * cout, T, F)."""
    b, t, g, m = a.shape
    s = m // cout
    a = np.asarray(a).reshape(b, t, g * s, cout)
    return np.moveaxis(a, -1, 1).reshape(b * cout, t, g * s)


@pytest.mark.parametrize("s,cout", [(1, 1), (1, 2), (4, 1)])
def test_head_plain_matches_pallas(rng, s, cout):
    args = _inputs(rng, cout=cout)
    (real, imag), _ = _port(*args, cout)
    assert real.shape == (2 * cout, 8, 16) and real.is_contiguous()
    jargs = _jax_args(*args, cout, s)
    kernel = apply_head_mask_folded(*jargs, True)
    oracle = head_mask_reference(*jargs)
    for ref in (kernel, oracle):
        np.testing.assert_allclose(real.numpy(), _unfold(ref[0], cout),
                                   atol=1e-5)
        np.testing.assert_allclose(imag.numpy(), _unfold(ref[1], cout),
                                   atol=1e-5)


def test_head_gradients_match_pallas(rng):
    args = _inputs(rng, b=1, t=5, f=8)
    (real, imag), (th, tw, tb) = _port(*args, 1, requires_grad=True)
    (real ** 2 + 0.5 * imag).sum().backward()

    jargs = _jax_args(*args, 1, 1)

    def loss(h, w, b):
        r, i = apply_head_mask_folded(h, w, *jargs[2:4], b, *jargs[5:], True)
        return jnp.sum(r ** 2 + 0.5 * i)

    gh, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(jargs[0], jargs[1],
                                                   jargs[4])
    t = jargs[0].shape[1]
    np.testing.assert_allclose(th.grad.permute(0, 2, 3, 1).numpy()[:, :t],
                               np.asarray(gh), rtol=2e-4, atol=2e-4)
    # rows of h past the spectrum's T get no gradient
    assert not th.grad[:, :, t:].any()
    np.testing.assert_allclose(tw.grad[0, :, 0, 0].numpy(),
                               np.asarray(gw)[:, 0], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tb.grad[0].numpy(), np.asarray(gb)[0],
                               rtol=2e-4, atol=2e-4)


def test_head_wrapper_errors(rng):
    h, w, bias, re, im = _inputs(rng, b=1)
    th = torch.from_numpy(h).permute(0, 3, 1, 2)
    tw = torch.from_numpy(np.ascontiguousarray(w.T))[:, :, None, None]
    tb = torch.from_numpy(bias)
    tre, tim = torch.from_numpy(re)[:, None], torch.from_numpy(im)[:, None]
    with pytest.raises(ValueError, match="weight"):
        masking.apply_head_mask(th, tw, tb, tre, tim, 2)
    with pytest.raises(ValueError, match="cover"):  # spectrum longer than h
        masking.apply_head_mask(th[:, :, :4], tw, tb, tre, tim, 1)
    with pytest.raises(ValueError, match="float32"):
        masking.apply_head_mask(th, tw, tb, tre.double(), tim.double(), 1)
