"""lass_torch fused act+convT (port of pallas_convt): the plain version
against the JAX Pallas kernel in interpret mode and against the JAX
package's unfused path (bn affine + FiLM beta + leaky + folded_convT_2x2),
at fold_in 1 (the logical layout, decoder_block5) and fold_in 2 folded
around the JAX call (decoder_block6); the port's weight mapping is the
converter's (lass_torch.convert.from_jax), held against the JAX kernel's
``w_pair``. In bf16, the activation chain's rounding points against the
JAX kernel's, bit for bit. Plus the wrapper's error paths. The CUDA kernel is held against
the plain version on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py.

Tolerance: 2e-5 abs, the JAX package's own bound for its kernel
(tests/test_pallas_convt.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.nn.layers import leaky_relu as jax_leaky
from lass_tpu.ops.folded import (
    _convT_fold_embedding, fold_feature_map, fold_freq, folded_convT_2x2,
    unfold_freq)
from lass_tpu.ops.pallas_convt import fused_act_convT as jax_convT
from lass_torch.convert.from_jax import _conv_w
from lass_torch.ops import _common, convt
from torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("s_in,cin,cout,t,f", [(1, 32, 16, 6, 8),
                                               (2, 16, 8, 8, 16)])
def test_convt_plain_matches_pallas(rng, s_in, cin, cout, t, f):
    b = 2
    x = rng.randn(b, t, f, cin).astype(np.float32)
    inv = (rng.randn(cin) * 0.5).astype(np.float32)
    shift = (rng.randn(cin) * 0.1).astype(np.float32)
    beta = (rng.randn(b, cin) * 0.1).astype(np.float32)
    wt = (rng.randn(2, 2, cout, cin) * 0.1).astype(np.float32)  # JAX layout

    got = convt.fused_act_convT(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(inv),
        torch.from_numpy(shift), torch.from_numpy(beta), _conv_w(wt))
    assert got.shape == (b, cout, 2 * t, 2 * f)
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).numpy()

    # the JAX kernel's weight pair, built as FoldedDecoderBlockRes1B does
    fm = fold_feature_map(s_in, [cin])
    xf = fold_freq(jnp.asarray(x), s_in)
    e = jnp.asarray(_convT_fold_embedding(s_in))
    kern = jnp.einsum("rjq,kjoc->krcqo", e, jnp.asarray(wt)[::-1])
    w_pair = kern.reshape(2, s_in * cin, 2 * s_in * cout)[::-1]
    kernel = jax_convT(xf, jnp.asarray(inv[fm]), jnp.asarray(shift[fm]),
                       jnp.asarray(beta[:, fm]), w_pair, interpret=True)
    z = jax_leaky(xf * inv[fm] + shift[fm] + beta[:, fm][:, None, None, :])
    unfused = folded_convT_2x2(z, jnp.asarray(wt), s_in)
    for ref in (kernel, unfused):
        np.testing.assert_allclose(
            got, np.asarray(unfold_freq(ref, 2 * s_in)), atol=2e-5)


def test_convt_plain_bf16_activation_matches_pallas(rng):
    """bf16 rounding points of the activation chain, slope bf16(0.01)
    included: with identity weights every output is z itself, so the
    plain version and the JAX kernel agree bit for bit."""
    b, t, f, c = 2, 8, 16, 32
    bf16 = lambda a: np.array(  # noqa: E731
        jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    x = bf16(rng.randn(b, t, f, c) * 3)
    inv = bf16(rng.randn(c) * 0.5 + 1)
    shift = bf16(rng.randn(c) * 0.1)
    beta = bf16(rng.randn(b, c) * 0.1)
    wt = np.zeros((2, 2, c, c), np.float32)
    wt[:, :, np.arange(c), np.arange(c)] = 1.0

    got = convt.fused_act_convT(
        torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16),
        torch.from_numpy(inv), torch.from_numpy(shift),
        torch.from_numpy(beta), _conv_w(wt))
    e = jnp.asarray(_convT_fold_embedding(1))
    w_pair = jnp.einsum("rjq,kjoc->krcqo", e, jnp.asarray(wt)[::-1]
                        ).reshape(2, c, 2 * c)[::-1]
    ref = jax_convT(jnp.asarray(x, jnp.bfloat16), jnp.asarray(inv),
                    jnp.asarray(shift), jnp.asarray(beta), w_pair,
                    interpret=True)
    ref = np.asarray(unfold_freq(ref.astype(jnp.float32), 2))
    assert (ref < 0).any()  # the leaky branch is exercised
    np.testing.assert_array_equal(
        got.float().permute(0, 2, 3, 1).numpy(), ref)


def test_convt_wrapper_errors(rng):
    x = torch.from_numpy(rng.randn(1, 4, 4, 8).astype(np.float32)
                         ).permute(0, 3, 1, 2)
    vec, beta, w = torch.ones(8), torch.zeros(1, 8), torch.zeros(8, 4, 2, 2)
    with pytest.raises(ValueError, match="weight"):
        convt.fused_act_convT(x, vec, vec, beta, torch.zeros(8, 4, 3, 3))
    with pytest.raises(ValueError, match="beta"):
        convt.fused_act_convT(x, vec, vec, torch.zeros(2, 8), w)
    with pytest.raises(ValueError, match="channels_last"):
        convt.fused_act_convT(x.contiguous(), vec, vec, beta, w)
    with pytest.raises(RuntimeError, match="no backward"):
        convt.fused_act_convT(x, vec, vec, beta, w.requires_grad_(True))
    with torch.no_grad():  # the same call is fine without grad
        assert convt.fused_act_convT(x, vec, vec, beta, w).shape == (
            1, 4, 8, 8)


def test_convt_phase_weights_round_trip(rng):
    """The kernel's two per-phase operands: phase i is C_in x 2 C_out with
    column j * C_out + o, so its product with a tile is one contiguous run
    of output row 2t + i; packed by pack_b and unpacked exactly."""
    cin, cout = 128, 64
    w = torch.from_numpy(rng.randn(cin, cout, 2, 2).astype(np.float32))
    ph = convt.phase_weights(w)
    assert ph.shape == (2, cin, 2 * cout)
    for i in range(2):
        for j in range(2):
            assert torch.equal(ph[i, :, j * cout:(j + 1) * cout],
                               w[:, :, i, j])
    packed = _common.pack_b(ph.to(torch.bfloat16))
    taps, kk, nb = packed.shape[:3]
    back = packed.permute(0, 1, 3, 5, 2, 4).reshape(taps, 16 * kk, 8 * nb)
    assert torch.equal(back, ph.to(torch.bfloat16))


def test_convt_kernel_refuses_what_it_does_not_take(rng):
    """The checks of the CUDA path, which run before the kernel is built:
    widths outside C_in {64, 128} x C_out {32, 64}, float32 activations,
    rows off 16 bytes."""
    def call(x, cout):
        cin = x.shape[1]
        return convt._launch(x, torch.ones(cin), torch.zeros(cin),
                             torch.zeros(x.shape[0], cin),
                             torch.zeros(cin, cout, 2, 2))

    def act(c):
        return torch.from_numpy(rng.randn(1, c, 3, 5).astype(
            np.float32)).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)

    with pytest.raises(ValueError, match="C_in in"):
        call(act(32), 32)
    with pytest.raises(ValueError, match="C_out in"):
        call(act(64), 16)
    with pytest.raises(TypeError, match="bfloat16"):
        call(act(64).float(), 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(act(72)[:, 1:65], 32)


@pytest.mark.parametrize("t,f", [(1, 7), (3, 5)])
def test_convt_plain_matches_pallas_at_schedule_edges(rng, t, f):
    """T = 1 and 3 and F off the kernel's 64-position tile, on the logical
    layout (fold 1)."""
    b, cin, cout = 2, 16, 8
    x = rng.randn(b, t, f, cin).astype(np.float32)
    inv = (rng.randn(cin) * 0.5).astype(np.float32)
    shift = (rng.randn(cin) * 0.1).astype(np.float32)
    beta = (rng.randn(b, cin) * 0.1).astype(np.float32)
    wt = (rng.randn(2, 2, cout, cin) * 0.1).astype(np.float32)

    got = convt.fused_act_convT(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(inv),
        torch.from_numpy(shift), torch.from_numpy(beta), _conv_w(wt))
    e = jnp.asarray(_convT_fold_embedding(1))
    w_pair = jnp.einsum("rjq,kjoc->krcqo", e, jnp.asarray(wt)[::-1]
                        ).reshape(2, cin, 2 * cout)[::-1]
    ref = jax_convT(jnp.asarray(x), jnp.asarray(inv), jnp.asarray(shift),
                    jnp.asarray(beta), w_pair, interpret=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(unfold_freq(ref, 2)), atol=2e-5)
