"""lass_torch fused act+conv3x3 (port of pallas_folded_conv) and residual
conv block (port of pallas_convblock): the plain versions against the JAX
Pallas kernels in interpret mode and their jnp oracles, on the logical
layout (s=1) and around a frequency-folded case (fold_freq / unfold_freq /
fold_conv_kernel on the JAX side); the fused block module; the wrappers'
error paths. The CUDA kernels are held against these plain versions on the
card by tests/test_torch_kernels_cuda.py and chip_smoke.py.

Tolerances are the JAX package's own bounds for its kernels (float32):
2e-4 for the act+conv (tests/test_pallas_folded_conv.py), 2e-5 for the
residual block (tests/test_pallas_convblock.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.ops.folded import (
    fold_conv_kernel, fold_feature_map, fold_freq, unfold_freq)
from lass_tpu.ops.pallas_convblock import (
    fused_residual_conv_block as jax_conv_block)
from lass_tpu.ops.pallas_folded_conv import (
    fused_act_folded_conv, reference_act_folded_conv)
from lass_torch.nn.blocks import ConvBlockRes
from lass_torch.nn.fused import FusedConvBlockRes
from lass_torch.ops import _common, act_conv, convblock


def to_port(x_nhwc):
    """(B, T, F, C) numpy -> (B, C, T, F) torch tensor, channels_last."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def to_nhwc(y):
    return y.permute(0, 2, 3, 1).numpy()


def conv_w(w_hwio):
    """(3, 3, I, O) -> torch (O, I, 3, 3)."""
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("s,groups,cout,t,f,t_tile", [
    (1, (16,), 16, 8, 8, 4),        # logical layout, several time tiles
    (1, (8, 8), 8, 8, 8, 4),        # decoder concat: two sources
    (2, (8,), 8, 8, 16, 4),         # folded around the JAX call
    (2, (4, 4), 4, 4, 16, 4),       # folded concat, single time tile
])
def test_act_conv_plain_matches_pallas(rng, s, groups, cout, t, f, t_tile):
    b, cin = 2, sum(groups)
    srcs = [rng.randn(b, t, f, c).astype(np.float32) for c in groups]
    w = (0.1 * rng.randn(3, 3, cin, cout)).astype(np.float32)
    a = (1.0 + 0.1 * rng.randn(b, cin)).astype(np.float32)
    bias = (0.1 * rng.randn(b, cin)).astype(np.float32)

    got = act_conv.fused_act_conv3x3(
        [to_port(x) for x in srcs], conv_w(w), torch.from_numpy(a),
        torch.from_numpy(bias))
    assert got.is_contiguous(memory_format=torch.channels_last)

    # JAX side: fold each source, concatenate the folded groups
    xf = jnp.concatenate([fold_freq(jnp.asarray(x), s) for x in srcs], -1)
    fm = fold_feature_map(s, list(groups))
    kf = fold_conv_kernel(jnp.asarray(w), s,
                          in_groups=groups if len(groups) > 1 else None)
    af, bf = jnp.asarray(a[:, fm]), jnp.asarray(bias[:, fm])
    kernel = fused_act_folded_conv(xf, kf, af, bf, s, groups, t_tile=t_tile,
                                   interpret=True)
    oracle = reference_act_folded_conv(xf, kf, af, bf)
    for ref in (kernel, oracle):
        np.testing.assert_allclose(to_nhwc(got),
                                   np.asarray(unfold_freq(ref, s)),
                                   atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("s,u,t,f,t_tile", [(1, 16, 64, 16, 32),
                                            (4, 8, 32, 32, 16)])
def test_conv_block_plain_matches_pallas(rng, s, u, t, f, t_tile):
    b = 2
    x = (0.3 * rng.randn(b, t, f, u)).astype(np.float32)
    w1, w2 = ((0.1 * rng.randn(3, 3, u, u)).astype(np.float32)
              for _ in range(2))
    vecs = [(rng.rand(b, u) * 0.5 + 0.7).astype(np.float32),
            (rng.randn(b, u) * 0.2).astype(np.float32),
            (rng.rand(b, u) * 0.5 + 0.7).astype(np.float32),
            (rng.randn(b, u) * 0.2).astype(np.float32)]

    got = convblock.fused_residual_conv_block(
        to_port(x), conv_w(w1), conv_w(w2), *map(torch.from_numpy, vecs))

    fm = fold_feature_map(s, [u])
    ref = jax_conv_block(
        fold_freq(jnp.asarray(x), s), fold_conv_kernel(jnp.asarray(w1), s),
        fold_conv_kernel(jnp.asarray(w2), s),
        *[jnp.asarray(v[:, fm]) for v in vecs], t_tile=t_tile,
        interpret=True)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(unfold_freq(ref, s)),
                               atol=2e-5)


def _block(cin, cout, **switches):
    torch.manual_seed(0)
    blk = FusedConvBlockRes(cin, cout, **switches)
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn2):
            bn.running_mean.normal_(0, 0.3)
            bn.running_var.uniform_(0.5, 1.5)
            bn.weight.normal_(1, 0.1)
            bn.bias.normal_(0, 0.1)
    return blk.eval()


@pytest.mark.parametrize("switches,groups,cout", [
    (dict(sparse_conv=True), (8, 8), 8),       # two sources + shortcut
    (dict(sparse_conv=True), (8,), 8),         # identity residual
    (dict(fused_conv_block=True), (8,), 8),    # the whole-block kernel
])
def test_fused_block_matches_unfused(rng, switches, groups, cout):
    """The fused block == nn/blocks.py's ConvBlockRes on the concat, same
    parameters (float32), and in train mode it runs the unfused path."""
    blk = _block(sum(groups), cout, **switches)
    plain = ConvBlockRes(sum(groups), cout)
    plain.load_state_dict(blk.state_dict())
    plain.eval()
    srcs = [to_port(rng.randn(2, 8, 12, c).astype(np.float32))
            for c in groups]
    film = {"beta1": torch.from_numpy(
                (0.1 * rng.randn(2, sum(groups))).astype(np.float32)),
            "beta2": torch.from_numpy(
                (0.1 * rng.randn(2, cout)).astype(np.float32))}
    x = torch.cat(srcs, 1)
    with torch.no_grad():
        got = blk(srcs, film)
        want = plain(x, film)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
        blk.train()
        plain.train()
        np.testing.assert_array_equal(blk(srcs, film).numpy(),
                                      plain(x, film).numpy())


def _conv_args(rng, b=1, cin=8, cout=8, t=4, f=4):
    return ([to_port(rng.randn(b, t, f, cin).astype(np.float32))],
            torch.zeros(cout, cin, 3, 3), torch.ones(b, cin),
            torch.zeros(b, cin))


def test_act_conv_wrapper_errors(rng):
    srcs, w, a, b = _conv_args(rng)
    with pytest.raises(ValueError, match="share"):  # mismatched sources
        act_conv.fused_act_conv3x3(
            srcs + [to_port(rng.randn(1, 5, 4, 8).astype(np.float32))],
            torch.zeros(8, 16, 3, 3), torch.ones(1, 16), torch.zeros(1, 16))
    with pytest.raises(ValueError, match="weight"):
        act_conv.fused_act_conv3x3(srcs, torch.zeros(8, 4, 3, 3), a, b)
    with pytest.raises(ValueError, match="channels_last"):
        act_conv.fused_act_conv3x3(
            [srcs[0].contiguous()], w, a, b)
    with pytest.raises(RuntimeError, match="no backward"):
        act_conv.fused_act_conv3x3(srcs, w.requires_grad_(True), a, b)


def test_conv_block_wrapper_errors(rng):
    x = to_port(rng.randn(1, 4, 4, 8).astype(np.float32))
    w = torch.zeros(8, 8, 3, 3)
    vecs = [torch.ones(1, 8)] * 4
    with pytest.raises(ValueError, match="weights"):
        convblock.fused_residual_conv_block(x, torch.zeros(8, 4, 3, 3), w,
                                            *vecs)
    with pytest.raises(ValueError, match="affine"):
        convblock.fused_residual_conv_block(x, w, w, torch.ones(2, 8),
                                            *vecs[1:])
    with pytest.raises(RuntimeError, match="no backward"):
        convblock.fused_residual_conv_block(x.requires_grad_(True), w, w,
                                            *vecs)


def unpack_b(packed):
    """(taps, K / 16, N / 8, 2, 8, 8) -> (taps, K, N): pack_b undone."""
    taps, kk, nb = packed.shape[:3]
    return packed.permute(0, 1, 3, 5, 2, 4).reshape(taps, 16 * kk, 8 * nb)


@pytest.mark.parametrize("taps,k,n", [(9, 32, 32), (9, 48, 64),
                                      (9, 128, 64), (3, 128, 128)])
def test_pack_b_round_trip(rng, taps, k, n):
    """The wgmma kernels' weight layout (csrc/sm90_pipe.cuh): an exact
    round trip back to (tap, C_in, C_out), and each element at the offset
    the B descriptor reads it from (core matrices of 8 N-rows x 8 K, 128
    bytes apart along K and 256 along N, one N x 16 block per k16 step)."""
    w = torch.from_numpy(rng.randn(taps, k, n).astype(np.float32)).to(
        torch.bfloat16)
    packed = _common.pack_b(w)
    assert packed.is_contiguous()
    assert torch.equal(unpack_b(packed), w)
    flat = packed.reshape(-1)
    for tap, kx, nx in [(0, 0, 0), (taps - 1, k - 1, n - 1), (1, 9, 13),
                        (taps // 2, k // 2 + 7, n // 2 + 3)]:
        block = (tap * (k // 16) + kx // 16) * n * 16
        core = (nx // 8) * 128 + ((kx % 16) // 8) * 64
        assert flat[block + core + (nx % 8) * 8 + kx % 8] == w[tap, kx, nx]
    with pytest.raises(ValueError, match="K % 16"):
        _common.pack_b(w[:, :8])


def test_tap_weights_order(rng):
    """(C_out, C_in, 3, 3) -> (tap = 3 * dt + df, C_in, C_out), the order
    in which the kernel walks the taps."""
    w = torch.from_numpy(rng.randn(32, 16, 3, 3).astype(np.float32))
    taps = act_conv.tap_weights(w)
    assert taps.shape == (9, 16, 32)
    for dt in range(3):
        for df in range(3):
            assert torch.equal(taps[3 * dt + df], w[:, :, dt, df].T)
