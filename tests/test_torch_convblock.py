"""lass_torch residual conv block (port of pallas_convblock): the weight
layout of the persistent wgmma kernel (W1's and W2's nine taps packed by
``_common.pack_b``) round-trips exactly; the
wrapper refuses the widths and layouts the kernel does not take before it
builds anything; the plain version matches the JAX Pallas kernel in
interpret mode at the edges of the kernel's schedule (T = 1 and 3, every
halo row padding; F off the kernel's 62-frequency strip). The CUDA
kernel is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.

Tolerance: 2e-5 abs in float32, the JAX package's own bound for its
kernel (tests/test_pallas_convblock.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.ops.pallas_convblock import (
    fused_residual_conv_block as jax_conv_block)
from lass_torch.ops import _common, convblock
from lass_torch.ops.act_conv import tap_weights
from torch_threads import torch_threads_per_worker  # noqa: F401


def unpack_b(packed):
    """(taps, K / 16, N / 8, 2, 8, 8) -> (taps, K, N): pack_b undone."""
    taps, kk, nb = packed.shape[:3]
    return packed.permute(0, 1, 3, 5, 2, 4).reshape(taps, 16 * kk, 8 * nb)


def test_block_weights_round_trip(rng):
    """The kernel's (18, U, U) operand: W1's nine taps, then W2's, each
    (tap = 3 dt + df, input channel, output channel); packed by pack_b and
    unpacked exactly. W2's first value sits right after W1's 9 x U x U,
    where the kernel points conv2's B descriptor."""
    u = convblock.KERNEL_U
    w1, w2 = (torch.from_numpy(rng.randn(u, u, 3, 3).astype(np.float32))
              for _ in range(2))
    taps = torch.cat([tap_weights(w1), tap_weights(w2)]).to(torch.bfloat16)
    packed = _common.pack_b(taps)
    assert packed.shape == (18, u // 16, u // 8, 2, 8, 8)
    back = unpack_b(packed)
    assert torch.equal(back, taps)
    for k, w in enumerate((w1, w2)):
        for dt in range(3):
            for df in range(3):
                assert torch.equal(back[9 * k + 3 * dt + df],
                                   w[:, :, dt, df].T.to(torch.bfloat16))
    flat = packed.reshape(-1)
    assert flat[9 * u * u] == w2[0, 0, 0, 0].to(torch.bfloat16)


def _bf16_cl(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)


def test_kernel_refuses_what_it_does_not_take(rng):
    """The checks of the CUDA path, which run before the kernel is built:
    a width other than 32, float32 activations, rows off 16 bytes."""
    def args(x):
        u = x.shape[1]
        return (x, torch.zeros(u, u, 3, 3), torch.zeros(u, u, 3, 3),
                [torch.ones(x.shape[0], u)] * 4)

    with pytest.raises(ValueError, match="takes 32 channels"):
        convblock._launch(*args(_bf16_cl(rng, 1, 16, 4, 8)))
    with pytest.raises(TypeError, match="bfloat16"):
        convblock._launch(*args(_bf16_cl(rng, 1, 32, 4, 8).float()))
    wide = _bf16_cl(rng, 1, 40, 4, 8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        convblock._launch(*args(wide[:, 1:33]))


@pytest.mark.parametrize("t,f", [(1, 13), (3, 7), (2, 70)])
def test_plain_matches_pallas_at_schedule_edges(rng, t, f):
    b, u = 2, 8
    x = (0.3 * rng.randn(b, t, f, u)).astype(np.float32)
    w1, w2 = ((0.1 * rng.randn(3, 3, u, u)).astype(np.float32)
              for _ in range(2))
    vecs = [(rng.rand(b, u) * 0.5 + 0.7).astype(np.float32),
            (rng.randn(b, u) * 0.2).astype(np.float32),
            (rng.rand(b, u) * 0.5 + 0.7).astype(np.float32),
            (rng.randn(b, u) * 0.2).astype(np.float32)]

    def conv_w(w):
        return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))

    got = convblock.fused_residual_conv_block(
        torch.from_numpy(x).permute(0, 3, 1, 2), conv_w(w1), conv_w(w2),
        *map(torch.from_numpy, vecs))
    ref = jax_conv_block(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2),
                         *map(jnp.asarray, vecs), t_tile=t, interpret=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=2e-5)
