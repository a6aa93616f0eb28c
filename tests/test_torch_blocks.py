"""lass_torch blocks and FiLM vs the lass_tpu flax modules on the same
numpy weights (JAX layout, converted with lass_torch.convert.from_jax).

Tolerance: 2e-4 abs, the bound tests/test_blocks.py uses for the JAX
blocks against torch; float32 convs on two backends sum in other orders.
BatchNorm statistics and affines, FiLM betas and biases are random, so
every term of the eval affine is exercised.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.models.film import FusedFiLM as JaxFiLM
from lass_tpu.nn.blocks import (
    ConvBlockRes as JaxConvBlock, DecoderBlockRes1B as JaxDecoder,
    EncoderBlockRes1B as JaxEncoder)
from lass_torch.convert import from_jax
from lass_torch.models.film import FusedFiLM, resunet30_film_spec
from lass_torch.nn.blocks import (
    ConvBlockRes, DecoderBlockRes1B, EncoderBlockRes1B)
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 2e-4


def _bn(rng, c):
    return ({"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
             "bias": (0.1 * rng.randn(c)).astype(np.float32)},
            {"mean": (0.5 * rng.randn(c)).astype(np.float32),
             "var": (rng.rand(c) + 0.5).astype(np.float32)})


def _kernel(rng, *shape):
    return (0.1 * rng.randn(*shape)).astype(np.float32)


def _conv_block_vars(rng, cin, cout):
    (p1, s1), (p2, s2) = _bn(rng, cin), _bn(rng, cout)
    p = {"bn1": p1, "bn2": p2,
         "conv1": {"kernel": _kernel(rng, 3, 3, cin, cout)},
         "conv2": {"kernel": _kernel(rng, 3, 3, cout, cout)}}
    if cin != cout:
        p["shortcut"] = {"kernel": _kernel(rng, 1, 1, cin, cout),
                         "bias": _kernel(rng, cout)}
    return p, {"bn1": s1, "bn2": s2}


def _load(module, fill):
    sd = {}
    fill(sd)
    sd = {k.lstrip("."): v for k, v in sd.items()}  # "" prefix -> ".name"
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)
    return module.eval()


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _nchw(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


def _betas(rng, b, *sizes):
    return [rng.randn(b, c).astype(np.float32) for c in sizes]


@pytest.mark.parametrize("cin,cout", [(8, 8), (4, 8)])
def test_conv_block_res(rng, cin, cout):
    p, s = _conv_block_vars(rng, cin, cout)
    x = rng.randn(2, cin, 6, 10).astype(np.float32)
    b1, b2 = _betas(rng, 2, cin, cout)
    ref = JaxConvBlock(cin, cout).apply(
        {"params": p, "batch_stats": s}, _nhwc(x),
        {"beta1": jnp.asarray(b1), "beta2": jnp.asarray(b2)}, False)
    mod = _load(ConvBlockRes(cin, cout),
                lambda sd: from_jax._conv_block(sd, "", p, s))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), {"beta1": torch.from_numpy(b1),
                                        "beta2": torch.from_numpy(b2)})
    np.testing.assert_allclose(got.numpy(), _nchw(ref), atol=TOL)


@pytest.mark.parametrize("down", [(2, 2), (1, 2), (1, 1)])
def test_encoder_block(rng, down):
    p, s = _conv_block_vars(rng, 4, 8)
    x = rng.randn(2, 4, 8, 12).astype(np.float32)
    b1, b2 = _betas(rng, 2, 4, 8)
    film_j = {"conv_block1": {"beta1": jnp.asarray(b1),
                              "beta2": jnp.asarray(b2)}}
    pool_r, enc_r = JaxEncoder(4, 8, down).apply(
        {"params": {"conv_block1": p}, "batch_stats": {"conv_block1": s}},
        _nhwc(x), film_j, False)
    mod = _load(EncoderBlockRes1B(4, 8, down),
                lambda sd: from_jax._conv_block(sd, "conv_block1", p, s))
    with torch.no_grad():
        pool, enc = mod(torch.from_numpy(x), {"conv_block1": {
            "beta1": torch.from_numpy(b1), "beta2": torch.from_numpy(b2)}})
    np.testing.assert_allclose(enc.numpy(), _nchw(enc_r), atol=TOL)
    np.testing.assert_allclose(pool.numpy(), _nchw(pool_r), atol=TOL)


@pytest.mark.parametrize("up", [(2, 2), (1, 2)])
def test_decoder_block(rng, up):
    cin, cout = 8, 4
    bn1_p, bn1_s = _bn(rng, cin)
    cb_p, cb_s = _conv_block_vars(rng, 2 * cout, cout)
    p = {"bn1": bn1_p, "conv1": {"kernel": _kernel(rng, *up, cout, cin)},
         "conv_block2": cb_p}
    s = {"bn1": bn1_s, "conv_block2": cb_s}
    x = rng.randn(2, cin, 4, 6).astype(np.float32)
    skip = rng.randn(2, cout, 4 * up[0], 6 * up[1]).astype(np.float32)
    b1, c1, c2 = _betas(rng, 2, cin, 2 * cout, cout)
    ref = JaxDecoder(cin, cout, up).apply(
        {"params": p, "batch_stats": s}, _nhwc(x), _nhwc(skip),
        {"beta1": jnp.asarray(b1),
         "conv_block2": {"beta1": jnp.asarray(c1), "beta2": jnp.asarray(c2)}},
        False)

    def fill(sd):
        from_jax._bn(sd, "bn1", bn1_p, bn1_s)
        sd["conv1.weight"] = from_jax._conv_w(p["conv1"]["kernel"])
        from_jax._conv_block(sd, "conv_block2", cb_p, cb_s)

    mod = _load(DecoderBlockRes1B(cin, cout, up), fill)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(skip), {
            "beta1": torch.from_numpy(b1),
            "conv_block2": {"beta1": torch.from_numpy(c1),
                            "beta2": torch.from_numpy(c2)}})
    np.testing.assert_allclose(got.numpy(), _nchw(ref), atol=TOL)


def test_fused_film(rng):
    spec = resunet30_film_spec()
    total = sum(f for _, f, _ in spec)
    assert total == 8256 + 1600  # used columns + the dead decoder beta2
    kernel = _kernel(rng, 512, total)
    bias = _kernel(rng, total)
    cond = rng.randn(2, 512).astype(np.float32)
    ref = JaxFiLM(spec, 512).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(cond))
    mod = _load(FusedFiLM(spec, 512), lambda sd: from_jax._linear(
        sd, "", {"kernel": kernel, "bias": bias}))
    with torch.no_grad():
        got = mod(torch.from_numpy(cond))
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat_ref) == len(spec)
    for path, feat, _ in spec:
        g, r = got, ref
        for key in path:
            g, r = g[key], r[key]
        assert g.shape == (2, feat)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL)
