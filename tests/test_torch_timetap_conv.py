"""lass_torch time-tap conv (the port of scripts/microbench_tridiag.py's
Pallas kernel ``tridiag_conv``) against that kernel in interpret mode and
against JAX's (3, 1) SAME conv, plus the wrapper's rules on the CPU. The
CUDA kernel is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.

The Pallas kernel's edge tiles are not the SAME conv: its first tile's
halo copy starts at row 0 instead of -1 (each row t reads x[t..t+2]) and
its last tile reads past T. The port computes the SAME conv, so it is
held against the Pallas kernel on the interior tiles only, and against
the conv on every row.

Tolerance: one bf16 unit (2^-7) of the largest output: both sides round
the same bf16 products' float32 sum to bf16, summed in another order.
"""
import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_torch.ops import timetap_conv as tt_mod

REPO = pathlib.Path(__file__).resolve().parent.parent
BF16_ULP = 2.0 ** -7


def _microbench():
    """scripts/microbench_tridiag.py as a module (its import sets a JAX
    cache variable in os.environ, which is put back)."""
    before = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    spec = importlib.util.spec_from_file_location(
        "microbench_tridiag", REPO / "scripts" / "microbench_tridiag.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        if before is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = before
    return mod


def _inputs(rng, shape):
    b, t, g, c = shape
    x = (rng.randn(b, t, g, c)).astype(np.float32)
    w3 = (rng.randn(3 * c, c) / np.sqrt(3 * c)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    wj = jnp.asarray(w3, jnp.bfloat16)
    # the same bf16 values on the torch side
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).bfloat16()
    return xj, wj, xt, wt


def _err(got, ref):
    return np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max()


@pytest.mark.parametrize("act", [False, True])
def test_plain_matches_pallas_kernel_on_interior_tiles(rng, act):
    tt, shape = 16, (1, 48, 4, 128)
    xj, wj, xt, wt = _inputs(rng, shape)
    ref = np.asarray(_pallas_interpret(xj, wj, tt, act).astype(jnp.float32))
    got = tt_mod.timetap_conv_plain(xt, wt, act)
    interior = slice(tt, shape[1] - tt)  # the middle tile
    scale = np.abs(ref[:, interior]).max()
    assert _err(got[:, interior], ref[:, interior]) <= BF16_ULP * scale
    # the edge tiles are not the SAME conv (module docstring)
    assert _err(got[:, :tt], ref[:, :tt]) > 10 * BF16_ULP * scale


def _pallas_interpret(x, w3, tt, act):
    """The script's tridiag_conv: its kernel body and pallas_call as the
    script builds them, with interpret=True (the script targets the TPU
    and takes no interpret flag)."""
    import functools

    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    mod = _microbench()
    bsz, t, g, c = x.shape
    kern = functools.partial(mod._kernel, tt=tt, t_total=t, fuse_act=act)
    return pl.pallas_call(
        kern, grid=(bsz, t // tt),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec((3 * c, c), lambda bi, ti: (0, 0))],
        out_specs=pl.BlockSpec((1, tt, g, c), lambda bi, ti: (bi, ti, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((bsz, t, g, c), x.dtype),
        scratch_shapes=[pltpu.VMEM((2, tt + 2, g, c), x.dtype),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True)(x, w3)


@pytest.mark.parametrize("act", [False, True])
def test_plain_matches_jax_same_conv_on_every_row(rng, act):
    shape = (2, 21, 3, 32)
    xj, wj, xt, wt = _inputs(rng, shape)
    c = shape[3]
    h = jnp.maximum(xj, 0.01 * xj) if act else xj
    kernel = wj.reshape(3, 1, c, c)  # HWIO: tap dt, input k, output n
    ref = jax.lax.conv_general_dilated(
        h.astype(jnp.float32), kernel.astype(jnp.float32), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    ref = np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32))
    got = tt_mod.timetap_conv_plain(xt, wt, act)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    assert _err(got, ref) <= BF16_ULP * np.abs(ref).max()


def test_activation_rounds_like_jax(rng):
    x = jnp.asarray(rng.randn(4096).astype(np.float32), jnp.bfloat16)
    ref = np.asarray(jnp.maximum(x, 0.01 * x).astype(jnp.float32))
    got = tt_mod.leaky_rounded(
        torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16())
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_wrapper_rules_on_cpu(rng):
    x = torch.from_numpy(rng.randn(1, 5, 2, 32).astype(np.float32))
    w3 = torch.from_numpy(rng.randn(96, 32).astype(np.float32))
    before = tt_mod.LAUNCHES
    torch.testing.assert_close(tt_mod.timetap_conv(x, w3, True, 32),
                               tt_mod.timetap_conv_plain(x, w3, True))
    assert tt_mod.LAUNCHES == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="t_tile"):
        tt_mod.timetap_conv(x, w3, t_tile=8)
    with pytest.raises(ValueError, match="weight"):
        tt_mod.timetap_conv(x, w3[:64])
    with pytest.raises(RuntimeError, match="no backward"):
        tt_mod.timetap_conv(x.requires_grad_(True), w3)
