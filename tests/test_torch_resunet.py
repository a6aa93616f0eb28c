"""lass_torch ResUNet30 waveform -> waveform vs lass_tpu ResUNet30.

The weights enter the port by both routes: from a JAX parameter tree
(lass_torch.convert.from_jax) and from a reference-format torch
checkpoint (lass_torch.convert.checkpoint_io, while the JAX side reads the
same state dict through convert_resunet30). The JAX side runs at
dsp_precision=HIGHEST, at freq_fold 1 and 4.

Tolerance (float32): rel err <= 1e-4, the bound the JAX package holds
itself to against the torch reference (tests/test_reference_parity.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.convert.torch_to_jax import convert_resunet30
from lass_tpu.models.film import resunet30_film_spec as jax_film_spec
from lass_tpu.models.resunet import ResUNet30 as JaxResUNet30
from lass_torch.convert.checkpoint_io import load_separator, save_ss_checkpoint
from lass_torch.convert.from_jax import resunet30_state_dict_from_jax
from lass_torch.models.resunet import ResUNet30
from torch_threads import torch_threads_per_worker  # noqa: F401

LENGTH = 8000  # 0.5 s: T = 51 frames, padded to 64 inside the UNet

# XLA options for the one-off JAX init
INIT_COMPILE_OPTIONS = {"xla_backend_optimization_level": 0,
                        "xla_llvm_disable_expensive_passes": True}


def rel_err(ours, ref) -> float:
    ref = np.asarray(ref, np.float64)
    ours = np.asarray(ours, np.float64)
    return float(np.linalg.norm(ours - ref) / (np.linalg.norm(ref) + 1e-20))


@functools.lru_cache(maxsize=None)
def jax_forward(freq_fold: int, dtype: str = "float32"):
    model = JaxResUNet30(freq_fold=freq_fold, compute_dtype=jnp.dtype(dtype),
                         dsp_precision=jax.lax.Precision.HIGHEST)
    return jax.jit(lambda v, m, c: model.apply(
        v, {"mixture": m, "condition": c}, train=False)["waveform"])


def _perturb(tree, rng):
    """Random BN statistics and affines and FiLM bias: a fresh init has
    mean 0, var 1 and zero biases, which would exercise nothing."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k == "var":
            v = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        elif k in ("mean", "bias"):
            v = v + (0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "scale":
            v = v * (1 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def jax_variables():
    """One JAX init per file (freq_fold=1; the freq_fold=4 tree is the
    same)."""
    model = JaxResUNet30(freq_fold=1)
    dummy = {"mixture": jnp.zeros((1, 1, LENGTH)),
             "condition": jnp.zeros((1, 512))}
    # compiled at XLA's lowest optimisation level: the same values as the
    # default level (bit for bit), in half its compile time
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: model.init(k, dummy, train=False)).lower(
        key).compile(INIT_COMPILE_OPTIONS)(key)
    rng = np.random.RandomState(7)
    return {"params": _perturb(jax.device_get(variables["params"]), rng),
            "batch_stats": _perturb(jax.device_get(variables["batch_stats"]),
                                    rng)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(3)
    return ((rng.randn(2, 1, LENGTH) * 0.1).astype(np.float32),
            (rng.randn(2, 512) * 0.3).astype(np.float32))


def _port_forward(model, inputs):
    mixture, condition = inputs
    with torch.no_grad():
        return model.eval()({"mixture": torch.from_numpy(mixture),
                             "condition": torch.from_numpy(condition)}
                            )["waveform"].float().numpy()


def _jax_apply(variables, inputs, freq_fold, dtype="float32"):
    mixture, condition = inputs
    return np.asarray(jax_forward(freq_fold, dtype)(
        variables, jnp.asarray(mixture), jnp.asarray(condition)))


@pytest.mark.parametrize("freq_fold", [1, 4])
def test_from_jax_params_match(jax_variables, inputs, freq_fold):
    model = ResUNet30()
    model.load_state_dict(resunet30_state_dict_from_jax(jax_variables))
    got = _port_forward(model, inputs)
    ref = _jax_apply(jax_variables, inputs, freq_fold)
    assert got.shape == ref.shape == (2, 1, LENGTH)
    assert rel_err(got, ref) <= 1e-4


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    """A reference-layout checkpoint (ss_model.* keys, per-path FiLM
    Linears) with seeded weights and random BN statistics."""
    torch.manual_seed(0)
    model = ResUNet30()
    rng = np.random.RandomState(11)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                n = mod.num_features
                mod.running_mean.normal_(0, 0.3)
                mod.running_var.copy_(torch.from_numpy(
                    (rng.rand(n) + 0.5).astype(np.float32)))
                mod.weight.copy_(torch.from_numpy(
                    (1 + 0.1 * rng.randn(n)).astype(np.float32)))
                mod.bias.copy_(torch.from_numpy(
                    (0.1 * rng.randn(n)).astype(np.float32)))
        model.film.bias.normal_(0, 0.1)
    path = tmp_path_factory.mktemp("ckpt") / "ref.ckpt"
    save_ss_checkpoint(model, str(path))
    return str(path)


@pytest.mark.parametrize("freq_fold", [1, 4])
def test_reference_checkpoint_matches(reference_checkpoint, inputs,
                                      freq_fold):
    blob = torch.load(reference_checkpoint, weights_only=True)["state_dict"]
    variables = convert_resunet30(blob, jax_film_spec())
    model = ResUNet30()
    load_separator(model, reference_checkpoint)
    got = _port_forward(model, inputs)
    ref = _jax_apply(variables, inputs, freq_fold)
    assert rel_err(got, ref) <= 1e-4


def test_bfloat16_compute(jax_variables, inputs):
    """bf16 activations, f32 BN/FiLM constants and DSP, on both sides. The
    two frameworks round bf16 at other places (conv accumulation order,
    where casts fall), so the two bf16 forwards differ by about as much as
    each differs from float32: on this input the JAX bf16 forward is 1.9e-2
    from its own f32 forward and the port's bf16 forward 2.1e-2 from the
    JAX bf16 one. The bound, 5e-2, is that size with room for the input."""
    model = ResUNet30(compute_dtype=torch.bfloat16)
    model.load_state_dict(resunet30_state_dict_from_jax(jax_variables))
    got = _port_forward(model, inputs)
    ref = _jax_apply(jax_variables, inputs, 1, "bfloat16")
    assert np.isfinite(got).all()
    assert rel_err(got, ref) <= 5e-2


def test_state_dict_names_are_the_reference_names():
    keys = set(ResUNet30().state_dict())
    assert {"film.weight", "film.bias", "base.bn0.running_var",
            "base.pre_conv.weight", "base.after_conv.bias",
            "base.encoder_block1.conv_block1.bn1.weight",
            "base.encoder_block2.conv_block1.shortcut.bias",
            "base.decoder_block1.conv1.weight",
            "base.decoder_block6.conv_block2.conv2.weight"} <= keys
    # ConvTranspose2d keeps torch's (in, out, kh, kw) layout
    assert ResUNet30().state_dict()[
        "base.decoder_block1.conv1.weight"].shape == (384, 384, 1, 2)
