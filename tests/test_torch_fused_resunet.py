"""The fused-conv serving configurations of lass_torch ResUNet30 against
lass_tpu, waveform to waveform, float32, B=1 x 0.3 s, on the same weights
(random BN statistics, BN affines and FiLM bias, so that the kernels'
folded affine a, b is exercised):

- config A (sparse_conv + fused_convT + fuse_head) against JAX
  ResUNet30(freq_fold=4, sparse_conv=True, fuse_head=True), whose Pallas
  kernels run in interpret mode here;
- config B (fused_conv_block + fused_convT + fuse_head) against JAX
  ResUNet30(freq_fold=1): the JAX package reaches its block kernel through
  the model only on a TPU, and its plain forward equals it by its own
  tests.

On the CPU the port's wrappers run their plain versions, which check the
kernels' layout rules (channels_last activations) all the same. Tolerance:
rel err <= 1e-4, the JAX package's own float32 bound against the torch
reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.models.resunet import ResUNet30 as JaxResUNet30
from lass_torch.convert.from_jax import resunet30_state_dict_from_jax
from lass_torch.models.resunet import CONFIGS, ResUNet30

LENGTH = 4800  # 0.3 s: T = 31 frames, padded to 32 inside the UNet

# XLA options for the one-off JAX init
INIT_COMPILE_OPTIONS = {"xla_backend_optimization_level": 0,
                        "xla_llvm_disable_expensive_passes": True}


def rel_err(ours, ref) -> float:
    ref = np.asarray(ref, np.float64)
    ours = np.asarray(ours, np.float64)
    return float(np.linalg.norm(ours - ref) / (np.linalg.norm(ref) + 1e-20))


def _perturb(tree, rng):
    """Random BN statistics and affines and FiLM bias (a fresh init has
    mean 0, var 1 and zero biases)."""
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
    """One JAX init per file (the parameter tree is the same under every
    fold and switch)."""
    model = JaxResUNet30(freq_fold=1)
    dummy = {"mixture": jnp.zeros((1, 1, LENGTH)),
             "condition": jnp.zeros((1, 512))}
    # compiled at XLA's lowest optimisation level: the same values as the
    # default level (bit for bit), in half its compile time
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: model.init(k, dummy, train=False)).lower(
        key).compile(INIT_COMPILE_OPTIONS)(key)
    rng = np.random.RandomState(8)
    return {"params": _perturb(jax.device_get(variables["params"]), rng),
            "batch_stats": _perturb(jax.device_get(variables["batch_stats"]),
                                    rng)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(4)
    return ((rng.randn(1, 1, LENGTH) * 0.1).astype(np.float32),
            (rng.randn(1, 512) * 0.3).astype(np.float32))


def _port_forward(config, variables, inputs):
    model = ResUNet30(**CONFIGS[config])
    model.load_state_dict(resunet30_state_dict_from_jax(variables))
    mixture, condition = inputs
    with torch.no_grad():
        return model.eval()({"mixture": torch.from_numpy(mixture),
                             "condition": torch.from_numpy(condition)}
                            )["waveform"].numpy()


def _jax_forward(variables, inputs, **kwargs):
    model = JaxResUNet30(dsp_precision=jax.lax.Precision.HIGHEST, **kwargs)
    return np.asarray(jax.jit(lambda v, m, c: model.apply(
        v, {"mixture": m, "condition": c}, train=False)["waveform"])(
        variables, *map(jnp.asarray, inputs)))


def test_config_a_matches_jax_fused_kernels(jax_variables, inputs):
    got = _port_forward("A", jax_variables, inputs)
    ref = _jax_forward(jax_variables, inputs, freq_fold=4, sparse_conv=True,
                       fuse_head=True)
    assert got.shape == ref.shape == (1, 1, LENGTH)
    assert rel_err(got, ref) <= 1e-4


def test_config_b_matches_jax(jax_variables, inputs):
    got = _port_forward("B", jax_variables, inputs)
    ref = _jax_forward(jax_variables, inputs, freq_fold=1)
    assert rel_err(got, ref) <= 1e-4


def test_switches_keep_the_state_dict():
    keys = {name: {k: tuple(v.shape)
                   for k, v in ResUNet30(**kw).state_dict().items()}
            for name, kw in CONFIGS.items()}
    assert keys["A"] == keys["B"] == keys["default"]


def test_train_mode_runs_the_unfused_path(inputs):
    """In train mode the fused configurations compute what the default
    one does (the JAX package's ``not train`` rule), up to float32 sums in
    another order (their convolutions run on channels_last tensors)."""
    mixture, condition = inputs
    batch = {"mixture": torch.from_numpy(mixture).repeat(2, 1, 1),
             "condition": torch.from_numpy(condition).repeat(2, 1)}
    torch.manual_seed(0)
    default = ResUNet30()
    state = default.state_dict()
    outs = []
    for kw in CONFIGS.values():
        model = ResUNet30(**kw)
        model.load_state_dict(state)
        with torch.no_grad():
            outs.append(model.train()(batch)["waveform"])
    for out in outs[1:]:
        assert rel_err(out.numpy(), outs[0].numpy()) <= 1e-5
