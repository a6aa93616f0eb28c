"""lass_torch's tensor-parallel layout against lass_tpu's, on the CPU.

- At full width the port's rule (``lass_torch.parallel.mesh.shard_layout``)
  shards exactly the ResUNet30 weights, along exactly the dims, that
  lass_tpu's ``param_shardings`` puts on its mesh's 'model' axis: JAX's
  parameters come from ``jax.eval_shape`` (nothing is computed), each
  sharded leaf filled with its index along the sharded axis, and
  ``from_jax`` carries them into the port's layout, where the dim along
  which a weight varies is the one JAX shards.
- ``make_grid`` raises as ``make_mesh`` does when the ranks are not a
  multiple of the model axis, and ``make_grid(1)`` shards nothing;
  ``shard_model`` refuses an int8 model.

The sharded step, its moments, its checkpoints and the trainer on a grid
run on two gloo ranks in tests/test_torch_parallel.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.models.resunet import ResUNet30 as JaxResUNet30
from lass_tpu.parallel.mesh import make_mesh, param_shardings
from lass_torch.convert.from_jax import resunet30_state_dict_from_jax
from lass_torch.models.resunet import CONFIGS, ResUNet30
from lass_torch.parallel.mesh import Grid, make_grid, shard_layout
from lass_torch.parallel.tensor import shard_model
from torch_threads import torch_threads_per_worker  # noqa: F401


def jax_layout_in_port_names():
    """{port parameter name: dim} of the weights lass_tpu shards over
    'model' in ResUNet30, and every port name from_jax gives."""
    variables = jax.eval_shape(lambda: JaxResUNet30().init(
        jax.random.PRNGKey(0), {"mixture": jnp.zeros((1, 1, 16000)),
                                "condition": jnp.zeros((1, 512))}))
    mesh = make_mesh(jax.devices()[:2], model_parallel=2)
    specs = param_shardings(variables["params"], mesh)

    def fill(leaf, sharding):
        spec = tuple(sharding.spec) + (None,) * (len(leaf.shape)
                                                 - len(sharding.spec))
        if "model" not in spec:
            return np.zeros(leaf.shape, np.float32)
        axis = spec.index("model")
        index = np.arange(1, leaf.shape[axis] + 1, dtype=np.float32)
        shape = [1] * len(leaf.shape)
        shape[axis] = -1
        return np.broadcast_to(index.reshape(shape), leaf.shape)

    params = jax.tree_util.tree_map(fill, variables["params"], specs)
    stats = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                   variables["batch_stats"])
    sd = resunet30_state_dict_from_jax({"params": params,
                                        "batch_stats": stats})
    layout = {}
    for name, t in sd.items():
        varying = [d for d in range(t.dim()) if t.shape[d] > 1 and not
                   torch.equal(t.narrow(d, 0, 1).expand_as(t), t)]
        if varying:
            assert len(varying) == 1, (name, varying)
            layout[name] = varying[0]
    return layout, set(sd)


def test_layout_matches_lass_tpu_param_shardings():
    ref, names = jax_layout_in_port_names()
    model = ResUNet30()
    ours = shard_layout(model)
    assert set(dict(model.named_parameters())) <= names
    assert ours == ref
    # the FiLM's rows, convs of 256 and more output channels, transposed
    # convs of 256 and more input channels
    assert ours["film.weight"] == 0
    assert "base.decoder_block4.conv1.weight" in ours  # 256 -> 128
    assert "base.decoder_block5.conv1.weight" not in ours  # 128 -> 64
    assert len(ours) == 24
    # the fused configurations keep the same names at these widths
    assert shard_layout(ResUNet30(**CONFIGS["A"])) == ours


def test_make_grid_needs_a_multiple_of_the_model_axis():
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        make_grid(2)  # one process
    grid = make_grid(1)
    assert (grid.data_size, grid.model_size) == (1, 1)
    # no model axis: shard_model leaves even a wide conv whole
    model = torch.nn.Sequential(torch.nn.Conv2d(1, 512, 1))
    assert shard_model(model, grid) is model
    assert isinstance(model[0], torch.nn.Conv2d)


def test_shard_model_refuses_int8():
    with pytest.raises(NotImplementedError, match="int8"):
        shard_model(ResUNet30(quantize=True), Grid(None, None, 0, 1, 0, 2))
