"""lass_torch.models.chunk vs lass_tpu.models.chunk.

A stub separator adds a ramp over the position in its window (and the
condition's first value), so a window cut or stitched in the wrong place
shows. Both of the port's functions must equal both of the JAX package's
exactly: the stub is one add per operand and the stitch only moves values.
Then the port's ``separate_long`` through the real ResUNet30 against the
host stitch of ``separate``'s windows, within 1e-5 relative (the device
path runs the last group padded to full width with zero windows; a conv's
float32 result per window may depend on the batch it runs in)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.models import chunk as jax_chunk
from lass_torch.evaluation.dcase import SeparationInference
from lass_torch.models import chunk
from lass_torch.models.resunet import ResUNet30
from torch_threads import torch_threads_per_worker  # noqa: F401

# windows of 100 + 300 + 100 samples at hop 300
CFG = dict(NL=0.1, NC=0.3, NR=0.1, RATE=1000)


def _ramp(n):
    return (np.arange(n) / 500.0).astype(np.float32)


def _port_stub(d):
    x, c = d["mixture"], d["condition"]
    return x + torch.from_numpy(_ramp(x.shape[-1])) + c[:, :1, None]


def _jax_stub(d):
    x, c = d["mixture"], d["condition"]
    return x + jnp.asarray(_ramp(x.shape[-1])) + c[:, :1, None]


@pytest.mark.parametrize("length", [333, 500, 1100, 1234, 7001])
@pytest.mark.parametrize("max_batch", [2, 3, 16])
def test_stitch_equals_jax(length, max_batch):
    rng = np.random.RandomState(length)
    mix = rng.randn(1, 1, length).astype(np.float32)
    cond = rng.randn(1, 512).astype(np.float32)
    port_cfg, jax_cfg = chunk.ChunkConfig(**CFG), jax_chunk.ChunkConfig(**CFG)
    ref = jax_chunk.chunk_inference(_jax_stub, jnp.asarray(mix),
                                    jnp.asarray(cond), jax_cfg, max_batch)
    ref_dev = np.asarray(jax_chunk.chunk_inference_device(
        _jax_stub, jnp.asarray(mix), jnp.asarray(cond), jax_cfg, max_batch))
    np.testing.assert_array_equal(ref, ref_dev)
    tmix, tcond = torch.from_numpy(mix), torch.from_numpy(cond)
    got = chunk.chunk_inference(_port_stub, tmix, tcond, port_cfg, max_batch)
    got_dev = chunk.chunk_inference_device(_port_stub, tmix, tcond, port_cfg,
                                           max_batch)
    assert got.shape == got_dev.shape == (1, length)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_dev.numpy(), ref)


def test_device_groups_run_at_one_shape():
    shapes = []

    def stub(d):
        shapes.append(tuple(d["mixture"].shape))
        return _port_stub(d)

    mix = torch.randn(1, 1, 7001)
    chunk.chunk_inference_device(stub, mix, torch.randn(1, 512),
                                 chunk.ChunkConfig(**CFG), 3)
    assert shapes == [(3, 1, 500)] * 8  # 23 windows in 8 groups of 3


def test_reference_window_is_ten_seconds_at_16k():
    assert chunk.ChunkConfig().samples() == (32000, 96000, 32000, 160000)


def test_separate_long_matches_host_stitch_of_separate():
    torch.manual_seed(0)
    sep = SeparationInference(ResUNet30(), None, device="cpu")
    rng = np.random.RandomState(4)
    mix = (0.1 * rng.randn(1, 1, 20000)).astype(np.float32)
    cond = rng.randn(1, 512).astype(np.float32)
    cfg = chunk.ChunkConfig(NL=0.1, NC=0.2, NR=0.1, RATE=16000)
    got = sep.separate_long(mix, cond, cfg, max_batch=4)  # 6 windows
    ref = chunk.chunk_inference(
        lambda d: torch.from_numpy(sep.separate(d["mixture"],
                                                d["condition"])),
        torch.from_numpy(mix), torch.from_numpy(cond), cfg, 4)
    assert got.shape == ref.shape == (1, 20000)
    err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert err <= 1e-5, err
