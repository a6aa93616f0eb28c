"""lass_torch int8 post-training quantization (lass_torch/ops/quant.py) vs
lass_tpu.ops.quant, on the same numpy inputs and weights.

Tolerances and why:

- The primitives: int8 and int32 exact (int32 sums are exact in any
  order); the dequantized float32 within 1e-6 of the largest output (one
  multiply by the scale, one add).
- One residual block, calibrated on two batches and packed: amax per
  channel within 1e-6 relative, the int8 weights equal in at least 99.9%
  of entries (an entry flips where an activation scale that differs by an
  ulp moves a product onto the other side of a rounding tie), sw within
  1e-6 relative, bc within 1e-4, the packed output within 1e-3 relative.
  Amax is compared against the largest amax of its layer: calibration
  runs the float path, whose convs agree between the packages to about
  1e-6 of their largest output, not of each channel's. The pack is
  compared on the same scales (the JAX ones, carried across).
- The whole ResUNet30. Its float forward agrees with the JAX package's to
  about 4e-6, and an int8 chain amplifies any difference: an activation
  that rounds to the neighbouring int8 value moves its output by a whole
  quantization step, and the next layers' roundings follow. The JAX int8
  forward itself moves by 4e-3 when its input moves by 1e-6 relative
  (``test_jax_int8_forward_amplifies_small_changes``), so no float32
  implementation that is not bit for bit XLA's can come within 1e-3 of
  it. At the model level: amax within 1e-5 of its layer's largest and sw
  within 1e-5 relative (the float path through 13 blocks of convs: 2.4e-6
  and 1.7e-6 measured with the quantized model's channels_last convs), the
  int8 weights equal in at least 99.9% of entries; the port's int8
  waveform within twice that 1e-6 movement of JAX's, and its error against
  the float forward equal to JAX's within a tenth of it.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lass_tpu.convert.torch_to_jax import convert_resunet30
from lass_tpu.models.film import resunet30_film_spec as jax_film_spec
from lass_tpu.models.resunet import ResUNet30 as JaxResUNet30
from lass_tpu.nn.blocks import ConvBlockRes as JaxConvBlockRes
from lass_tpu.ops import quant as JQ
from lass_torch.convert import from_jax
from lass_torch.convert.checkpoint_io import unpack_film
from lass_torch.evaluation.dcase import SeparationInference
from lass_torch.models.resunet import ResUNet30
from lass_torch.nn.blocks import ConvBlockRes
from lass_torch.ops import quant as Q
from torch_threads import torch_threads_per_worker  # noqa: F401

LENGTH = 8000  # 0.5 s


def _nhwc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------- primitives

def test_quantize_weight_exact(rng):
    w = (0.3 * rng.randn(24, 16, 3, 3)).astype(np.float32)
    kq, sw = Q.quantize_weight(torch.from_numpy(w))
    jkq, jsw = JQ.quantize_weight(jnp.asarray(np.transpose(w, (2, 3, 1, 0))))
    assert kq.dtype == torch.int8
    np.testing.assert_array_equal(kq.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jkq))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))


def test_quantize_act_exact_with_ties(rng):
    """Round half to even and the clip at +-127: some lanes at scale 1
    with x on exact halves, some past the range."""
    x = rng.randn(2, 16, 5, 7).astype(np.float32) * 40
    x[:, :4] = np.arange(2 * 4 * 5 * 7).reshape(2, 4, 5, 7) / 2.0 - 35
    scale = (np.abs(x).max(axis=(0, 2, 3)) / 127.0).astype(np.float32)
    scale[:4] = 1.0
    scale[4:6] *= 0.5  # these lanes clip
    got = Q.quantize_act(torch.from_numpy(x), torch.from_numpy(scale))
    ref = JQ.quantize_act(jnp.asarray(_nhwc(x)), jnp.asarray(scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(_nhwc(got.numpy()), np.asarray(ref))


@pytest.mark.parametrize("k,bias,chunk", [
    (3, False, None), (1, True, None),
    # several chunks, each under the 17 rows cuBLAS needs (padded)
    (3, False, 3 * 4 * 9 * 16), (1, True, 3 * 4 * 16)])
def test_conv_int8_exact(rng, monkeypatch, k, bias, chunk):
    if chunk:
        monkeypatch.setattr(Q, "CHUNK_ELEMENTS", chunk)
    x = rng.randn(3, 16, 3, 4 if chunk else 9).astype(np.float32)
    w = (0.2 * rng.randn(8, 16, k, k)).astype(np.float32)
    b = (0.1 * rng.randn(8)).astype(np.float32) if bias else None
    scale = (np.abs(x).max(axis=(0, 2, 3)) / 127.0).astype(np.float32)
    tx, tw, ts = map(torch.from_numpy, (x, w, scale))
    kq, _ = Q.quantize_weight(tw * ts[None, :, None, None])
    got32 = Q.int8_conv_int32(Q.quantize_act(tx, ts), kq)
    jxq = JQ.quantize_act(jnp.asarray(_nhwc(x)), jnp.asarray(scale))
    ref32 = jax.lax.conv_general_dilated(
        jxq, jnp.asarray(kq.permute(2, 3, 1, 0).numpy()), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    assert got32.dtype == torch.int32
    np.testing.assert_array_equal(got32.numpy(), np.asarray(ref32))

    got = Q.conv_int8(tx, tw, ts, bias=None if b is None else
                      torch.from_numpy(b))
    ref = np.asarray(JQ.conv_int8(
        jnp.asarray(_nhwc(x)), jnp.asarray(np.transpose(w, (2, 3, 1, 0))),
        jnp.asarray(scale), padding="SAME",
        bias=None if b is None else jnp.asarray(b)))
    got = _nhwc(got.numpy())
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


# ------------------------------------------------------------ one block

def _block_vars(rng, cin, cout):
    def bn(c):
        return ({"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
                 "bias": (0.1 * rng.randn(c)).astype(np.float32)},
                {"mean": (0.5 * rng.randn(c)).astype(np.float32),
                 "var": (rng.rand(c) + 0.5).astype(np.float32)})

    (p1, s1), (p2, s2) = bn(cin), bn(cout)
    p = {"bn1": p1, "bn2": p2,
         "conv1": {"kernel": (0.1 * rng.randn(3, 3, cin, cout)).astype(
             np.float32)},
         "conv2": {"kernel": (0.1 * rng.randn(3, 3, cout, cout)).astype(
             np.float32)}}
    if cin != cout:
        p["shortcut"] = {
            "kernel": (0.1 * rng.randn(1, 1, cin, cout)).astype(np.float32),
            "bias": (0.1 * rng.randn(cout)).astype(np.float32)}
    return {"params": p, "batch_stats": {"bn1": s1, "bn2": s2}}


def _port_block(variables, cin, cout):
    sd = {}
    from_jax._conv_block(sd, "", variables["params"],
                         variables["batch_stats"])
    block = ConvBlockRes(cin, cout, quantize=True)
    missing, unexpected = block.load_state_dict(
        {k.lstrip("."): v for k, v in sd.items()}, strict=False)
    assert not unexpected and all(
        k.endswith("num_batches_tracked") for k in missing)
    return block.eval()


def _compare_state(port_module, jax_state):
    """Differences between a port module's QConv buffers and the JAX
    collections converted by from_jax.quant_state_from_jax (those it
    holds): the largest amax error over the largest amax of its layer, the
    int8 weight entries that differ and their count, the largest sw error
    relative to its own value, the largest bc error."""
    ours = {f"{n}.{b}": getattr(m, b)
            for n, m in port_module.named_modules()
            if isinstance(m, Q.QConv) for b in ("amax", "kq", "sw", "bc")}
    assert set(jax_state) <= set(ours)
    out = {"amax": 0.0, "kq_diff": 0, "kq_n": 0, "sw": 0.0, "bc": 0.0}
    for key, ref in jax_state.items():
        got, kind = ours[key], key.rsplit(".", 1)[1]
        err = (got.double() - ref.double()).abs()
        if kind == "kq":
            out["kq_diff"] += int((err > 0).sum())
            out["kq_n"] += ref.numel()
        elif kind == "amax":
            out[kind] = max(out[kind], float(err.max() / ref.abs().max()))
        elif kind == "sw":
            out[kind] = max(out[kind], float((err / ref.abs()).max()))
        else:
            out[kind] = max(out[kind], float(err.max()))
    return out


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_block_calibrate_and_pack_match_jax(cin, cout):
    """Calibration in both packages on two batches; then the pack, in the
    port from the JAX scales (carried across by the converter), so that
    the pack is compared on the same scales: a scale that differs in its
    last bits moves activations across rounding ties, and on a 4096
    position batch each such flip moves bc by about 1e-5."""
    rng = np.random.RandomState(cin + cout)
    variables = _block_vars(rng, cin, cout)
    batches = [((rng.randn(2, cin, 32, 64)).astype(np.float32),
                {"beta1": (0.1 * rng.randn(2, cin)).astype(np.float32),
                 "beta2": (0.1 * rng.randn(2, cout)).astype(np.float32)})
               for _ in range(3)]

    jblock = JaxConvBlockRes(cin, cout, quantize=True)

    def japply(v, x, film, mutable):
        return jblock.apply(v, jnp.asarray(_nhwc(x)),
                            {k: jnp.asarray(b) for k, b in film.items()},
                            False, mutable=mutable)

    _, q = japply(variables, *batches[0], ["quant"])
    _, q = japply({**variables, **q}, *batches[1], ["quant"])
    _, p = japply({**variables, **q}, *batches[1], ["qpack"])
    ref = np.asarray(japply({**variables, **q, **p}, *batches[2], False))
    jax_state = from_jax.quant_state_from_jax(
        jax.device_get(q["quant"]), jax.device_get(p["qpack"]))
    jax_scales = {k: v for k, v in jax_state.items() if k.endswith("amax")}

    def run(module, x, film):
        with torch.inference_mode():
            return module(torch.from_numpy(x),
                          {k: torch.from_numpy(b) for k, b in film.items()})

    block = _port_block(variables, cin, cout)
    Q.set_mode(block, "calibrate")
    run(block, *batches[0])
    run(block, *batches[1])
    errs = _compare_state(block, jax_scales)
    assert errs["amax"] <= 1e-6, errs

    Q.load_quant_state(block, jax_scales)
    Q.set_mode(block, "pack")
    run(block, *batches[1])
    Q.set_mode(block, "int8")
    got = run(block, *batches[2]).numpy()
    errs = _compare_state(block, jax_state)
    print(f"block {cin}->{cout} pack vs JAX: {errs}, output rel err "
          f"{_rel(_nhwc(got), ref):.3e}")
    assert errs["kq_diff"] <= 1e-3 * errs["kq_n"], errs
    assert errs["sw"] <= 1e-6 and errs["bc"] <= 1e-4, errs
    assert _rel(_nhwc(got), ref) <= 1e-3

    # the JAX pack carried across gives the port's own pack's output
    carried = _port_block(variables, cin, cout)
    Q.load_quant_state(carried, jax_state)
    assert _rel(run(carried, *batches[2]).numpy(), got) <= 1e-5


# ------------------------------------------------------------- the model

def _seeded_separator(quantize, seed=0):
    torch.manual_seed(seed)
    model = ResUNet30(quantize=quantize)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.3, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
                mod.bias.normal_(0, 0.1, generator=gen)
        model.film.bias.normal_(0, 0.1, generator=gen)
    return model


@pytest.fixture(scope="module")
def model_runs():
    """The same seeded weights in both packages; calibrated on two batches
    of B=2 x 0.5 s, packed on the second, evaluated on a third."""
    rng = np.random.RandomState(5)
    batches = [((0.1 * rng.randn(2, 1, LENGTH)).astype(np.float32),
                rng.randn(2, 512).astype(np.float32)) for _ in range(3)]
    model = _seeded_separator(quantize=True)
    variables = convert_resunet30(
        {k: v.numpy() for k, v in unpack_film(model.state_dict()).items()},
        jax_film_spec())

    jm = JaxResUNet30(freq_fold=1, quantize=True,
                      dsp_precision=jax.lax.Precision.HIGHEST)
    jf = jm.clone(quantize=False)

    def japply(module, mutable):
        return jax.jit(lambda v, m, c: module.apply(
            v, {"mixture": m, "condition": c}, train=False,
            mutable=mutable))

    calib = japply(jm, ["quant"])
    _, q = calib(variables, *batches[0])
    _, q = calib({**variables, **q}, *batches[1])
    _, p = japply(jm, ["qpack"])({**variables, **q}, *batches[1])
    apply_q = japply(jm, False)
    jax_int8 = np.asarray(apply_q({**variables, **q, **p},
                                  *batches[2])["waveform"])
    jax_float = np.asarray(japply(jf, False)(variables,
                                             *batches[2])["waveform"])
    # the same int8 forward, its input moved by 1e-6 relative
    moved = np.asarray(apply_q({**variables, **q, **p},
                               batches[2][0] * np.float32(1 + 1e-6),
                               batches[2][1])["waveform"])

    sep = SeparationInference(model, None, device="cpu")
    sep.calibrate(*batches[0])
    sep.calibrate(*batches[1])
    sep.pack(*batches[1])
    return dict(
        batches=batches, sep=sep, port_int8=sep.separate(*batches[2]),
        jax_int8=jax_int8, jax_float=jax_float, jax_moved=moved,
        jax_state=from_jax.quant_state_from_jax(
            jax.device_get(q["quant"]), jax.device_get(p["qpack"])))


def test_jax_int8_forward_amplifies_small_changes(model_runs):
    moved = _rel(model_runs["jax_moved"], model_runs["jax_int8"])
    print(f"JAX int8 forward, input moved by 1e-6: rel change {moved:.3e}")
    assert moved > 1e-3


def test_model_scales_and_pack_match_jax(model_runs):
    layers = Q.quant_layers(model_runs["sep"].model)
    assert len(model_runs["jax_state"]) == 4 * len(layers) == 4 * 36
    errs = _compare_state(model_runs["sep"].model, model_runs["jax_state"])
    print(f"model int8 state vs JAX: {errs}")
    assert errs["amax"] <= 1e-5, errs
    assert errs["kq_diff"] <= 1e-3 * errs["kq_n"], errs
    assert errs["sw"] <= 1e-5, errs


def test_model_int8_forward_matches_jax(model_runs):
    ref_float = model_runs["jax_float"]
    port_err = _rel(model_runs["port_int8"], ref_float)
    jax_err = _rel(model_runs["jax_int8"], ref_float)
    between = _rel(model_runs["port_int8"], model_runs["jax_int8"])
    moved = _rel(model_runs["jax_moved"], model_runs["jax_int8"])
    print(f"int8 vs float: port {port_err:.4e}, JAX {jax_err:.4e}; port vs "
          f"JAX int8 {between:.4e}; JAX int8 moved by a 1e-6 input change "
          f"{moved:.4e}")
    assert between <= 2 * moved
    assert abs(port_err - jax_err) <= 0.1 * jax_err


def test_jax_collections_carry_into_the_port(model_runs):
    """quant_state_from_jax covers every QConv of the port's model; with
    the JAX scales and pack the port's forward is as close to JAX's int8
    forward as its own pack's."""
    model = _seeded_separator(quantize=True)
    Q.load_quant_state(model, model_runs["jax_state"])
    sep = SeparationInference(model, None, device="cpu")
    got = sep.separate(*model_runs["batches"][2])
    between = _rel(got, model_runs["jax_int8"])
    print(f"port forward with the JAX pack vs JAX int8: {between:.4e}")
    assert between <= 2 * _rel(model_runs["jax_moved"],
                               model_runs["jax_int8"])
    assert all(layer.kq is not None for layer in Q.quant_layers(model))


def test_packed_equals_in_graph_without_bias_correction(model_runs):
    """Packing only hoists the weight quantization out of the forward:
    with bias correction off, packed and in-graph int8 are bit for bit the
    same."""
    batches = model_runs["batches"]
    model = _seeded_separator(quantize=True)
    fresh = SeparationInference(model, None, device="cpu")
    fresh.calibrate(*batches[0])
    fresh.calibrate(*batches[1])
    in_graph = fresh.separate(*batches[2])
    fresh.pack(*batches[1], bias_correction=False)
    assert all(layer.kq is not None and layer.bc is None
               for layer in Q.quant_layers(model))
    np.testing.assert_array_equal(fresh.separate(*batches[2]), in_graph)
    # the default pack (bias correction on) is the fixture's
    fresh.pack(*batches[1])
    np.testing.assert_array_equal(fresh.separate(*batches[2]),
                                  model_runs["port_int8"])


def test_calibration_state_and_checkpoints():
    """Calibration runs the float forward; int8 before calibration raises;
    a second calibration drops the pack and a re-pack recomputes; the
    state dict is the float model's."""
    model = _seeded_separator(quantize=True)
    float_model = _seeded_separator(quantize=False)
    assert set(model.state_dict()) == set(float_model.state_dict())
    sep = SeparationInference(model, None, device="cpu")
    rng = np.random.RandomState(9)
    mix = (0.1 * rng.randn(1, 1, 4000)).astype(np.float32)
    cond = rng.randn(1, 512).astype(np.float32)
    with pytest.raises(RuntimeError, match="calibrat"):
        sep.separate(mix, cond)
    with pytest.raises(ValueError, match="calibrate"):
        sep.pack(mix, cond)
    Q.set_mode(model, "calibrate")
    # the float model's function; the quantized model runs channels_last,
    # whose CPU convs round in other places
    assert _rel(sep.separate(mix, cond), SeparationInference(
        float_model, None, device="cpu").separate(mix, cond)) <= 1e-5
    Q.set_mode(model, "int8")
    sep.pack(mix, cond)
    first = [layer.kq.clone() for layer in Q.quant_layers(model)]
    sep.calibrate(2 * mix, cond)
    assert all(layer.kq is None for layer in Q.quant_layers(model))
    sep.pack(mix, cond)
    assert any(not torch.equal(a, layer.kq) for a, layer in
               zip(first, Q.quant_layers(model)))
    with pytest.raises(ValueError, match="quantize=True"):
        SeparationInference(float_model, None, device="cpu").calibrate(
            mix, cond)
