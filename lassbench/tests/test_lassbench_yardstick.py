"""The frozen arithmetic: the FLOP count equals a count by hand at a
small shape, and the mask's bound is 4 * (inputs + 2) * elements bytes at
the HBM bandwidth."""
import pytest

from lassbench import flops, yardstick
from lassbench.reference import separator


def _conv(cout, cin, k, h, w):
    return 2 * cout * cin * k * k * h * w


def unet_by_hand(batch, t, f=512, cond=512):
    """Every conv of ResUNet30 at input (batch, 1, t, f), and FiLM."""
    n = _conv(32, 1, 1, t, f)  # pre_conv
    skips = []
    for _, cin, cout, down in separator.ENCODER:
        n += _conv(cout, cin, 3, t, f) + _conv(cout, cout, 3, t, f)
        if cin != cout:
            n += _conv(cout, cin, 1, t, f)
        skips.append((t, f))
        t, f = t // down[0], f // down[1]
    for _, cin, cout, up in separator.DECODER:
        t, f = t * up[0], f * up[1]
        n += 2 * cin * cout * (t // up[0]) * (f // up[1]) * up[0] * up[1]
        n += _conv(cout, 2 * cout, 3, t, f) + _conv(cout, cout, 3, t, f)
        n += _conv(cout, 2 * cout, 1, t, f)
    n += _conv(3, 32, 1, t, f)
    rows = sum(w for _, w in separator.film_spec())
    return batch * (n + 2 * cond * rows)


def test_separator_flops_by_hand():
    cfg = {"condition_size": 512, "segment_seconds": 0.32,
           "sampling_rate": 16000}
    frames = 5120 // 160 + 1  # 33 -> padded to 64
    assert flops.separator_flops(cfg, 2) == unet_by_hand(2, 64)
    # the backward is twice the forward, less the input gradients nobody
    # needs: of the spectrogram into pre_conv, of the condition into FiLM
    rows = sum(w for _, w in separator.film_spec())
    assert flops.separator_flops(cfg, 2, train=True) == \
        3 * unet_by_hand(2, 64) - 2 * (_conv(32, 1, 1, 64, 512)
                                       + 2 * 512 * rows)
    assert frames == 33


def test_text_flops_by_hand():
    cfg = {"vocab_size": 100, "hidden_size": 32, "num_hidden_layers": 2,
           "num_attention_heads": 4, "intermediate_size": 64,
           "max_position_embeddings": 70, "type_vocab_size": 1,
           "joint_embed_dim": 16, "pad_to": 8}
    b, s, h, ff, e = 3, 8, 32, 64, 16
    layer = 2 * s * (4 * h * h + 2 * h * ff) + 2 * 2 * s * s * h
    head = 2 * h * h + 2 * h * e + 2 * e * e
    assert flops.text_flops(cfg, b) == b * (2 * layer + head)


def test_mask_bound():
    elements = 16 * 1001 * 512
    got = yardstick.mask_bound(5, elements)
    assert got["bytes"] == 4 * 7 * elements
    assert got["bound_s"] == pytest.approx(4 * 7 * elements / 3.35e12)
    assert got["bound_by"] == "bytes"


def test_families():
    fam = yardstick.family
    assert fam("void (anonymous namespace)::apply_complex_mask_kernel<5>("
               "(anonymous namespace)::MaskArgs)") == "mask kernel"
    assert fam("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>") == \
        "batch norm (train)"
    assert fam("sm90_xmma_fprop_implicit_gemm_bf16") == "conv"
    assert fam("ncclDevKernel_AllReduce_Sum_f32") == "collective"
    assert fam("void at::native::vectorized_elementwise_kernel<8>") == \
        "elementwise/reduce"


def test_trace_reduction():
    """Busy time is the union of device intervals inside the window; idle
    gaps are named by the benchmark range the host was in."""
    from lassbench.trace import Trace

    tr = Trace()
    tr.window = (0.0, 100.0)
    tr.ranges["lassbench::query"] = [(0.0, 30.0)]
    tr.ranges["lassbench::separate"] = [(30.0, 100.0)]
    tr.kernels = [("void elementwise_kernel<a>", 10.0, 20.0),
                  ("void elementwise_kernel<b>", 20.0, 20.0),  # overlaps
                  ("sm90_xmma_fprop_implicit_gemm_bf16", 50.0, 30.0),
                  ("void elementwise_kernel<c>", 95.0, 10.0)]  # runs past
    tr.range_kernels["lassbench::separate"] = [
        ("sm90_xmma_fprop_implicit_gemm_bf16", 30.0)]
    assert tr.busy_s() == pytest.approx((30 + 30 + 5) / 1e6)
    assert tr.window_s() == pytest.approx(100 / 1e6)
    assert tr.family_s("conv", "lassbench::separate") == pytest.approx(3e-5)
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert gaps["query (1 gaps)"] == pytest.approx(10 / 1e6)
    assert gaps["separate (2 gaps)"] == pytest.approx((10 + 15) / 1e6)
