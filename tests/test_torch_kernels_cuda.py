"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips itself where torch sees no GPU (a CUDA
kernel has no CPU mode). This file imports no JAX, so it runs on a GPU
machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerance: 1e-5 of max(1, max |plain|); the kernel and the plain version
evaluate the same float32 formula, with fused multiply-adds and the
libraries' own expf/tanhf rounding in the last bits.
"""
import numpy as np
import pytest
import torch

from lass_torch.ops import masking


def _inputs(rng, shape):
    return [rng.randn(*shape).astype(np.float32) for _ in range(5)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,strided", [((3, 37, 257), False),
                                           ((4, 101, 512), False),
                                           ((4, 101, 512), True)])
def test_kernel_matches_plain_on_card(rng, shape, strided):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    n, t, f = shape
    dev = torch.device("cuda")
    if strided:  # the model's views: channel slices and a 513 -> 512 crop
        logits = torch.from_numpy(rng.randn(n, 3, t + 11, f).astype(
            np.float32)).to(dev)[:, :, :t]
        spec = [torch.from_numpy(rng.randn(n, t, f + 1).astype(np.float32)
                                 ).to(dev)[..., :f] for _ in range(2)]
        args = [logits[:, k] for k in range(3)] + spec
    else:
        args = [torch.from_numpy(a).to(dev) for a in _inputs(rng, shape)]
    before = masking.LAUNCHES
    got = masking.apply_complex_mask_ri(*args)
    torch.cuda.synchronize()
    assert masking.LAUNCHES == before + 1
    ref = masking.mask_math_from_ri(*args)
    for g, r in zip(got, ref):
        assert g.is_contiguous()
        assert (g - r).abs().max().item() <= 1e-5 * max(
            1.0, r.abs().max().item())


# ---------------------------------------------------------------------------
# The fused-conv kernels (bfloat16 activations). Tolerance: the kernel and
# the plain version apply the same float32 activation and round it at the
# same points; they differ in the order of the float32 sums only, which
# can move a bf16 rounding by one unit in the last place: 2^-7 of the
# largest output. The residual block rounds one more intermediate (its
# second activation), so it gets two. The fused head's outputs are
# float32: 1e-4 of max(1, max |plain|) (sums of 32 products in another
# order, through the mask chain).
# ---------------------------------------------------------------------------

BF16_ULP = 2.0 ** -7


def _card(rng, *shape, scale=1.0, cl=False):
    t = torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32)
                         ).cuda()
    if cl:
        t = t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return t


def _strict_float32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close_bf16(got, ref, ulps=1):
    assert got.is_contiguous(memory_format=torch.channels_last)
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= ulps * BF16_ULP * max(scale, 1e-30), (err, scale)


# The last eight cases are the persistent schedule's edges: T and F off
# the 64-frequency strip, one batch (fewer columns than SMs), T = 1 and 2
# (every halo row is padding), sources split 8 + 24, the widest input
# (64 + 64) -> 64, and C_in 48 (a chunk count that does not divide a
# warpgroup).
@pytest.mark.cuda
@pytest.mark.parametrize("b,channels,cout,t,f", [
    (2, (32,), 32, 37, 50), (2, (16, 16), 32, 37, 50),
    (2, (64, 64), 64, 16, 64), (2, (32,), 64, 9, 33),
    (2, (32,), 32, 70, 130), (1, (32,), 64, 5, 20), (1, (32,), 32, 1, 64),
    (2, (16, 16), 32, 2, 65), (2, (8, 24), 32, 19, 71),
    (2, (64, 64), 64, 11, 131), (1, (64, 64), 64, 1, 7),
    (2, (48,), 64, 6, 33)])
def test_act_conv_matches_plain_on_card(rng, b, channels, cout, t, f):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from lass_torch.ops import act_conv

    _strict_float32()
    cin = sum(channels)
    sources = [_card(rng, b, c, t, f, cl=True) for c in channels]
    w = _card(rng, cout, cin, 3, 3, scale=0.1)
    a = 1 + 0.1 * _card(rng, b, cin)
    bias = 0.1 * _card(rng, b, cin)
    before = act_conv.LAUNCHES
    with torch.no_grad():
        got = act_conv.fused_act_conv3x3(sources, w, a, bias)
        torch.cuda.synchronize()
        ref = act_conv.act_conv3x3_plain(sources, w, a, bias)
    assert act_conv.LAUNCHES == before + 1
    _close_bf16(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("u,t,f", [(32, 37, 50), (32, 64, 56)])
def test_conv_block_matches_plain_on_card(rng, u, t, f):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from lass_torch.ops import convblock

    _strict_float32()
    b = 2
    x = _card(rng, b, u, t, f, cl=True)
    w1, w2 = (_card(rng, u, u, 3, 3, scale=0.1) for _ in range(2))
    vecs = [1 + 0.1 * _card(rng, b, u), 0.1 * _card(rng, b, u),
            1 + 0.1 * _card(rng, b, u), 0.1 * _card(rng, b, u)]
    before = convblock.LAUNCHES
    with torch.no_grad():
        got = convblock.fused_residual_conv_block(x, w1, w2, *vecs)
        torch.cuda.synchronize()
        ref = convblock.residual_conv_block_plain(x, w1, w2, *vecs)
    assert convblock.LAUNCHES == before + 1
    _close_bf16(got, ref, ulps=2)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,t,f", [(128, 64, 5, 9), (64, 32, 8, 16)])
def test_convt_matches_plain_on_card(rng, cin, cout, t, f):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from lass_torch.ops import convt

    _strict_float32()
    b = 2
    x = _card(rng, b, cin, t, f, cl=True)
    inv = 1 + 0.1 * _card(rng, cin)
    shift = 0.1 * _card(rng, cin)
    beta = 0.1 * _card(rng, b, cin)
    w = _card(rng, cin, cout, 2, 2, scale=0.1)
    before = convt.LAUNCHES
    with torch.no_grad():
        got = convt.fused_act_convT(x, inv, shift, beta, w)
        torch.cuda.synchronize()
        ref = convt.act_convT_plain(x, inv, shift, beta, w)
    assert convt.LAUNCHES == before + 1
    assert got.shape == (b, cout, 2 * t, 2 * f)
    _close_bf16(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [1, 2])
def test_head_mask_matches_plain_on_card(rng, cout):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _strict_float32()
    b, c, t, f = 2, 32, 37, 50
    h = _card(rng, b, c, t + 3, f, cl=True)  # read for its first t rows
    w = _card(rng, 3 * cout, c, 1, 1, scale=0.3)
    bias = 0.1 * _card(rng, 3 * cout)
    re, im = (_card(rng, b, 1, t, f + 1)[..., :f + 1] for _ in range(2))
    before = masking.HEAD_LAUNCHES
    got = masking.apply_head_mask(h, w, bias, re, im, cout)
    torch.cuda.synchronize()
    assert masking.HEAD_LAUNCHES == before + 1
    ref = masking.head_mask_plain(h, w, bias, re, im, cout)
    for g, r in zip(got, ref):
        assert g.shape == (b * cout, t, f) and g.is_contiguous()
        assert (g - r).abs().max().item() <= 1e-4 * max(
            1.0, r.abs().max().item())


@pytest.mark.cuda
def test_head_mask_gradient_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _strict_float32()
    b, c, t, f = 1, 32, 5, 24
    h = _card(rng, b, c, t, f, cl=True).requires_grad_(True)
    w = _card(rng, 3, c, 1, 1, scale=0.3).requires_grad_(True)
    bias = (0.1 * _card(rng, 3)).requires_grad_(True)
    re, im = (_card(rng, b, 1, t, f + 1) for _ in range(2))

    def grads(fn):
        r, i = fn(h, w, bias, re, im, 1)
        return torch.autograd.grad((r ** 2 + 0.5 * i).sum(), (h, w, bias))

    for g, r in zip(grads(masking.apply_head_mask),
                    grads(masking.head_mask_plain)):
        assert (g.float() - r.float()).abs().max().item() <= 2e-4 * max(
            1.0, r.float().abs().max().item())


# ---------------------------------------------------------------------------
# B2, the six-input mode of the mask kernel (float32: 1e-5 of max(1, max
# |plain|), as B1), and B7, the time-tap conv (bf16 output: one bf16 unit
# of the largest output, as the fused convs).
# ---------------------------------------------------------------------------


def _mag_cos_sin(re, im):
    mag = torch.sqrt(torch.clamp(re * re + im * im, min=1e-10))
    return mag, re / mag, im / mag


@pytest.mark.cuda
@pytest.mark.parametrize("shape,strided", [((3, 37, 257), False),
                                           ((4, 101, 512), True)])
def test_mask_b2_matches_plain_on_card(rng, shape, strided):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    n, t, f = shape
    if strided:  # logits as channel slices, the mixture cropped 513 -> 512
        logits = _card(rng, n, 3, t + 5, f)[:, :, :t]
        args = [logits[:, k] for k in range(3)] + [
            a[..., :f] for a in _mag_cos_sin(_card(rng, n, t, f + 1),
                                             _card(rng, n, t, f + 1))]
    else:
        args = [_card(rng, n, t, f) for _ in range(3)] + list(
            _mag_cos_sin(_card(rng, n, t, f), _card(rng, n, t, f)))
    before = masking.B2_LAUNCHES
    got = masking.apply_complex_mask(*args)
    torch.cuda.synchronize()
    assert masking.B2_LAUNCHES == before + 1
    ref = masking.mask_math(*args)
    for g, r in zip(got, ref):
        assert g.is_contiguous()
        assert (g - r).abs().max().item() <= 1e-5 * max(
            1.0, r.abs().max().item())


@pytest.mark.cuda
def test_mask_b2_gradient_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args = [_card(rng, 2, 5, 64) for _ in range(3)] + list(
        _mag_cos_sin(_card(rng, 2, 5, 64), _card(rng, 2, 5, 64)))
    args = [a.detach().requires_grad_(True) for a in args]

    def grads(fn):
        r, i = fn(*args)
        return torch.autograd.grad((r ** 2 + 0.5 * i).sum(), args)

    for g, r in zip(grads(masking.apply_complex_mask),
                    grads(masking.mask_math)):
        assert (g - r).abs().max().item() <= 1e-5 * max(
            1.0, r.abs().max().item())


# The last five shapes are the persistent schedule's edges: one batch
# (fewer units than warpgroups), T = 1 and 2 (every halo row is padding),
# T off t_tile and G off the 64-position block, at each C.
@pytest.mark.cuda
@pytest.mark.parametrize("shape,t_tile", [((2, 37, 5, 128), 16),
                                          ((1, 70, 3, 128), 32),
                                          ((2, 9, 7, 64), 64),
                                          ((1, 33, 4, 32), 16),
                                          ((1, 1, 70, 128), 16),
                                          ((1, 2, 64, 64), 32),
                                          ((3, 45, 130, 32), 64),
                                          ((1, 300, 65, 128), 16),
                                          ((2, 17, 64, 64), 16)])
@pytest.mark.parametrize("act", [False, True])
def test_timetap_conv_matches_plain_on_card(rng, shape, t_tile, act):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from lass_torch.ops import timetap_conv as tt_mod

    _strict_float32()
    c = shape[3]
    x = _card(rng, *shape).to(torch.bfloat16)
    w3 = _card(rng, 3 * c, c, scale=(3 * c) ** -0.5).to(torch.bfloat16)
    before = tt_mod.LAUNCHES
    with torch.no_grad():
        got = tt_mod.timetap_conv(x, w3, act, t_tile)
        torch.cuda.synchronize()
        ref = tt_mod.timetap_conv_plain(x, w3, act)
    assert tt_mod.LAUNCHES == before + 1
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    scale = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= BF16_ULP * scale

