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
