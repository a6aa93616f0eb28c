"""The benchmark's fixed arithmetic: the H100's published peaks, the kernel
families by name, and the mask kernel's bound.

Frozen copies, so that a change to the program cannot move them:

- ``FAMILIES`` / ``family`` from ``lass_torch/profile_forward.py``, with
  one repair: its mask pattern ``apply_complex_mask_ri`` is the C entry
  point's name and matches no kernel the profiler reports; the kernel is
  ``apply_complex_mask_kernel<5>`` (B1) or ``<6>`` (B2,
  ``lass_torch/csrc/masking.cu``).
- ``mask_bound`` from ``lass_torch/mask_bench.py``: bytes 4 * (inputs + 2)
  * elements over the HBM bandwidth, or 30 float32 operations an element
  over the float32 peak, whichever is larger.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
MASK_FLOPS_PER_ELEMENT = 30

B1_KERNEL = "apply_complex_mask_kernel<5>"

FAMILIES = [  # first match wins; matched against the lower-cased name
    ("mask kernel", ("apply_complex_mask_kernel", "apply_complex_mask_ri")),
    ("fused act+conv3x3 kernel", ("act_conv3x3",)),
    ("fused conv block kernel", ("residual_conv_block",)),
    ("fused act+convT kernel", ("act_convt",)),
    ("fused head+mask kernel", ("head_mask",)),
    ("optimizer (AdamW)", ("multi_tensor", "foreach", "adam")),
    ("batch norm (train)", ("batch_norm", "batchnorm", "welford", "bn_fw_",
                            "bn_bw_")),
    ("softmax", ("softmax",)),
    ("layer norm", ("layer_norm", "layernorm")),
    ("overlap-add (fold)", ("col2im", "im2col")),
    ("conv", ("conv", "cudnn", "implicit", "fprop", "nchwtonhwc",
              "nhwctonchw", "dgrad", "wgrad", "fft2d_", "gemm_cf32")),
    ("fft", ("fft",)),
    ("matmul", ("gemm", "cutlass", "cublas", "matmul")),
    ("elementwise/reduce", ("elementwise", "vectorized", "unrolled",
                            "reduce", "cat", "pool", "copy", "fill")),
]
NCCL = ("nccl",)


def family(name: str) -> str:
    low = name.lower()
    if any(k in low for k in NCCL):
        return "collective"
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def mask_bound(inputs: int, elements: int) -> Dict[str, float]:
    """Least time of the mask apply over ``elements`` with ``inputs``
    float32 inputs and two float32 outputs, each byte moved once."""
    nbytes = 4 * (inputs + 2) * elements
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = MASK_FLOPS_PER_ELEMENT * elements / PEAK_FLOPS["float32"]
    return {"bound_s": max(bytes_s, ops_s), "bytes": nbytes,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}
