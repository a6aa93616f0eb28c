"""Full float32 arithmetic on the card: the JAX package runs its DSP
front ends (log-mel, resampling) and its float32 references at
``Precision.HIGHEST``, where cuBLAS and cuDNN would otherwise be free to
use TF32."""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def ieee_float32() -> Iterator[None]:
    """cuBLAS matmuls and cuDNN convs in IEEE float32 (TF32 off) inside the
    block; both flags are restored after it. The flags are process-wide."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
