"""Window functions (numpy, host-side), copied from the JAX package."""
import numpy as np


def hann_window(win_length: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, matching
    ``scipy.signal.get_window('hann', N, fftbins=True)`` /
    ``torch.hann_window(N, periodic=True)``.
    """
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a window to ``size`` samples (librosa.util.pad_center)."""
    n = len(window)
    if n > size:
        raise ValueError(f"window length {n} > target size {size}")
    lpad = (size - n) // 2
    out = np.zeros(size, dtype=window.dtype)
    out[lpad:lpad + n] = window
    return out


def get_window(name: str, win_length: int) -> np.ndarray:
    if name == "hann":
        return hann_window(win_length)
    raise NotImplementedError(f"window '{name}' not supported")
