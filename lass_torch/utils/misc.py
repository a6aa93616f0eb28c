"""Small parity utilities (reference utils.py odds and ends; a copy of
lass_tpu/utils/misc.py)."""
from __future__ import annotations

import numpy as np


def ids_to_hots(ids, classes_num: int) -> np.ndarray:
    """Index list -> multi-hot vector (reference utils.py:141-145)."""
    hots = np.zeros(classes_num, np.float32)
    for i in ids:
        hots[i] = 1.0
    return hots


def float32_to_int16(x: np.ndarray) -> np.ndarray:
    return np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)


def int16_to_float32(x: np.ndarray) -> np.ndarray:
    return (x / 32768.0).astype(np.float32)


def magnitude_to_db(x: float, eps: float = 1e-10) -> float:
    return 20.0 * np.log10(max(x, eps))


def db_to_magnitude(d: float) -> float:
    return float(10.0 ** (d / 20.0))
