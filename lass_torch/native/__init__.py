"""The port's native WAV and FLAC decoders (``lassio.cpp``, a copy of the
JAX package's native/lassio.cpp with a plain C interface), built at first
use and bound with ctypes.

``g++ -O3 -shared -fPIC -std=c++17`` compiles ``lassio.cpp`` into
``lass_torch/_build/liblassio_<hash of the source and flags>.so`` the first
time a decoder is called (a few seconds), so an edited source rebuilds and
an unchanged one is loaded as it is; the library is written under a
temporary name and renamed, so processes building at once never load half
a file. A failed build raises with the compiler's output: there is no
fallback to the numpy decoders (``lass_torch.audio.io.read_wav_bytes_plain``
and ``lass_torch.audio.flac.decode_flac_bytes``, which the tests hold this
one to). Decoding runs without the interpreter lock (a ctypes call), so
loader threads decode in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "lassio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(SOURCE)), "_build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"liblassio_{h.hexdigest()[:16]}.so")


def load_library() -> ctypes.CDLL:
    """Build (when needed) and load the decoder library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                out = os.path.join(tmp, "liblassio.so")
                cmd = ["g++", *FLAGS, "-o", out, SOURCE]
                try:
                    proc = subprocess.run(cmd, capture_output=True,
                                          text=True, timeout=300)
                except FileNotFoundError as exc:
                    raise RuntimeError(
                        "g++ not found: it builds the native audio "
                        "decoders (lass_torch/native/lassio.cpp)") from exc
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"building the native audio decoders failed "
                        f"({proc.returncode}): {' '.join(cmd)}\n"
                        f"{proc.stdout}\n{proc.stderr}")
                os.replace(out, path)
        lib = ctypes.CDLL(path)
        lib.lassio_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_char_p)]
        lib.lassio_decode.restype = ctypes.c_void_p
        lib.lassio_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.lassio_take.restype = None
        _lib = lib
        return lib


def _decode(payload: bytes, flac: bool, mono: bool
            ) -> Tuple[np.ndarray, int]:
    lib = load_library()
    payload = bytes(payload)  # kept alive until lassio_take returns
    shape = (ctypes.c_int64 * 3)()
    err = ctypes.c_char_p()
    handle = lib.lassio_decode(payload, len(payload), int(flac), int(mono),
                               shape, ctypes.byref(err))
    if not handle:
        raise ValueError(err.value.decode())
    out = np.empty((shape[0], shape[1]), np.float32)
    lib.lassio_take(handle, out.ctypes.data)
    return out, int(shape[2])


def decode_wav(payload: bytes, mono: bool = False) -> Tuple[np.ndarray, int]:
    """A RIFF/WAVE payload -> ((channels, samples) float32 in [-1, 1], rate);
    one channel, the channels' mean, with ``mono``. Raises ValueError on a
    malformed or unsupported payload."""
    return _decode(payload, False, mono)


def decode_flac(payload: bytes, mono: bool = False) -> Tuple[np.ndarray, int]:
    """A FLAC stream -> ``decode_wav``'s contract."""
    return _decode(payload, True, mono)
