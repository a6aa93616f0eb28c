"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``lass_torch/csrc/*.cu`` source (with the ``*.cuh`` headers it
includes) is compiled to an object by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds). The
library lands in ``lass_torch/_build/``, named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is loaded as it
is. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build took (0.0 when an existing library was loaded)
last_build_seconds = 0.0


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda); "
        "the CUDA toolkit is needed to build lass_torch/csrc")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run(procs) -> str:
    """Wait for every (cmd, Popen), then raise if any failed."""
    done = [(cmd, proc, *proc.communicate()) for cmd, proc in procs]
    for cmd, proc, stdout, stderr in done:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    return "".join(stdout + stderr for _, _, stdout, stderr in done)


def _compile(nvcc: str, sources, out_path: str, verbose: bool) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objects, procs = [], []
        for src in sources:  # one nvcc per source, all at once
            obj = os.path.join(tmp_dir, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-c", "-o", obj, src]
            objects.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        report = _run(procs)
        lib_tmp = os.path.join(tmp_dir, "lib.so")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objects]
        report += _run([(link, subprocess.Popen(
            link, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))])
        if verbose:
            print(report, end="", flush=True)
        os.replace(lib_tmp, out_path)  # atomic: readers never see half a file


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """Build (when needed) and load the kernel library; returns the CDLL.

    verbose=True prints ptxas' register and spill report on a fresh build.
    """
    global _lib, last_build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        out_path = os.path.join(BUILD_DIR, f"liblass_kernels_{_digest(sources)}.so")
        start = time.perf_counter()
        if not os.path.exists(out_path):
            _compile(find_nvcc(), sources, out_path, verbose)
            last_build_seconds = time.perf_counter() - start
        lib = ctypes.CDLL(out_path)
        declare(lib)
        _lib = lib
        return lib


_I64, _PTR = ctypes.c_int64, ctypes.c_void_p
# argument types of each C entry point (pointers and the stream as void*,
# sizes and strides as int64); every one returns a CUDA error code
ARGTYPES = {
    "lass_apply_complex_mask_ri": [_PTR, _I64, _I64] * 5 + [
        _PTR, _PTR] + [_I64] * 9 + [_PTR],
    "lass_apply_complex_mask": [_PTR, _I64, _I64] * 6 + [
        _PTR, _PTR] + [_I64] * 9 + [_PTR],
    "lass_act_conv3x3": [_PTR, _I64, _I64, _I64, _I64] * 2 + [
        _PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        _PTR],
    "lass_residual_conv_block": [_PTR, _I64, _I64, _I64] + [_PTR] * 5 + [
        _PTR, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _PTR],
    "lass_act_convt": [_PTR, _I64, _I64, _I64] + [_PTR] * 5 + [_I64] * 8 + [
        _PTR],
    "lass_head_mask": [_PTR, _I64, _I64, _I64, _I64, _PTR, _PTR, _I64, _PTR,
                       _I64, _I64, _PTR, _I64, _I64, _PTR, _PTR, _I64, _I64,
                       _I64, _PTR],
    "lass_timetap_conv": [_PTR] * 3 + [_I64] * 6 + [_PTR],
}


def declare(lib: ctypes.CDLL, names=None) -> None:
    """Set the argument and result types of lib's entry points (all of
    ARGTYPES, or those named)."""
    for name in names or ARGTYPES:
        fn = getattr(lib, name)
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
