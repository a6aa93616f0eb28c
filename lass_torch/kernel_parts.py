"""Where the time of the fused residual conv block (B4) and of the fused
act + transposed conv (B5) goes, on one NVIDIA GPU:

    python -m lass_torch.kernel_parts [--iters 5]

Each kernel is rebuilt with one part of its step taken out (the input
loads, the output stores, an activation, a product chain) and timed
against the unchanged build at its serving shape (B=16 clips of 10 s),
the builds in turns, forward and back. A build with a part taken out
computes a wrong result; only its time is read. Beside them, the tensor
cores alone (``csrc/probe/wgmma_chain.cu``): the products the kernels
issue, looped on zeroed shared memory at one, two and four warpgroups
per SM. One JSON line each, ms per call (CUDA events, the median of
runs of back-to-back calls). Needs a card: there is no CPU measurement.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
from typing import Dict, List

import torch

from lass_torch.microbench_tridiag import cuda_ms
from lass_torch.ops import _build, convblock, convt

PROBE_SRC = os.path.join(_build.CSRC_DIR, "probe", "wgmma_chain.cu")
PARTS_DIR = os.path.join(_build.BUILD_DIR, "parts")

# (part, text of the kernel source, what replaces it); a part of several
# edits lists them all
_ZERO_ACC = "        for (int i = 0; i < U / 2; ++i) acc[i] = 0.0f;"
_CONV1 = ("        sm90::mma_taps<U, KK, true, 9>(acc, KK, a1_addr, NoOp(), "
          "w_s);")
_CONV2 = ("      sm90::mma_taps<U, KK, true, 9>(acc, KK, a2_addr, NoOp(),\n"
          "                                     w_s + S::kW1);")
PARTS = {
    "fused_residual_conv_block": ("convblock.cu", {
        "x loads": [("            sm90::cp_async16(slot + chunk_off[k],\n"
                     "                             xb + r * p.st + "
                     "(f0 - 2 + j) * p.sf);",
                     "            sm90::st_shared_zero16(slot + "
                     "chunk_off[k]);")],
        "output stores": [("        lass::store8(orow + (f0 + m) * p.of, "
                           "vx);",
                           "        if (vx[0] == 12345.f) "
                           "lass::store8(orow + (f0 + m) * p.of, vx);")],
        "x activation": [("      activate(r + 1);\n", "")],
        "conv1": [(_CONV1, _ZERO_ACC)],
        "conv2": [(_CONV2, _ZERO_ACC)],
        "both convs": [(_CONV1, _ZERO_ACC), (_CONV2, _ZERO_ACC)],
    }),
    "fused_act_convT": ("convt.cu", {
        "x loads": [("          sm90::cp_async16(slot + chunk_off[k], "
                     "xr + fj * p.sf);",
                     "          sm90::st_shared_zero16(slot + "
                     "chunk_off[k]);")],
        "output stores": [("        *reinterpret_cast<uint4*>(orow + "
                           "(2 * (f0 + r) + oj) * p.of) = v[k];",
                           "        if (v[k].x == 0x7fc07fc1u) "
                           "*reinterpret_cast<uint4*>(orow + (2 * (f0 + r) "
                           "+ oj) * p.of) = v[k];")],
        "activation": [("      *reinterpret_cast<uint4*>(slot + "
                        "chunk_off[k]) = raw[k];\n", "")],
        "products": [("    sm90::mma_chain<N, KK>(acc, fa, w_s);  "
                      "// phase i = 0",
                      "    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;"),
                     ("    sm90::mma_chain<N, KK>(acc, fa, w_s + CIN * N "
                      "* 2);  // phase i = 1", "")],
    }),
}


def _variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"kernel_parts: the kernel source no longer "
                               f"holds {old!r}; update PARTS")
        src = src.replace(old, new)
    return src


def _build_all(jobs: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """{name: CUDA source text} -> {name: loaded library}, one nvcc each,
    all at once, into lass_torch/_build/parts/."""
    os.makedirs(PARTS_DIR, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = []
    for name, text in jobs.items():
        stem = os.path.join(PARTS_DIR, name.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-shared",
               "-o", stem + ".so", stem + ".cu"]
        procs.append((name, stem, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, stem, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
        libs[name] = ctypes.CDLL(stem + ".so")
    return libs


@contextlib.contextmanager
def _library(lib: ctypes.CDLL):
    """Let the wrappers launch from ``lib`` instead of the built library."""
    _build.load_library()
    saved = _build._lib
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = saved


def _serving_calls(seed: int = 0):
    """{kernel: [(label, fn, args)]} at the serving shapes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0, around=0.0):
        return around + scale * torch.randn(*shape, generator=gen,
                                            device="cuda")

    def act(b, c, t, f):
        return randn(b, c, t, f).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

    u, b = 32, 16
    calls = {"fused_residual_conv_block": [(
        "32 at 16x1024x512", convblock.fused_residual_conv_block,
        (act(b, u, 1024, 512), randn(u, u, 3, 3, scale=(9 * u) ** -0.5),
         randn(u, u, 3, 3, scale=(9 * u) ** -0.5),
         randn(b, u, scale=0.1, around=1.0), randn(b, u, scale=0.1),
         randn(b, u, scale=0.1, around=1.0), randn(b, u, scale=0.1)))],
        "fused_act_convT": []}
    for cin, cout, t, f in [(128, 64, 256, 128), (64, 32, 512, 256)]:
        calls["fused_act_convT"].append((
            f"{cin}->{cout} at 16x{t}x{f}", convt.fused_act_convT,
            (act(b, cin, t, f), randn(cin, scale=0.1, around=1.0),
             randn(cin, scale=0.1), randn(b, cin, scale=0.1),
             randn(cin, cout, 2, 2, scale=cin ** -0.5))))
    return calls


def run(iters: int = 5) -> List[Dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_parts needs an NVIDIA GPU")
    jobs = {"wgmma_chain": open(PROBE_SRC).read()}
    for kernel, (source, parts) in PARTS.items():
        with open(os.path.join(_build.CSRC_DIR, source)) as f:
            src = f.read()
        for part, edits in parts.items():
            jobs[f"{kernel}-{part}"] = _variant_source(src, edits)
    libs = _build_all(jobs)
    for name, lib in libs.items():
        if name != "wgmma_chain":
            _build.declare(lib, [n for n in _build.ARGTYPES
                                 if hasattr(lib, n)])
    rows = []
    chain = libs["wgmma_chain"].lass_wgmma_chain
    chain.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_int64, ctypes.c_void_p]
    chain.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.empty(4 * sms * 128, device="cuda")
    loops = 2000
    for mode, what, flop in [
            (0, "6 x m64n96k16, A and B from shared memory, one group",
             6 * 2 * 64 * 96 * 16),
            (1, "9 chained pairs of m64n32k16, A from registers",
             18 * 2 * 64 * 32 * 16)]:
        for per_sm in (1, 2, 4):
            def launch():
                err = chain(mode, sink.data_ptr(), per_sm * sms, loops,
                            torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"wgmma_chain launch: CUDA {err}")
            ms = cuda_ms(launch, iters, reps=2)
            rows.append({"op": "wgmma_chain", "products": what,
                         "warpgroups_per_sm": per_sm, "ms": ms,
                         "tflop_per_s": per_sm * sms * loops * flop
                         / (ms * 1e-3) / 1e12})
    with torch.inference_mode():
        for kernel, calls in _serving_calls().items():
            names = ["whole kernel"] + list(PARTS[kernel][1])
            for label, fn, args in calls:
                times = {n: [] for n in names}
                for order in (names, names[::-1]):
                    for name in order:
                        lib = (_build.load_library() if name == names[0]
                               else libs[f"{kernel}-{name}"])
                        with _library(lib):
                            times[name].append(cuda_ms(lambda: fn(*args),
                                                       iters))
                for name in names:
                    rows.append({"op": kernel, "shape": label,
                                 "without": None if name == names[0]
                                 else name, "ms": min(times[name]),
                                 "turns_ms": times[name]})
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m lass_torch.kernel_parts")
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args(argv)
    print(json.dumps({"device": torch.cuda.get_device_name(0)
                      if torch.cuda.is_available() else None}), flush=True)
    for row in run(args.iters):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
