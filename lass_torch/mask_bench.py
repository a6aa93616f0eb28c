"""Time the mask kernels alone on one NVIDIA GPU:

    python -m lass_torch.mask_bench [--sass]

B1 (``apply_complex_mask_ri``) at the views the serving forward hands it
(16 clips of 10 s: (16, 1001, 512), logits as channel slices of
(16, 3, 1024, 512), the spectrum's rows 513 floats apart) and at the
precomputed-STFT variants' views ((16, 1001, 256), the spectrum's rows 257
floats apart); B2 (``apply_complex_mask``) at the serving views with the
mixture as contiguous mag/cos/sin; B6 (``apply_head_mask``) at the serving
head. One JSON line each, in ms per call:

- ``profiler_ms``: the kernel's own duration by ``torch.profiler`` (CUPTI),
  the median over the launches of one window; ``null`` where the profiler
  sees no device time;
- ``graph_ms``: CUDA events around a CUDA graph of ``LAUNCHES`` calls
  through the wrapper, the median of several replays over the count (any
  small kernel the wrapper adds is in it, and the gaps between launches);
- ``device_ms``: the first of those two that was read;
- ``host_us``: the wrapper's host time per call, a run of calls issued
  without a synchronise;
- ``wrapper_ms``: CUDA events around back-to-back calls through the
  wrapper (the host between launches included where it is slower than the
  card);
- ``bound_ms`` (bytes or operations, each input read once and each output
  written once) and ``share`` = bound / device time.

``--sass`` adds, per instance of each kernel, its registers and spills and
its SASS instruction count by ``cuobjdump`` on the built library.
``--variants`` rebuilds ``csrc/masking.cu`` with one design choice changed
at a time (``VARIANTS``: the launch bounds, 8 bins a thread, 16-byte
loads on the rows that are aligned, or the unaligned rows as aligned
16-byte loads shifted across lanes) and times B1 at both views and B2,
each with its largest error against its plain version, the builds in
turns forward and back (the shift variant only at B1's views, whose
warps each lie in one row).
Needs a card: there is no CPU measurement.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, float32 outside tensor cores
# floating-point operations of the mask chain per element, counting each
# sqrt, division, exp and tanh as one (lass_torch/csrc/mask_math.cuh)
MASK_FLOPS_PER_ELEMENT = 30
LAUNCHES = 10  # calls per graph and per events window
# the kernels' names as the profiler reports them
B1_B2_KERNEL = "apply_complex_mask_kernel"
B6_KERNEL = "head_mask_kernel"


def profiler_ms(fn: Callable, kernel: str, calls: int = 3 * LAUNCHES
                ) -> Optional[float]:
    """Median duration of the launches of ``kernel`` (a substring of its
    name) over ``calls`` calls of ``fn``, by ``torch.profiler``; None where
    the profiler records no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    return statistics.median(times) / 1e3 if times else None


def graph_ms(fn: Callable, launches: int = LAUNCHES, reps: int = 7
             ) -> float:
    """CUDA events around a CUDA graph of ``launches`` calls of ``fn``:
    the median of ``reps`` replays, per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


def host_us(fn: Callable, calls: int = 5 * LAUNCHES) -> float:
    """The wrapper's host time per call: ``calls`` calls issued back to
    back without a synchronise (the card drains its queue after)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def wrapper_ms(fn: Callable, iters: int = 10, reps: int = LAUNCHES
               ) -> float:
    """CUDA events around ``reps`` back-to-back calls through the wrapper,
    the median of ``iters`` runs, per call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_time(fn: Callable, kernel: str) -> Dict[str, Optional[float]]:
    """The readings above for ``fn``, one call of which launches ``kernel``
    once. Runs under ``torch.inference_mode``."""
    with torch.inference_mode():
        prof = profiler_ms(fn, kernel)
        graph = graph_ms(fn)
        host = host_us(fn)
        wrapped = wrapper_ms(fn)
    return {"device_ms": graph if prof is None else prof,
            "profiler_ms": prof, "graph_ms": graph, "host_us": host,
            "wrapper_ms": wrapped}


def mask_bound(inputs: int, elements: int) -> Dict[str, float]:
    """Bound of the mask apply over ``elements`` with ``inputs`` float32
    inputs and two float32 outputs."""
    bytes_ms = 4 * (inputs + 2) * elements / HBM_BYTES_PER_S * 1e3
    flops_ms = MASK_FLOPS_PER_ELEMENT * elements / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "bytes": 4 * (inputs + 2) * elements}


def serving_views(device: str = "cuda", b: int = 16, t: int = 1001,
                  t_pad: int = 1024, f: int = 512, seed: int = 0):
    """B1's five inputs as a forward hands them over: channel slices of
    (B, 3, T_pad, f) float32 logits cropped to T, and the (B, 1, T, f + 1)
    spectrum cropped to f bins (rows f + 1 floats apart). At f = 512 the
    serving forward's; at f = 256 the variants' (logits (B, 3, T, 256),
    the rebuilt 257-bin spectrum)."""
    from lass_torch.models.resunet import mask_inputs

    gen = torch.Generator(device=device).manual_seed(seed)
    logits = 3 * torch.randn(b, 3, t_pad, f, generator=gen, device=device)
    re_ = torch.randn(b, 1, t, f + 1, generator=gen, device=device)
    im = torch.randn(b, 1, t, f + 1, generator=gen, device=device)
    return mask_inputs(logits[:, :, :t], re_, im, 1)


def mag_cos_sin(re_: torch.Tensor, im: torch.Tensor):
    """The mixture terms B2 takes precomputed (contiguous)."""
    mag = torch.sqrt(torch.clamp(re_ * re_ + im * im, min=1e-10))
    return mag, re_ / mag, im / mag


# (label, (N, T, F), the logits' layout, the mixture's layout): the
# layouts the mask kernels are held to on the card (tests/
# test_torch_kernels_cuda.py and chip_smoke.py phase 3). Layouts:
# "contiguous"; "slices", the three logits as channel slices of one
# (N, 3, T + 11, F) tensor; "crop", rows F + 1 floats apart cropped to F;
# "offsetK", contiguous rows whose storage starts K floats past 16 bytes.
MASK_LAYOUTS = [
    ("serving views", (16, 1001, 512), "slices", "crop"),
    ("variants' views", (16, 1001, 256), "contiguous", "crop"),
    ("mixture 1 float off 16 bytes", (3, 37, 512), "contiguous", "offset1"),
    ("mixture 2 floats off 16 bytes", (3, 37, 512), "slices", "offset2"),
    ("mixture 3 floats off 16 bytes", (3, 37, 257), "contiguous",
     "offset3"),
    ("F = 1", (2, 7, 1), "contiguous", "crop"),
    ("F = 5", (2, 7, 5), "slices", "crop"),
    ("F = 257", (3, 37, 257), "contiguous", "contiguous"),
    ("F = 512", (4, 101, 512), "contiguous", "contiguous"),
    ("T = 1", (5, 1, 512), "slices", "crop"),
    ("70000 rows", (1, 70000, 4), "contiguous", "crop"),
]


def _place(xs, layout: str):
    """Copies of the (N, T, F) tensors ``xs`` laid out as ``layout``."""
    n, t, f = xs[0].shape
    dev = xs[0].device
    if layout == "contiguous":
        return [x.contiguous() for x in xs]
    if layout == "slices":
        buf = torch.zeros(n, len(xs), t + 11, f, device=dev)
        for k, x in enumerate(xs):
            buf[:, k, :t] = x
        return [buf[:, k, :t] for k in range(len(xs))]
    if layout == "crop":
        out = []
        for x in xs:
            buf = torch.zeros(n, t, f + 1, device=dev)
            buf[..., :f] = x
            out.append(buf[..., :f])
        return out
    if layout.startswith("offset"):
        k = int(layout[len("offset"):])
        out = []
        for x in xs:
            flat = torch.zeros(x.numel() + 4, device=dev)
            assert flat.data_ptr() % 16 == 0
            view = flat[k:k + x.numel()].view(n, t, f)
            view.copy_(x)
            out.append(view)
        return out
    raise ValueError(f"unknown layout {layout!r}")


def layout_inputs(case, six: bool = False, device: str = "cuda",
                  seed: int = 0):
    """The inputs of one ``MASK_LAYOUTS`` case: logits (3 x standard normal)
    and the mixture's raw spectrum (re, im), or with ``six`` its
    mag/cos/sin, from ``seed``."""
    _, shape, logit_layout, mixture_layout = case
    gen = torch.Generator(device=device).manual_seed(seed)
    logits = [3 * torch.randn(*shape, generator=gen, device=device)
              for _ in range(3)]
    re_, im = (torch.randn(*shape, generator=gen, device=device)
               for _ in range(2))
    mixture = list(mag_cos_sin(re_, im)) if six else [re_, im]
    return (*_place(logits, logit_layout),
            *_place(mixture, mixture_layout))


def head_inputs(device: str = "cuda", b: int = 16, t_pad: int = 1024,
                t: int = 1001, f: int = 512, c: int = 32, seed: int = 0):
    """B6's serving inputs: the decoder's (B, 32, T_pad, 512) bf16
    channels_last output, after_conv's weight and bias for one output
    channel, the (B, 1, T, 513) spectrum."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn(b, c, t_pad, f, generator=gen, device=device).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = c ** -0.5 * torch.randn(3, c, 1, 1, generator=gen, device=device)
    bias = 0.1 * torch.randn(3, generator=gen, device=device)
    spec = [torch.randn(b, 1, t, f + 1, generator=gen, device=device)
            for _ in range(2)]
    return h, w, bias, *spec, 1


def cases(device: str = "cuda") -> List[dict]:
    """(label, wrapper, its inputs, kernel name, bound) of each timed
    call."""
    from lass_torch.ops import masking

    serving = serving_views(device)
    variants = serving_views(device, f=256, t_pad=1001, seed=1)
    b2 = (*serving[:3], *mag_cos_sin(serving[3].contiguous(),
                                     serving[4].contiguous()))
    head = head_inputs(device)
    b, _, t, f = head[3].shape
    m = b * t * (f - 1)
    c = head[0].shape[1]
    head_bytes = m * (2 * c + 8 + 8) + 4 * (c + 1) * 3
    head_ops = m * (6 * c + MASK_FLOPS_PER_ELEMENT)
    head_bytes_ms = head_bytes / HBM_BYTES_PER_S * 1e3
    head_ops_ms = head_ops / F32_FLOP_PER_S * 1e3
    return [
        dict(name="apply_complex_mask_ri", label="serving", args=serving,
             fn=masking.apply_complex_mask_ri, kernel=B1_B2_KERNEL,
             **mask_bound(5, serving[0].numel())),
        dict(name="apply_complex_mask_ri", label="variants", args=variants,
             fn=masking.apply_complex_mask_ri, kernel=B1_B2_KERNEL,
             **mask_bound(5, variants[0].numel())),
        dict(name="apply_complex_mask", label="serving", args=b2,
             fn=masking.apply_complex_mask, kernel=B1_B2_KERNEL,
             **mask_bound(6, b2[0].numel())),
        dict(name="apply_head_mask", label="serving", args=head,
             fn=masking.apply_head_mask, kernel=B6_KERNEL,
             bound_ms=max(head_bytes_ms, head_ops_ms),
             bound_by="bytes" if head_bytes_ms >= head_ops_ms
             else "operations", bytes=head_bytes),
    ]


def time_case(case: dict) -> dict:
    """The readings of one case, its shape, bound and share."""
    args, fn = case["args"], case["fn"]
    row = {"name": case["name"], "label": case["label"],
           "shape": list(args[0].shape),
           "row_strides": [a.stride(-2) for a in args
                           if isinstance(a, torch.Tensor) and a.dim() > 1],
           **device_time(lambda: fn(*args), case["kernel"]),
           "bound_ms": case["bound_ms"], "bound_by": case["bound_by"]}
    row["share"] = row["bound_ms"] / row["device_ms"]
    return row


_BOUNDS = "__launch_bounds__(kThreads, kInputs == 5 ? 4 : 3)"
_LOAD_FN = "__device__ __forceinline__ void load_bins("
_STORE_FN = "__device__ __forceinline__ void store_bins("
# the unaligned rows of B1's spectrum as one aligned 16-byte load a lane,
# funnel-shifted from the next lane by the row's misalignment (the warp's
# last lane loads its next chunk itself); needs every lane of a warp in
# one row with whole groups, as at F = 512 and 256
_FUNNEL = """__device__ __forceinline__ void load_bins(const float* p, int valid,
                                          float* v) {
  const int m = static_cast<int>(reinterpret_cast<uintptr_t>(p) >> 2) & 3;
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p - m));
  if (m == 0) {
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    return;
  }
  float4 hi;
  hi.x = __shfl_down_sync(0xffffffffu, lo.x, 1);
  hi.y = __shfl_down_sync(0xffffffffu, lo.y, 1);
  hi.z = __shfl_down_sync(0xffffffffu, lo.z, 1);
  hi.w = __shfl_down_sync(0xffffffffu, lo.w, 1);
  if (((threadIdx.y * blockDim.x + threadIdx.x) & 31) == 31) {
    hi = __ldg(reinterpret_cast<const float4*>(p - m + 4));
  }
  if (m == 1) {
    v[0] = lo.y; v[1] = lo.z; v[2] = lo.w; v[3] = hi.x;
  } else if (m == 2) {
    v[0] = lo.z; v[1] = lo.w; v[2] = hi.x; v[3] = hi.y;
  } else {
    v[0] = lo.w; v[1] = hi.x; v[2] = hi.y; v[3] = hi.z;
  }
}

"""
# the rows that start 16-byte aligned (the logits, B2's mag/cos/sin) as
# 16-byte loads, the others as scalar loads
_VECTOR_ROWS = """__device__ __forceinline__ void load_bins(const float* p, int valid,
                                          float* v) {
  if (valid == kBins && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < kBins; j += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + j));
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBins; ++j) v[j] = j < valid ? __ldg(p + j) : 0.0f;
  }
}

"""
# variant: (edits of csrc/masking.cu as (text, replacement), bins a thread)
VARIANTS = {
    "as built": ([], 4),
    "launch bounds (256)": ([(_BOUNDS, "__launch_bounds__(kThreads)")], 4),
    "launch bounds (256, 4)": ([(_BOUNDS,
                                 "__launch_bounds__(kThreads, 4)")], 4),
    "launch bounds (256, 3)": ([(_BOUNDS,
                                 "__launch_bounds__(kThreads, 3)")], 4),
    "8 bins a thread, launch bounds (256)": (
        [(_BOUNDS, "__launch_bounds__(kThreads)"),
         ("constexpr int kBins = 4;", "constexpr int kBins = 8;")], 8),
    "16-byte loads on aligned rows": ([(_LOAD_FN, _VECTOR_ROWS)], 4),
    "shifted 16-byte loads on unaligned rows": ([(_LOAD_FN, _FUNNEL)], 4),
}


def _variant_text(src: str, edits) -> str:
    """``src`` with each edit made; replacing ``_LOAD_FN`` replaces the
    whole load_bins function."""
    from lass_torch.kernel_parts import _variant_source

    plain = []
    for old, new in edits:
        if old == _LOAD_FN:
            start, end = src.index(_LOAD_FN), src.index(_STORE_FN)
            src = src[:start] + new + src[end:]
        else:
            plain.append((old, new))
    return _variant_source(src, plain)


def run_variants(iters: int = 7) -> List[dict]:
    """Each of ``VARIANTS`` at B1's serving and variants' views and B2's
    serving views: the profiler's kernel time (median of the launches of
    one window), the builds in turns forward and back, and the largest
    error against the plain version."""
    from lass_torch.kernel_parts import _build_all, _library
    from lass_torch.ops import _build, masking

    with open(os.path.join(_build.CSRC_DIR, "masking.cu")) as f:
        src = f.read()
    libs = _build_all({f"masking-{k}": _variant_text(src, edits)
                       for k, (edits, _) in enumerate(VARIANTS.values())})
    for lib in libs.values():
        _build.declare(lib, ["lass_apply_complex_mask_ri",
                             "lass_apply_complex_mask"])
    calls = [c for c in cases() if c["kernel"] == B1_B2_KERNEL]
    names = list(VARIANTS)
    times = {(n, c["name"], c["label"]): [] for n in names for c in calls}
    errors = {}
    with torch.inference_mode():
        for order in (names, names[::-1]):
            for name in order:
                k = names.index(name)
                masking.BINS = VARIANTS[name][1]
                masking.mask_plan.cache_clear()
                try:
                    with _library(libs[f"masking-{k}"]):
                        for c in calls:
                            if name.startswith("shifted") and c[
                                    "name"] != "apply_complex_mask_ri":
                                continue
                            args, fn = c["args"], c["fn"]
                            key = (name, c["name"], c["label"])
                            times[key].append(profiler_ms(
                                lambda: fn(*args), B1_B2_KERNEL,
                                calls=iters))
                            plain = (masking.mask_math_from_ri if len(args)
                                     == 5 else masking.mask_math)
                            got, ref = fn(*args), plain(*args)
                            errors[key] = max(
                                (g - r).abs().max().item()
                                for g, r in zip(got, ref))
                finally:
                    masking.BINS = 4
                    masking.mask_plan.cache_clear()
    rows = []
    for (name, kernel, label), ms in times.items():
        if ms:
            rows.append({"variant": name, "name": kernel, "label": label,
                         "ms": min(ms), "turns_ms": ms,
                         "max_abs_err": errors[(name, kernel, label)]})
    return rows


def sass_report(lib_path: str) -> List[dict]:
    """Per instance of the mask kernels in ``lib_path``: registers, spill
    stores and loads (cuobjdump's resource usage) and the number of SASS
    instructions."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    usage = subprocess.run([tool, "--dump-resource-usage", lib_path],
                           capture_output=True, text=True, check=True,
                           timeout=120).stdout
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    rows = {}
    current = None
    for line in usage.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+)", line)
        if current and m and ("mask" in current):
            rows[current] = {"function": current, "registers": int(m.group(1)),
                             "stack": int(m.group(2))}
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1) if m.group(1) in rows else None
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                     line)
        if current and m and m.group(1) != "NOP":
            row = rows[current]
            row["instructions"] = row.get("instructions", 0) + 1
            if m.group(1) in ("LDG", "STG", "MUFU", "CALL", "SHFL"):
                ops = row.setdefault("by_opcode", {})
                ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return list(rows.values())


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m lass_torch.mask_bench")
    parser.add_argument("--sass", action="store_true",
                        help="also print each mask kernel's registers and "
                             "SASS instruction count")
    parser.add_argument("--variants", action="store_true",
                        help="also time the design variants of "
                             "csrc/masking.cu (VARIANTS)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mask_bench: torch sees no CUDA device")
    from lass_torch.ops import _build

    _build.load_library(verbose=args.sass)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "card": card}), flush=True)
    for case in cases():
        print(json.dumps(time_case(case)), flush=True)
    if args.sass:
        lib = os.path.join(_build.BUILD_DIR, "liblass_kernels_"
                           f"{_build._digest(_build._sources())}.so")
        for row in sass_report(lib):
            print(json.dumps(row), flush=True)
    if args.variants:
        for row in run_variants():
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
