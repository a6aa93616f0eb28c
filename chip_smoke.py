"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure raises and the script exits non-zero:

1. card: name, power limit, torch/CUDA versions, compute capability;
   TF32 off for the float32 phases;
2. build the CUDA kernels from lass_torch/csrc (nvcc, at first use);
3. each kernel against its plain PyTorch version at the serving shapes
   (B=16 clips of 10 s) and at a ragged shape, plus a gradient case;
4. serve: ``load_ss_model`` on a random-weight full-width ResUNet30
   (config/audiosep_base.yaml, bf16) with the full RoBERTa-base caption
   encoder, four requests of 10 s, 4.5 s and 1 s, one caption repeated so
   that it hits the caption cache; launch counts reset just before and
   read just after;
5. the same weights in float32, B=2 x 1 s, on the card and on the CPU;
6. times with CUDA events: the B=16 x 10 s bf16 forward, caption encoding,
   each kernel against its bound and its plain version.

The last lines are the kernels' JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``; the lines before them give
every other measured number.
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, float32 outside tensor cores
# floating-point operations of the mask chain per element, counting each
# sqrt, division, exp and tanh as one (see lass_torch/csrc/masking.cu)
MASK_FLOPS_PER_ELEMENT = 30
SERVE_REQUESTS = [("a dog barking", 10.0), ("rain falling on a tin roof", 4.5),
                  ("a man speaking over traffic", 1.0), ("a dog barking", 4.5)]


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3):
    """Median milliseconds of fn() on the current stream, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, ref):
    return max((g.float() - r.float()).abs().max().item()
               for g, r in zip(got, ref))


def serving_mask_inputs(device, b=16, seconds=10.0, t_pad=1024, seed=0):
    """The mask kernel's inputs as the serving forward hands them over:
    channel slices of (B, 3, T_pad, 512) logits cropped to T and the
    (B, 1, T, 513) spectrum cropped to 512 bins."""
    import torch

    from lass_torch.models.resunet import mask_inputs

    t = int(seconds * 16000) // 160 + 1
    gen = torch.Generator(device=device).manual_seed(seed)
    logits = 3 * torch.randn(b, 3, t_pad, 512, generator=gen, device=device)
    re = torch.randn(b, 1, t, 513, generator=gen, device=device)
    im = torch.randn(b, 1, t, 513, generator=gen, device=device)
    return mask_inputs(logits[:, :, :t], re, im, 1)


def check_mask_kernel(device):
    """Phase 3: kernel vs plain at the serving views, a contiguous 4-wide
    case and a ragged scalar case; a gradient through the autograd.Function.
    Returns the largest error at the serving shape."""
    import torch

    from lass_torch.ops import masking

    def compare(args, what):
        got = masking.apply_complex_mask_ri(*args)
        torch.cuda.synchronize()
        ref = masking.mask_math_from_ri(*args)
        err = max_err(got, ref)
        scale = max(1.0, max(r.abs().max().item() for r in ref))
        log(f"mask kernel vs plain, {what}: max abs err {err:.3e} "
            f"(limit {1e-5 * scale:.3e})")
        if not err <= 1e-5 * scale:
            raise AssertionError(f"mask kernel disagrees at {what}")
        return err

    serving = serving_mask_inputs(device)
    err = compare(serving, f"serving views {tuple(serving[0].shape)}")
    gen = torch.Generator(device=device).manual_seed(1)
    for shape in [(3, 37, 257), (4, 101, 512)]:
        args = [torch.randn(*shape, generator=gen, device=device)
                for _ in range(5)]
        compare(args, f"contiguous {shape}")
    args = [torch.randn(2, 5, 64, generator=gen, device=device,
                        requires_grad=True) for _ in range(5)]
    r, i = masking.apply_complex_mask_ri(*args)
    grads = torch.autograd.grad((r ** 2 + 0.5 * i).sum(), args)
    r2, i2 = masking.mask_math_from_ri(*args)
    grads_ref = torch.autograd.grad((r2 ** 2 + 0.5 * i2).sum(), args)
    gerr = max_err(grads, grads_ref)
    log(f"mask kernel gradient vs plain: max abs err {gerr:.3e}")
    if not gerr <= 1e-5:
        raise AssertionError("mask kernel gradient disagrees")
    return err


def build_server(device, ckpt_dir):
    """load_ss_model on a random-weight checkpoint written with the port's
    own saver, full width from config/audiosep_base.yaml."""
    import torch

    from lass_torch.config import load_config
    from lass_torch.convert.checkpoint_io import (
        load_ss_model, save_ss_checkpoint)
    from lass_torch.models.resunet import build_model

    cfg = load_config(os.path.join(REPO, "config", "audiosep_base.yaml"))
    torch.manual_seed(0)
    path = os.path.join(ckpt_dir, "random_resunet30.ckpt")
    save_ss_checkpoint(build_model(cfg), path)
    try:
        return cfg, load_ss_model(cfg, path, device=device)
    finally:
        os.remove(path)


def serve(sep, requests, sampling_rate=16000, seed=0):
    """Phase 4: answer the requests; each forward must launch the mask
    kernel once. Returns the per-request seconds."""
    import numpy as np

    from lass_torch.ops import masking

    rng = np.random.RandomState(seed)
    on_card = next(sep.model.parameters()).is_cuda
    seconds = []
    for caption, dur in requests:
        length = int(dur * sampling_rate)
        mixture = (0.1 * rng.randn(1, 1, length)).astype(np.float32)
        before = masking.LAUNCHES
        start = time.perf_counter()
        cond = sep.query_encoder.get_query_embed("text", text=[caption])
        out = sep.separate(mixture, cond)
        seconds.append(time.perf_counter() - start)
        if out.shape != (1, 1, length) or not np.isfinite(out).all():
            raise AssertionError(f"bad output for {caption!r}: {out.shape}")
        if on_card and masking.LAUNCHES != before + 1:
            raise AssertionError("a forward did not launch the mask kernel")
        log(f"request {caption!r} {dur} s: {seconds[-1] * 1e3:.1f} ms, "
            f"peak |y| {np.abs(out).max():.4f}")
    if sep.query_encoder.embed_cache_hits < 1:
        raise AssertionError("the repeated caption missed the caption cache")
    return seconds


def card_vs_cpu(sep, device):
    """Phase 5: float32 copies of the served weights, B=2 x 1 s, on the
    card and on the CPU. Returns the relative error."""
    import numpy as np
    import torch

    from lass_torch.models.resunet import ResUNet30

    state = {k: v.detach().cpu() for k, v in sep.model.state_dict().items()}
    rng = np.random.RandomState(5)
    mixture = torch.from_numpy((0.1 * rng.randn(2, 1, 16000)).astype(
        np.float32))
    cond = torch.from_numpy(rng.randn(2, 512).astype(np.float32))
    outs = []
    for dev in (device, "cpu"):
        model = ResUNet30(compute_dtype=torch.float32)
        model.load_state_dict(state)
        model.to(dev).eval()
        with torch.inference_mode():
            outs.append(model({"mixture": mixture.to(dev),
                               "condition": cond.to(dev)}
                              )["waveform"].cpu().double())
    err = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
    log(f"float32 card vs CPU, B=2 x 1 s: rel err {err:.3e} (limit 1e-4)")
    if not err <= 1e-4:
        raise AssertionError("card and CPU forwards disagree")
    return err


def time_forward(sep, b=16, seconds=10.0, iters=10):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    mixture = 0.1 * torch.randn(b, 1, int(seconds * 16000), generator=gen,
                                device="cuda")
    cond = torch.randn(b, 512, generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = cuda_ms(lambda: sep.model({"mixture": mixture,
                                        "condition": cond}), iters)
    return ms, torch.cuda.max_memory_allocated()


def time_captions(enc, n=16, iters=10):
    import torch

    captions = [f"sound number {i} of a busy street" for i in range(n)]
    times = []
    for k in range(iters + 2):
        torch.cuda.synchronize()
        start = time.perf_counter()
        enc.embed_text_batch(captions)
        torch.cuda.synchronize()
        if k >= 2:
            times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def time_mask_kernel(iters=50):
    """Kernel and plain version at the serving views, in turns."""
    import torch

    from lass_torch.ops import masking

    args = serving_mask_inputs("cuda")
    n, t, f = args[0].shape
    kernel = lambda: masking.apply_complex_mask_ri(*args)  # noqa: E731
    plain = lambda: masking.mask_math_from_ri(*args)  # noqa: E731
    runs = {"plain": [], "kernel": []}
    for name, fn in (("plain", plain), ("kernel", kernel),
                     ("kernel", kernel), ("plain", plain)):
        runs[name].append(cuda_ms(fn, iters))
    elements = n * t * f
    bytes_ms = 28 * elements / HBM_BYTES_PER_S * 1e3
    flops_ms = MASK_FLOPS_PER_ELEMENT * elements / F32_FLOP_PER_S * 1e3
    return {"ms": min(runs["kernel"]), "plain_ms": min(runs["plain"]),
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "shape": [n, t, f]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from lass_torch.ops import _build, masking

    # 1. card
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"compute capability {cap[0]}.{cap[1]}")
    if cap[0] != 9:
        raise RuntimeError(f"kernels are built for sm_90a; this card is "
                           f"sm_{cap[0]}{cap[1]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    start = time.perf_counter()
    _build.load_library(verbose=True)
    log(f"kernel build + load: {time.perf_counter() - start:.1f} s "
        f"(nvcc {_build.last_build_seconds:.1f} s)")

    # 3. kernels vs plain
    mask_err = check_mask_kernel("cuda")

    # 4. serve
    build_dir = os.path.join(REPO, "lass_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt_dir:
        cfg, sep = build_server("cuda", ckpt_dir)
    log(f"server: ResUNet30 {cfg.model.compute_dtype}, "
        f"{sum(p.numel() for p in sep.model.parameters()) / 1e6:.1f} M "
        f"params; caption encoder RoBERTa-base, random weights, "
        f"{'fallback hash' if sep.query_encoder.using_fallback_tokenizer else 'BPE'}"
        f" tokenizer")
    masking.LAUNCHES = 0
    serve(sep, SERVE_REQUESTS)
    launches = {"apply_complex_mask_ri": masking.LAUNCHES}
    log(f"launches during serving: {launches}")
    if launches["apply_complex_mask_ri"] != len(SERVE_REQUESTS):
        raise AssertionError("mask kernel launches != forwards")

    # 5. card vs CPU
    card_vs_cpu(sep, "cuda")

    # 6. times
    fwd_ms, peak = time_forward(sep)
    log(f"forward B=16 x 10 s bf16: {fwd_ms:.2f} ms median, "
        f"{16 / (fwd_ms / 1e3):.1f} clips/s, peak memory {peak / 2**30:.2f} GiB")
    cap_ms = time_captions(sep.query_encoder)
    log(f"caption encoding, 16 captions: {cap_ms:.2f} ms median")
    mask = time_mask_kernel()
    log(f"mask kernel at {mask['shape']}: {mask['ms'] * 1e3:.1f} us, plain "
        f"{mask['plain_ms'] * 1e3:.1f} us, bound {mask['bound_ms'] * 1e3:.1f} "
        f"us ({mask['bound_by']})")

    kernels = [{
        "name": "apply_complex_mask_ri", "route": "cuda",
        "source": "lass_torch/csrc/masking.cu",
        "replaces": "lass_tpu/ops/pallas_masking.py:59",
        "launches": launches["apply_complex_mask_ri"],
        "max_abs_err": mask_err, "ms": mask["ms"],
        "plain_ms": mask["plain_ms"], "bound_ms": mask["bound_ms"],
        "bound_by": mask["bound_by"], "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
