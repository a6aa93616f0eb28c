"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure raises and the script exits non-zero:

1. card: name, power limit, torch/CUDA versions, compute capability;
   TF32 off for the float32 phases;
2. build the CUDA kernels from lass_torch/csrc (one nvcc per source, in
   parallel, at first use);
3. each kernel against its plain PyTorch version at every distinct shape
   the serving forward gives it (B=16 clips of 10 s) and at ragged shapes,
   plus gradient cases for the two mask kernels;
4. serve: ``load_ss_model`` on a random-weight full-width ResUNet30
   (config/audiosep_base.yaml, bf16) with the full RoBERTa-base caption
   encoder, four requests of 10 s, 4.5 s and 1 s, one caption repeated so
   that it hits the caption cache; then the fused-conv configurations A
   and B (``lass_torch.models.resunet.CONFIGS``) built from the served
   model's state dict answer the 10 s (A, B) and 4.5 s (A) requests, each
   waveform held against the default configuration's. Every path runs
   with the launch counts reset just before and read just after, and each
   forward must launch exactly its configuration's kernels;
5. the default weights in float32, B=2 x 1 s, on the card and on the CPU;
   configuration A in bf16, B=1 x 1 s, on the card and on the CPU (the
   kernels' plain versions there);
6. times with CUDA events: the B=16 x 10 s bf16 forward of the default
   configuration, A and B, caption encoding, each kernel against its bound
   and its plain version at each serving shape (cuDNN's bare conv beside
   the fused 3x3 conv as context).

The last lines are the kernels' JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``; the lines before them give
every other measured number, and chiprun_out/chip_smoke.json holds them
all as one JSON object.
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
BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
# floating-point operations of the mask chain per element, counting each
# sqrt, division, exp and tanh as one (see lass_torch/csrc/masking.cu)
MASK_FLOPS_PER_ELEMENT = 30
SERVE_REQUESTS = [("a dog barking", 10.0), ("rain falling on a tin roof", 4.5),
                  ("a man speaking over traffic", 1.0), ("a dog barking", 4.5)]
# (kernel, lass_torch.ops module, its launch counter, source, TPU kernel)
KERNELS = [
    ("apply_complex_mask_ri", "masking", "LAUNCHES",
     "lass_torch/csrc/masking.cu", "lass_tpu/ops/pallas_masking.py:59"),
    ("fused_act_conv3x3", "act_conv", "LAUNCHES",
     "lass_torch/csrc/act_conv.cu", "lass_tpu/ops/pallas_folded_conv.py:178"),
    ("fused_residual_conv_block", "convblock", "LAUNCHES",
     "lass_torch/csrc/convblock.cu", "lass_tpu/ops/pallas_convblock.py:82"),
    ("fused_act_convT", "convt", "LAUNCHES",
     "lass_torch/csrc/convt.cu", "lass_tpu/ops/pallas_convt.py:51"),
    ("apply_head_mask", "masking", "HEAD_LAUNCHES",
     "lass_torch/csrc/head_mask.cu", "lass_tpu/ops/pallas_masking.py:248"),
]
# launches per forward of each configuration; every other kernel: 0
PER_FORWARD = {
    "default": {"apply_complex_mask_ri": 1},
    "A": {"fused_act_conv3x3": 8, "fused_act_convT": 2, "apply_head_mask": 1},
    "B": {"fused_residual_conv_block": 1, "fused_act_convT": 2,
          "apply_head_mask": 1},
}
# requests (indices into SERVE_REQUESTS) each fused configuration answers
FUSED_REQUESTS = {"A": [0, 1], "B": [0]}
# bf16 rounding: a kernel and its plain version round the same float32
# activations at the same points and sum in another order, which moves an
# output's bf16 rounding by at most one unit in the last place (2^-7 of
# the largest output); the residual block rounds one more intermediate
BF16_ULP = 2.0 ** -7
# two bf16 forwards that round at different places differ by about what
# bf16 costs against float32 (tests/test_torch_resunet.py)
BF16_FORWARD_REL = 5e-2
RESULTS = {}


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3, reps=1):
    """Milliseconds of one fn() on the current stream by CUDA events: the
    median over ``iters`` samples, each a run of ``reps`` back-to-back
    calls divided by ``reps`` (reps > 1 keeps the card busy while the host
    enqueues, so a short kernel's time is not its launch overhead)."""
    import torch

    for _ in range(warmup):
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


def kernel_counts():
    import importlib

    return {name: getattr(importlib.import_module(f"lass_torch.ops.{mod}"),
                          attr) for name, mod, attr, _, _ in KERNELS}


def reset_kernel_counts():
    import importlib

    for _, mod, attr, _, _ in KERNELS:
        setattr(importlib.import_module(f"lass_torch.ops.{mod}"), attr, 0)


def fused_cases(device, b=16, l1=(1024, 512), t_out=1001, head_channels=1,
                seed=0):
    """Every distinct shape the serving forward gives the fused kernels
    (at b=16, l1=(1024, 512), t_out=1001: B=16 clips of 10 s, level 1 of
    T_pad x 512, 1001 STFT frames), each with its launches per forward
    (n), the bytes a call must move (each input read once, each output
    written once), its operations and their peak rate."""
    import torch

    from lass_torch.ops import act_conv, convblock, convt, masking

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0, around=0.0):
        return around + scale * torch.randn(*shape, generator=gen,
                                            device=device)

    def act(c, t, f):
        return randn(b, c, t, f).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

    (t1, f1), (t2, f2), (t3, f3) = [(l1[0] // k, l1[1] // k) for k in (1, 2, 4)]
    cases = []
    for label, chans, cout, t, f, n in [
            ("encoder_block1 conv1+conv2, decoder_block6 conv2", (32,), 32,
             t1, f1, 3),
            ("encoder_block2 conv1", (32,), 64, t2, f2, 1),
            ("encoder_block2 conv2, decoder_block5 conv2", (64,), 64, t2, f2,
             2),
            ("decoder_block5 conv1", (64, 64), 64, t2, f2, 1),
            ("decoder_block6 conv1", (32, 32), 32, t1, f1, 1)]:
        cin, m = sum(chans), b * t * f
        cases.append(dict(
            kernel="fused_act_conv3x3", n=n, ulps=1,
            label=f"{label}: {'+'.join(map(str, chans))}->{cout} at "
                  f"{b}x{t}x{f}",
            fn=act_conv.fused_act_conv3x3, plain=act_conv.act_conv3x3_plain,
            args=([act(c, t, f) for c in chans],
                  randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5),
                  randn(b, cin, scale=0.1, around=1.0),
                  randn(b, cin, scale=0.1)),
            bytes=2 * m * (cin + cout) + 2 * 9 * cin * cout + 8 * b * cin,
            ops=2 * m * 9 * cin * cout, rate=BF16_FLOP_PER_S))
    u, m = 32, b * t1 * f1
    cases.append(dict(
        kernel="fused_residual_conv_block", n=1, ulps=2,
        label=f"encoder_block1 block: {u} at {b}x{t1}x{f1}",
        fn=convblock.fused_residual_conv_block,
        plain=convblock.residual_conv_block_plain,
        args=(act(u, t1, f1), randn(u, u, 3, 3, scale=(9 * u) ** -0.5),
              randn(u, u, 3, 3, scale=(9 * u) ** -0.5),
              randn(b, u, scale=0.1, around=1.0), randn(b, u, scale=0.1),
              randn(b, u, scale=0.1, around=1.0), randn(b, u, scale=0.1)),
        bytes=4 * m * u + 4 * 9 * u * u + 16 * b * u,
        ops=4 * m * 9 * u * u, rate=BF16_FLOP_PER_S))
    for label, cin, cout, t, f in [("decoder_block5 conv1", 128, 64, t3, f3),
                                   ("decoder_block6 conv1", 64, 32, t2, f2)]:
        m = b * t * f
        cases.append(dict(
            kernel="fused_act_convT", n=1, ulps=1,
            label=f"{label}: {cin}->{cout} at {b}x{t}x{f} -> "
                  f"{2 * t}x{2 * f}",
            fn=convt.fused_act_convT, plain=convt.act_convT_plain,
            args=(act(cin, t, f), randn(cin, scale=0.1, around=1.0),
                  randn(cin, scale=0.1), randn(b, cin, scale=0.1),
                  randn(cin, cout, 2, 2, scale=cin ** -0.5)),
            bytes=2 * m * cin + 8 * m * cout + 8 * cin * cout
            + 4 * (2 + b) * cin,
            ops=8 * m * cin * cout, rate=BF16_FLOP_PER_S))
    c, mo, m = 32, 3 * head_channels, b * t_out * f1
    cases.append(dict(
        kernel="apply_head_mask", n=1, ulps=0,
        label=f"head: {c}->{mo} logits + mask, {b}x{t_out} of {t1}x{f1}, "
              f"{head_channels} output channel(s)",
        fn=masking.apply_head_mask, plain=masking.head_mask_plain,
        args=(act(c, t1, f1), randn(mo, c, 1, 1, scale=c ** -0.5),
              randn(mo, scale=0.1), randn(b, 1, t_out, f1 + 1),
              randn(b, 1, t_out, f1 + 1), head_channels),
        bytes=m * (2 * c + 8 + 8 * head_channels) + 4 * (c + 1) * mo,
        ops=m * head_channels * (6 * c + MASK_FLOPS_PER_ELEMENT),
        rate=F32_FLOP_PER_S))
    return cases


def check_case(case):
    """Kernel vs plain version on the card; bf16 outputs within case['ulps']
    bf16 units of the largest output, float32 ones within 1e-4 of
    max(1, largest). Returns the max abs error."""
    import torch

    with torch.inference_mode():
        got = case["fn"](*case["args"])
        torch.cuda.synchronize()
        ref = case["plain"](*case["args"])
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    err = max_err(got, ref)
    scale = max(r.float().abs().max().item() for r in ref)
    limit = (case["ulps"] * BF16_ULP * scale if case["ulps"]
             else 1e-4 * max(1.0, scale))
    log(f"{case['kernel']} vs plain, {case['label']}: max abs err {err:.3e} "
        f"(limit {limit:.3e})")
    if not err <= limit:
        raise AssertionError(f"{case['kernel']} disagrees at {case['label']}")
    if case["ulps"] and not got[0].is_contiguous(
            memory_format=torch.channels_last):
        raise AssertionError(f"{case['kernel']} output is not channels_last")
    return err


def check_fused_kernels(device):
    """Phase 3 for the fused kernels: every serving shape, the same set at
    ragged sizes (b=2, level 1 of 74 x 100, two output channels for the
    head), and a head gradient. Returns the largest error per kernel at
    the serving shapes."""
    import torch

    from lass_torch.ops import masking

    worst = {}
    for case in fused_cases(device):
        err = check_case(case)
        worst[case["kernel"]] = max(worst.get(case["kernel"], 0.0), err)
    for case in fused_cases(device, b=2, l1=(74, 100), t_out=70,
                            head_channels=2, seed=1):
        check_case(case)
    gen = torch.Generator(device=device).manual_seed(3)
    h = torch.randn(1, 32, 5, 24, generator=gen, device=device).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    h.requires_grad_(True)
    w = (0.2 * torch.randn(3, 32, 1, 1, generator=gen, device=device)
         ).requires_grad_(True)
    bias = (0.1 * torch.randn(3, generator=gen, device=device)
            ).requires_grad_(True)
    spec = [torch.randn(1, 1, 5, 25, generator=gen, device=device)
            for _ in range(2)]

    def grads(fn):
        r, i = fn(h, w, bias, *spec, 1)
        return torch.autograd.grad((r ** 2 + 0.5 * i).sum(), (h, w, bias))

    gerr = max_err(grads(masking.apply_head_mask),
                   grads(masking.head_mask_plain))
    log(f"head kernel gradient vs plain: max abs err {gerr:.3e} (limit 2e-4)")
    if not gerr <= 2e-4:
        raise AssertionError("head kernel gradient disagrees")
    return worst


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


def serve(sep, requests, config="default", sampling_rate=16000, seed=0):
    """Phase 4: answer the requests; each forward must launch exactly the
    kernels of its configuration (PER_FORWARD). Returns the per-request
    seconds and waveforms."""
    import numpy as np

    rng = np.random.RandomState(seed)
    on_card = next(sep.model.parameters()).is_cuda
    expect = {name: PER_FORWARD[config].get(name, 0) for name, *_ in KERNELS}
    seconds, outputs = [], []
    for caption, dur in requests:
        length = int(dur * sampling_rate)
        mixture = (0.1 * rng.randn(1, 1, length)).astype(np.float32)
        before = kernel_counts()
        start = time.perf_counter()
        cond = sep.query_encoder.get_query_embed("text", text=[caption])
        out = sep.separate(mixture, cond)
        seconds.append(time.perf_counter() - start)
        if out.shape != (1, 1, length) or not np.isfinite(out).all():
            raise AssertionError(f"bad output for {caption!r}: {out.shape}")
        launched = {k: v - before[k] for k, v in kernel_counts().items()}
        if on_card and launched != expect:
            raise AssertionError(f"config {config}: a forward launched "
                                 f"{launched}, expected {expect}")
        outputs.append(out)
        log(f"config {config}, request {caption!r} {dur} s: "
            f"{seconds[-1] * 1e3:.1f} ms, peak |y| {np.abs(out).max():.4f}")
    return seconds, outputs


def fused_server(sep, config):
    """The served model's state dict in a fused configuration, bound to the
    same caption encoder."""
    from lass_torch.config import load_config
    from lass_torch.evaluation.dcase import SeparationInference
    from lass_torch.models.resunet import CONFIGS, build_model

    cfg = load_config(os.path.join(REPO, "config", "audiosep_base.yaml"))
    model = build_model(cfg, **CONFIGS[config])
    model.load_state_dict(sep.model.state_dict())
    return SeparationInference(model, sep.query_encoder, device=sep.device)


def serve_fused(sep, default_outputs):
    """Phase 4 for configurations A and B: counts reset before each path
    and read after it; each waveform against the default configuration's
    for the same request. Returns {config: (launches, rel errs)}."""
    import numpy as np

    out = {}
    for config, picks in FUSED_REQUESTS.items():
        fsep = fused_server(sep, config)
        requests = [SERVE_REQUESTS[i] for i in picks]
        reset_kernel_counts()
        _, waves = serve(fsep, requests, config)
        launches = kernel_counts()
        errs = []
        for i, wave in zip(picks, waves):
            ref = default_outputs[i].astype(np.float64)
            errs.append(float(np.linalg.norm(wave - ref)
                              / (np.linalg.norm(ref) + 1e-20)))
            log(f"config {config} vs default, request {i}: rel err "
                f"{errs[-1]:.3e} (limit {BF16_FORWARD_REL})")
        log(f"launches during config {config} serving: {launches}")
        if max(errs) > BF16_FORWARD_REL:
            raise AssertionError(f"config {config} disagrees with default")
        out[config] = (launches, errs)
    return out


def card_vs_cpu(sep, config="default", dtype="float32", batch=2, seed=5,
                limit=1e-4):
    """Phase 5: the served weights in ``config`` and ``dtype``, B x 1 s, on
    the card and on the CPU (where the wrappers run the kernels' plain
    versions). Returns the relative error."""
    import numpy as np
    import torch

    from lass_torch.models.resunet import CONFIGS, ResUNet30

    state = {k: v.detach().cpu() for k, v in sep.model.state_dict().items()}
    rng = np.random.RandomState(seed)
    mixture = torch.from_numpy((0.1 * rng.randn(batch, 1, 16000)).astype(
        np.float32))
    cond = torch.from_numpy(rng.randn(batch, 512).astype(np.float32))
    outs = []
    for dev in ("cuda", "cpu"):
        model = ResUNet30(compute_dtype=getattr(torch, dtype),
                          **CONFIGS[config])
        model.load_state_dict(state)
        model.to(dev).eval()
        with torch.inference_mode():
            outs.append(model({"mixture": mixture.to(dev),
                               "condition": cond.to(dev)}
                              )["waveform"].cpu().double())
    err = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
    log(f"config {config} {dtype} card vs CPU, B={batch} x 1 s: rel err "
        f"{err:.3e} (limit {limit})")
    if not err <= limit:
        raise AssertionError(f"config {config} disagrees between card and "
                             f"CPU")
    return err


def time_fused_kernels(iters=5, reps=10):
    """Phase 6 for the fused kernels: each serving case, kernel and plain
    version in turns (plain, kernel, kernel, plain); beside each 3x3 case,
    cuDNN's bare bf16 conv on the pre-activated channels_last input (the
    concat materialised). Returns per-case rows and per-kernel totals per
    forward (sum over its launches)."""
    import torch
    import torch.nn.functional as F

    rows, totals = [], {}
    for case in fused_cases("cuda"):
        args = case["args"]
        runs = {"plain": [], "kernel": []}
        with torch.inference_mode():
            for name in ("plain", "kernel", "kernel", "plain"):
                fn = case["plain"] if name == "plain" else case["fn"]
                runs[name].append(cuda_ms(lambda: fn(*args), iters, 2,
                                          reps))
            cudnn_ms = None
            if case["kernel"] == "fused_act_conv3x3":
                srcs, w, a, b = args
                x = srcs[0] if len(srcs) == 1 else torch.cat(srcs, 1)
                h = F.leaky_relu(x.float() * a[:, :, None, None]
                                 + b[:, :, None, None], 0.01).to(x.dtype)
                h = h.contiguous(memory_format=torch.channels_last)
                wb = w.to(x.dtype)
                cudnn_ms = cuda_ms(lambda: F.conv2d(h, wb, padding=1),
                                   iters, 2, reps)
        bytes_ms = case["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = case["ops"] / case["rate"] * 1e3
        row = {"kernel": case["kernel"], "label": case["label"],
               "launches_per_forward": case["n"],
               "ms": min(runs["kernel"]), "plain_ms": min(runs["plain"]),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": case["bytes"], "ops": case["ops"],
               "cudnn_conv_ms": cudnn_ms}
        rows.append(row)
        log(f"{row['kernel']} at {row['label']} (x{case['n']} per "
            f"forward): {row['ms'] * 1e3:.1f} us, plain "
            f"{row['plain_ms'] * 1e3:.1f} us, bound {row['bound_ms'] * 1e3:.1f}"
            f" us ({row['bound_by']}: {case['bytes'] / 1e6:.1f} MB, "
            f"{case['ops'] / 1e9:.1f} G ops)"
            + ("" if cudnn_ms is None else
               f"; cuDNN bare conv on the pre-activated input (context, not "
               f"the same function) {cudnn_ms * 1e3:.1f} us"))
        tot = totals.setdefault(case["kernel"], {
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
            "ops_ms": 0.0})
        for key, val in (("ms", row["ms"]), ("plain_ms", row["plain_ms"]),
                         ("bound_ms", row["bound_ms"]),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            tot[key] += case["n"] * val
        del case, args
    return rows, totals


def time_forward(model, b=16, seconds=10.0, iters=10):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    mixture = 0.1 * torch.randn(b, 1, int(seconds * 16000), generator=gen,
                                device="cuda")
    cond = torch.randn(b, 512, generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = cuda_ms(lambda: model({"mixture": mixture,
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


def time_mask_kernel(iters=10, reps=10):
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
        runs[name].append(cuda_ms(fn, iters, reps=reps))
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
    fused_err = check_fused_kernels("cuda")
    torch.cuda.empty_cache()

    # 4. serve: the default configuration, then A and B
    build_dir = os.path.join(REPO, "lass_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt_dir:
        cfg, sep = build_server("cuda", ckpt_dir)
    log(f"server: ResUNet30 {cfg.model.compute_dtype}, "
        f"{sum(p.numel() for p in sep.model.parameters()) / 1e6:.1f} M "
        f"params; caption encoder RoBERTa-base, random weights, "
        f"{'fallback hash' if sep.query_encoder.using_fallback_tokenizer else 'BPE'}"
        f" tokenizer")
    reset_kernel_counts()
    request_s, default_waves = serve(sep, SERVE_REQUESTS)
    launches = kernel_counts()
    log(f"launches during default serving: {launches}")
    if sep.query_encoder.embed_cache_hits < 1:
        raise AssertionError("the repeated caption missed the caption cache")
    fused = serve_fused(sep, default_waves)
    for config, (counts, _) in fused.items():
        for name, n in counts.items():
            launches[name] += n
    RESULTS.update(request_ms=[x * 1e3 for x in request_s],
                   fused_vs_default_rel_err={c: e for c, (_, e) in
                                             fused.items()},
                   launches_phase4=launches)

    # 5. card vs CPU
    RESULTS["f32_card_vs_cpu_rel_err"] = card_vs_cpu(sep)
    RESULTS["configA_bf16_card_vs_cpu_rel_err"] = card_vs_cpu(
        sep, "A", "bfloat16", batch=1, seed=6, limit=BF16_FORWARD_REL)

    # 6. times
    forward = {}
    for config in ("default", "A", "B"):
        model = sep.model if config == "default" else fused_server(
            sep, config).model
        fwd_ms, peak = time_forward(model)
        forward[config] = {"ms": fwd_ms, "clips_per_s": 16 / (fwd_ms / 1e3),
                           "peak_gib": peak / 2 ** 30}
        log(f"forward B=16 x 10 s bf16, config {config}: {fwd_ms:.2f} ms "
            f"median, {16 / (fwd_ms / 1e3):.1f} clips/s, peak memory "
            f"{peak / 2**30:.2f} GiB")
        del model
        torch.cuda.empty_cache()
    cap_ms = time_captions(sep.query_encoder)
    log(f"caption encoding, 16 captions: {cap_ms:.2f} ms median")
    mask = time_mask_kernel()
    log(f"mask kernel at {mask['shape']}: {mask['ms'] * 1e3:.1f} us, plain "
        f"{mask['plain_ms'] * 1e3:.1f} us, bound {mask['bound_ms'] * 1e3:.1f} "
        f"us ({mask['bound_by']})")
    rows, totals = time_fused_kernels()
    RESULTS.update(forward=forward, caption_ms=cap_ms, mask_kernel=mask,
                   fused_kernel_rows=rows, fused_kernel_totals=totals)

    kernels = [{
        "name": "apply_complex_mask_ri", "route": "cuda",
        "source": KERNELS[0][3], "replaces": KERNELS[0][4],
        "launches": launches["apply_complex_mask_ri"],
        "max_abs_err": mask_err, "ms": mask["ms"],
        "plain_ms": mask["plain_ms"], "bound_ms": mask["bound_ms"],
        "bound_by": mask["bound_by"], "library_ms": None}]
    # the fused kernels: times summed over their launches in one forward
    for name, _, _, source, replaces in KERNELS[1:]:
        tot = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": fused_err[name], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                         else "operations"),
            "library_ms": None})
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError(f"a kernel was not launched: {launches}")
    RESULTS["kernels"] = kernels
    RESULTS["card"] = card_line()
    details = os.path.join(REPO, "chiprun_out", "chip_smoke.json")
    os.makedirs(os.path.dirname(details), exist_ok=True)
    with open(details, "w") as f:
        json.dump(RESULTS, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(RESULTS["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
