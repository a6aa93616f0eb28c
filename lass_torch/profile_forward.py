"""Where the separation forward's (or the train step's) device time goes,
by kernel family.

    python -m lass_torch.profile_forward [--config default|A|B] [--batch 16]
        [--seconds 10] [--iters 3] [--train]

Runs the full-width ResUNet30 forward (config/audiosep_base.yaml, random
weights) in the chosen serving configuration (``CONFIGS`` in
``lass_torch/models/resunet.py``: the default, or the fused-conv A or B) on
the GPU under ``torch.profiler`` after warm-up, then prints the device time
per forward by kernel family (the port's own kernels, convolutions, matrix
products, FFTs, overlap-add, elementwise, other), the top kernels, and the
device's busy share of the profiled window, with the card's name and
power limit. ``--train`` profiles the bf16 train step instead
(``AudioSepTask.train_step``: mix, forward in train mode, backward, AMSGrad;
the default configuration, as the fused switches are eval-only), per step.
Needs a CUDA device.
"""
import argparse
import contextlib
import collections
import json
import os
import subprocess
import sys

FAMILIES = [  # first match wins; matched against the lower-cased name
    ("mask kernel", ("apply_complex_mask_ri",)),
    ("fused act+conv3x3 kernel", ("act_conv3x3",)),
    ("fused conv block kernel", ("residual_conv_block",)),
    ("fused act+convT kernel", ("act_convt",)),
    ("fused head+mask kernel", ("head_mask",)),
    ("fft", ("fft",)),
    ("optimizer (AdamW)", ("multi_tensor", "foreach", "adam")),
    ("batch norm (train)", ("batch_norm", "batchnorm", "welford", "bn_fw_",
                            "bn_bw_")),
    ("overlap-add (fold)", ("col2im", "im2col")),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "fprop", "nchwtonhwc",
              "nhwctonchw", "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "cublas", "matmul")),
    ("elementwise/reduce", ("elementwise", "vectorized", "unrolled",
                            "reduce", "cat", "pool", "copy", "fill")),
]


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", choices=("default", "A", "B"),
                        default="default")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--train", action="store_true",
                        help="profile train steps (default config only)")
    args = parser.parse_args(argv)
    if args.train and args.config != "default":
        parser.error("--train runs the default configuration: the fused "
                     "switches are eval-only")

    import torch
    from torch.profiler import ProfilerActivity, profile

    from lass_torch.config import load_config
    from lass_torch.models.resunet import CONFIGS, build_model

    if not torch.cuda.is_available():
        print("profile_forward: torch sees no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "config", "audiosep_base.yaml"))
    torch.manual_seed(0)
    model = build_model(cfg, **CONFIGS[args.config]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    wave = 0.1 * torch.randn(args.batch, 1, int(args.seconds * 16000),
                             generator=gen, device="cuda")
    cond = torch.randn(args.batch, 512, generator=gen, device="cuda")
    if args.train:
        from lass_torch.data.mixer import SegmentMixer
        from lass_torch.tasks.audiosep import AudioSepTask
        from lass_torch.train.optim import build_optimizer

        opt = cfg.train.optimizer
        task = AudioSepTask(model, SegmentMixer(), *build_optimizer(
            model.parameters(), opt.optimizer_type, opt.learning_rate,
            opt.lr_lambda_type, opt.warm_up_steps, opt.reduce_lr_steps))
        data = {"waveform": wave, "condition": cond}
        mode = contextlib.nullcontext()

        def run():
            task.train_step(data, gen)
    else:
        model.eval()
        batch = {"mixture": wave, "condition": cond}
        mode = torch.inference_mode()

        def run():
            model(batch)
    with mode:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(args.iters):
                run()
            end.record()
            torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)

    per_kernel = collections.Counter()
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        if us and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            per_kernel[evt.key] += us / 1e3 / args.iters  # ms per call
    by_family = collections.Counter()
    for name, ms in per_kernel.items():
        by_family[family(name)] += ms
    busy = sum(per_kernel.values())
    fwd_ms = window_ms / args.iters
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {
        "card": card,
        "config": args.config,
        "mode": "train step" if args.train else "forward",
        "shape": [args.batch, 1, int(args.seconds * 16000)],
        "dtype": cfg.model.compute_dtype,
        "ms_per_call_cuda_events": fwd_ms,
        "device_busy_ms_per_call": busy,
        "device_idle_share": (1 - busy / fwd_ms) if busy else None,
        "by_family_ms": dict(by_family.most_common()),
        "top_kernels_ms": dict(per_kernel.most_common(15)),
    }
    if not busy:
        print("profile_forward: the profiler recorded no device time",
              file=sys.stderr)
    print(f"card: {card}")
    print(f"{result['mode']} {result['shape']} {result['dtype']}, config "
          f"{args.config}: {fwd_ms:.2f} ms "
          f"(CUDA events), device busy {busy:.2f} ms")
    for fam, ms in by_family.most_common():
        print(f"  {fam:22s} {ms:8.3f} ms  {100 * ms / max(busy, 1e-9):5.1f}%")
    for name, ms in per_kernel.most_common(15):
        print(f"  {ms:8.3f} ms  {name[:110]}")
    print(json.dumps(result))
    return 0 if busy else 1


if __name__ == "__main__":
    sys.exit(main())
