"""Microbench of the time-tap conv kernel against cuDNN's convs, on one
NVIDIA GPU (the port of scripts/microbench_tridiag.py):

    python -m lass_torch.microbench_tridiag [--shape 16 1024 128 128]

At x of (B, T, G, C) bf16 it prints one JSON line each, in ms per call
(CUDA events around runs of back-to-back calls, the median of several
runs): cuDNN's dense bf16 3x3 SAME conv on the same activations as a
channels_last (B, C, T, G) tensor (the counterpart of the original's
``xla_dense``); cuDNN's (3, 1) conv, which computes the kernel's
un-activated function; the kernel ``lass_torch.ops.timetap_conv`` at each
t_tile with and without the fused activation; and its plain version.
Needs a card: there is no CPU measurement.

The kernel is persistent: its warpgroups split the (batch, 64-position g
block) columns into units of t_tile time rows, each walking an equal share
of units down T with the halo carried. t_tile (the original's ``tt``, its
time rows per grid step) is therefore only the granularity of that split:
the sweep over ``T_TILES`` shows what the balance costs, not a tile size.
"""
from __future__ import annotations

import argparse
import json
import statistics
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from lass_torch.ops.timetap_conv import (
    T_TILES, timetap_conv, timetap_conv_plain)

SHAPE = (16, 1024, 128, 128)


def cuda_ms(fn: Callable, iters: int = 5, warmup: int = 2,
            reps: int = 10) -> float:
    """Median over ``iters`` runs of ``reps`` back-to-back calls, in ms per
    call, by CUDA events on the current stream."""
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


def inputs(shape: Sequence[int] = SHAPE, seed: int = 0,
           device: str = "cuda"):
    """x (B, T, G, C) bf16, w3 (3C, C) bf16 and a dense (C, C, 3, 3) bf16
    weight, from ``seed``."""
    b, t, g, c = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (0.1 * torch.randn(b, t, g, c, generator=gen, device=device)
         ).to(torch.bfloat16)
    w3 = (0.05 * torch.randn(3 * c, c, generator=gen, device=device)
          ).to(torch.bfloat16)
    wdense = (0.05 * torch.randn(c, c, 3, 3, generator=gen, device=device)
              ).to(torch.bfloat16)
    return x, w3, wdense


def run(shape: Sequence[int] = SHAPE, iters: int = 5, reps: int = 10,
        seed: int = 0) -> List[Dict]:
    """The microbench's rows (see the module docstring)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the microbench needs an NVIDIA GPU")
    x, w3, wdense = inputs(shape, seed)
    c = shape[3]
    xc = x.permute(0, 3, 1, 2)  # (B, C, T, G) view, channels_last strides
    # (3C, C) -> (C_out, C_in, 3, 1): tap dt of input channel k at
    # w3[dt * C + k]
    w31 = w3.view(3, c, c).permute(2, 1, 0).unsqueeze(-1).contiguous(
        memory_format=torch.channels_last)
    wd = wdense.contiguous(memory_format=torch.channels_last)
    rows = []
    with torch.inference_mode():
        rows.append({"op": "cudnn_dense_3x3", "ms": cuda_ms(
            lambda: F.conv2d(xc, wd, padding=1), iters, reps=reps)})
        rows.append({"op": "cudnn_conv_3x1", "ms": cuda_ms(
            lambda: F.conv2d(xc, w31, padding=(1, 0)), iters, reps=reps)})
        for tt in T_TILES:
            for act in (False, True):
                rows.append({"op": "timetap_conv", "t_tile": tt, "act": act,
                             "ms": cuda_ms(lambda: timetap_conv(
                                 x, w3, act, tt), iters, reps=reps)})
        for act in (False, True):
            rows.append({"op": "timetap_conv_plain", "act": act,
                         "ms": cuda_ms(lambda: timetap_conv_plain(
                             x, w3, act), iters, reps=max(1, reps // 5))})
    for row in rows:
        row["shape"] = list(shape)
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m lass_torch.microbench_tridiag")
    parser.add_argument("--shape", type=int, nargs=4, default=list(SHAPE),
                        metavar=("B", "T", "G", "C"))
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args(argv)
    print(json.dumps({"device": torch.cuda.get_device_name(0)
                      if torch.cuda.is_available() else None}), flush=True)
    for row in run(args.shape, args.iters):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
