"""Seeded weights, made on the device in one draw.

``seeded_state(shapes, seed, stream, device)``: one ``torch.rand`` of
every float entry together, from a ``torch.Generator`` on the device
seeded by (seed, stream), cut into views and scaled by what each entry
is: matrices and convolution kernels xavier-uniform (embeddings and
attention-bias tables at std 0.02); a norm's scale around 1 and its
shift around 0; BatchNorm's running means around 0 and variances in
[0.5, 1.5]. Counters are 0. The program and the reference are handed the
same dict: the same seed gives the same weights, in float32, the type
both keep their parameters in.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

STREAMS = {"separator": 1, "text": 2, "audio": 3}


def _scale(key: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(centre, half-width) of the uniform draw for one entry."""
    if key.endswith("running_mean"):
        return 0.0, 0.1
    if key.endswith("running_var"):
        return 1.0, 0.5
    if len(shape) >= 2:
        if "embeddings" in key or "bias_table" in key:
            return 0.0, 0.02 * math.sqrt(3.0)
        if key == "film.weight":  # one matrix of ~40 Linears of width ~64
            return 0.0, math.sqrt(6.0 / (shape[1] + 64))
        rf = math.prod(shape[2:]) if len(shape) > 2 else 1
        return 0.0, math.sqrt(6.0 / (shape[0] * rf + shape[1] * rf))
    if key.endswith("weight"):
        return 1.0, 0.1
    return 0.0, 0.05


def seeded_state(shapes: List[Tuple[str, tuple]], seed: int, stream: str,
                 device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7919 + STREAMS[stream]) % (2 ** 63))
    floats = [(k, s) for k, s in shapes if not k.endswith(
        "num_batches_tracked")]
    total = sum(math.prod(s) for _, s in floats)
    flat = torch.rand(total, generator=gen, device=device)
    sd, offset = {}, 0
    for key, shape in floats:
        n = math.prod(shape)
        centre, half = _scale(key, shape)
        sd[key] = flat[offset:offset + n].view(shape).mul_(
            2 * half).add_(centre - half)
        offset += n
    for key, shape in shapes:
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros(shape, dtype=torch.long, device=device)
    return {k: sd[k] for k, _ in shapes}
