"""Separation served in batches, one closed-loop client.

Each batch is ``batch`` mixtures of ``clip_seconds`` at the configuration's
rate, made from two seeded synthetic clips of a pool by the evaluator's
SNR mixing at a seeded integer SNR (``distinct_batches`` distinct batches,
cycled), and its queries: ``batch`` captions that no batch of the run
repeats (``query: text``), or ``batch`` distinct reference clips of the
same length (``query: audio``). A batch is ``get_query_embed`` then
``SeparationInference.separate``, host arrays in, host arrays out, timed
from the moment its arrays are in hand until its outputs are on the host.
The client sends the next batch when one returns.

Warm-up: ``warmup_batches`` batches of the same shapes (their captions
are the run's first ones). The window ends with the first batch that
returns after ``--seconds``. The check: ``check_batches`` batches of the
window drawn from the seed, their queries and mixtures through the plain
float32 reference, against what the window returned, and against the same
reference computed through bfloat16 (the witness): each clip's gap of
the separated waveform over the witness's gap of that clip, the worst and
the 90th percentile, and the worst row's gap of the query embedding
(``gaps``).
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from lassbench import runners, flops, signals
from lassbench.reference import audio as ref_audio
from lassbench.reference import separator as ref_sep
from lassbench.reference import text as ref_text


class Traffic:
    """The mix's batches, made from the seed before the window."""

    def __init__(self, cfg: Dict, tr: Dict, seed: int):
        self.tr = tr
        rate, b = cfg["sampling_rate"], tr["batch"]
        rng = np.random.default_rng([int(seed), 11])
        clips = signals.clip_pool(rng, tr["pool_clips"], tr["clip_seconds"],
                                  rate)
        p = tr["distinct_batches"]
        self.mixtures = signals.mixtures(
            rng, clips, p * b, tr["snr_db"]).reshape(p, b, 1, -1)
        self.query = tr["query"]
        if self.query == "audio":
            refs = signals.clip_pool(rng, tr["query_pool"],
                                     tr["clip_seconds"], rate)
            self.queries = np.stack([refs[rng.choice(len(refs), b,
                                                     replace=False)]
                                     for _ in range(p)])
        self._rng = rng
        self._captions: List[str] = []
        self._tag = f"n{int(seed) % 997}x"
        if self.query == "text":
            self.captions(0)

    def captions(self, i: int) -> List[str]:
        b = self.tr["batch"]
        while len(self._captions) < (i + 1) * b:  # made ahead, in blocks
            self._captions += signals.captions(
                self._rng, 2048 * b, self.tr["caption_words"],
                self._tag + f"{len(self._captions) // b}-")
        return self._captions[i * b:(i + 1) * b]

    def batch(self, i: int):
        """(mixtures (B, 1, L), the query: captions or (B, L) clips)."""
        p = len(self.mixtures)
        q = self.queries[i % p] if self.query == "audio" else \
            self.captions(i)
        return self.mixtures[i % p], q


def build_program(cfg: Dict, seed: int, device, quantize: bool = False):
    """The program's SeparationInference with the seeded separator and
    query encoder."""
    from lass_torch.config import load_config
    from lass_torch.evaluation.dcase import SeparationInference
    from lass_torch.models.resunet import CONFIGS, build_model

    path = runners.program_yaml(
        os.path.join(tempfile.gettempdir(),
                     f"lassbench-separator-{os.getpid()}.yaml"), cfg, seed,
        [])
    pcfg = load_config(path)
    os.remove(path)
    with torch.device(device):
        model = build_model(pcfg, quantize=quantize, **CONFIGS[cfg["route"]])
    model.load_state_dict(runners.separator_state(cfg, seed, device))
    enc = runners.query_encoder(cfg, seed, device)
    return SeparationInference(model, enc, device=str(device))


def embed(sep, query: str, q):
    """The program's query embedding of captions or reference clips."""
    return sep.query_encoder.get_query_embed(
        query, **({"text": q} if query == "text" else {"audio": q}))


def serve(sep, query: str, mix, q):
    cond = embed(sep, query, q)
    return sep.separate(mix, cond), cond


def reference_outputs(cfg: Dict, seed: int, device, items, query: str,
                      tf32: bool = False, quant=None) -> List:
    """(separated (B, 1, L) numpy, embedding (B, E)) of the plain float32
    reference for each (mixtures, query) of ``items``. ``tf32`` computes
    the towers in TF32 (a control); ``quant`` rounds the separator's
    tensors (``ref_sep.fp8``, a control; ``ref_sep.bf16``, the witness)."""
    sd = runners.separator_state(cfg, seed, device)
    if query == "text":
        tsd = runners.text_state(cfg, seed, device)
    else:
        tower = ref_audio.build(cfg["audio"],
                                runners.audio_state(cfg, seed, device),
                                device)
    out = []
    with torch.no_grad():
        for mix, q in items:
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            if query == "text":
                emb = ref_text.embed_captions(tsd, cfg["text"], q, device)
            else:
                emb = tower(torch.from_numpy(np.asarray(q)).to(device),
                            cfg["sampling_rate"])
            runners.set_precision()
            wav = ref_sep.separate(sd, torch.from_numpy(mix).to(device), emb,
                                   quant=quant)
            out.append((wav.cpu().numpy(), emb.float()))
    return out


def clip_gaps(prog, ref) -> np.ndarray:
    """Each clip's L2 gap of the separated waveform to the reference's."""
    return np.concatenate([
        np.linalg.norm((pw - rw).reshape(len(pw), -1), axis=1)
        for (pw, _), (rw, _) in zip(prog, ref)])


def gaps(prog, ref, witness) -> Dict[str, float]:
    """The numbers compared, from (output, embedding) pairs of the program
    (or a control), of the float32 reference, and of the reference at the
    separator's own precision (``witness``, through bfloat16). The seed's
    weights set how well-conditioned the phase mask is, and so how far any
    bfloat16 computation strays (the witness's gap swings tenfold from
    seed to seed and from clip to clip), so each clip's gap is counted in
    units of the witness's gap of that same clip:

    - ``wave_worst_vs_witness``: the worst clip's (every answer is judged);
    - ``wave_p90_vs_witness``: the 90th percentile over the clips (a
      precision lost on many clips);
    - ``embed_err``: the worst row's L2 gap of the unit-norm query
      embedding."""
    ratio = clip_gaps(prog, ref) / np.maximum(clip_gaps(witness, ref), 1e-12)
    emb = max(float(torch.linalg.vector_norm(
        pe.float().to(re_.device) - re_, dim=-1).max())
        for (_, pe), (_, re_) in zip(prog, ref))
    worst = int(np.argmax(ratio))
    runners.log(f"clip gaps over the witness's: worst clip {worst} of "
                f"{len(ratio)} {ratio[worst]:.6g}, median "
                f"{np.median(ratio):.6g}")
    return {"wave_worst_vs_witness": float(ratio[worst]),
            "wave_p90_vs_witness": float(np.quantile(ratio, 0.9)),
            "embed_err": emb}


def references(cfg, seed, device, items, query):
    """The float32 reference's outputs and the bfloat16 witness's."""
    return (reference_outputs(cfg, seed, device, items, query),
            reference_outputs(cfg, seed, device, items, query,
                              quant=ref_sep.bf16))


def control(bench, seed: int, device, mode: str) -> Dict[str, float]:
    """A control in the program's place on the check's batches of a run
    with this seed, against the float32 reference: the program's own int8
    path (``int8``: calibrated on four batches, then packed, as the
    evaluator does), the reference's towers in TF32 (``tf32``) or its
    separator through float8 (``fp8``)."""
    cfg, tr = bench.config, bench.traffic
    query = tr["query"]
    runners.set_precision()
    traffic = Traffic(cfg, tr, seed)
    w = tr["warmup_batches"]
    items = [traffic.batch(w + k) for k in range(tr["check_batches"])]
    ref, witness = references(cfg, seed, device, items, query)
    if mode == "int8":
        sep = build_program(cfg, seed, device, quantize=True)
        for k in range(4):
            mix, q = traffic.batch(k)
            cond = embed(sep, query, q)
            sep.calibrate(mix, cond)
        sep.pack(mix, cond)
        ctrl = []
        for mix, q in items:
            out, cond = serve(sep, query, mix, q)
            ctrl.append((out, cond.float().cpu()))
        del sep
        runners.free(device)
    else:
        ctrl = reference_outputs(
            cfg, seed, device, items, query, tf32=mode == "tf32",
            quant=ref_sep.fp8 if mode == "fp8" else None)
    return gaps(ctrl, ref, witness)


def run(run, device) -> None:
    bench, seed = run.bench, run.seed
    cfg, tr = bench.config, bench.traffic
    runners.set_precision()
    traffic = Traffic(cfg, tr, seed)
    sep = build_program(cfg, seed, device)
    query = tr["query"]
    for i in range(tr["warmup_batches"]):
        serve(sep, query, *traffic.batch(i))
    b = tr["batch"]
    runners.describe_device(run, device, 1)

    window = runners.Window(run, device)
    # the checked batches: a reservoir sample of the window's, from the
    # seed (the outputs of the others are dropped as a client would)
    pick = np.random.default_rng([int(seed), 12])
    kept: List = []
    lat, embed_s = [], []
    i = tr["warmup_batches"]
    runners.sync(device)
    runners.card_state(run, "before")
    run.setup_s = time.perf_counter() - run.t_start
    window.open()
    t0 = time.perf_counter()
    while True:
        mix, q = traffic.batch(i)
        a = time.perf_counter()
        with runners.span(run, "query"):
            cond = embed(sep, query, q)
            if run.traced:
                runners.sync(device)
                embed_s.append(time.perf_counter() - a)
        with runners.span(run, "separate"):
            out = sep.separate(mix, cond)
        z = time.perf_counter()
        n = len(lat)
        lat.append(z - a)
        if n < tr["check_batches"]:
            kept.append((i, out, cond))
        else:
            slot = int(pick.integers(0, n + 1))
            if slot < tr["check_batches"]:
                kept[slot] = (i, out, cond)
        i += 1
        if z - t0 >= run.seconds:
            break
    t1 = time.perf_counter()
    window.end()
    runners.card_state(run, "after")
    window.close()
    del out, cond
    run.window_s = t1 - t0
    run.units = len(lat)
    run.attempted = run.units * b
    run.device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
        device)) if str(device).startswith("cuda") else 0
    run.spans["query_s"] = embed_s
    run.e2e = {"sep_clips_per_s": run.attempted / run.window_s,
               "sep_batch_p95_ms": 1e3 * runners.quantile95(lat),
               "setup_s": run.setup_s}
    if run.traced:
        frames = int(cfg["segment_seconds"] * cfg["sampling_rate"]) \
            // ref_sep.HOP + 1
        run.info["mask_elements"] = b * frames * (ref_sep.BINS - 1)
        run.flops["bfloat16"] = flops.separator_flops(cfg, b)
        run.flops["float32"] = (flops.text_flops(cfg["text"], b)
                                if query == "text"
                                else flops.audio_flops(cfg["audio"], b))

    # the check, with the program's state freed first
    kept.sort(key=lambda item: item[0])
    items = [traffic.batch(i) for i, _, _ in kept]
    prog = [(o, c.detach().float().cpu()) for _, o, c in kept]
    del sep, kept
    runners.free(device)
    found = gaps(prog, *references(cfg, seed, device, items, query))
    runners.set_checks(run, found)
