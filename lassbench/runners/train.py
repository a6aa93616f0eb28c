"""Separator training through the program's own trainer, on one card.

``Trainer.fit`` (``lass_torch/train/loop.py``) with its ``DataModule``
over a synthetic corpus and its ``DevicePrefetcher``, text conditioning
through the seeded query encoder, ``batch`` rows a step at the
configuration's precision, in the training-remat mode ``remat``. The
corpus (the frozen ``signals.write_corpus``: ``corpus`` in the mix, its
own fixed seed) is a dataset on disk: written once into the checkout's
``.lassbench_cache`` and read by every later run; the run's seed draws the
order, the crops, the mixes and the weights.

One ``fit`` call runs it all: its first ``warmup_steps`` are set-up (the
first ``checked_steps`` of them are those the check follows; the program
writes its step-1 checkpoint, which set-up waits for), then the window
runs until the first step boundary after ``--seconds``, and the step hook
ends ``fit`` there. The check: the plain float32 reference runs the same
first steps from the same weights on the rows, captions and mixer draws
it works out again from the corpus and the seed: each step's loss, the
first gradient as the optimizer got it (AdamW's first moment after one
step over 1 - beta1) and the parameters' change over the checked steps,
each leaf's norm against the reference's, by the worst leaf.
"""
from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List

import numpy as np
import torch

from lassbench import runners, flops, signals
from lassbench.harness import CACHE
from lassbench.reference import separator as ref_sep
from lassbench.reference import text as ref_text
from lassbench.reference import train as ref_train


class WindowClosed(Exception):
    """Raised by the step hook to end ``fit`` when the window closes."""


def corpus(tr: Dict, cfg: Dict, cache: str) -> str:
    c = tr["corpus"]
    key = "-".join(str(c[k]) for k in (
        "num_clips", "seconds_min", "seconds_max", "alt_rate_fraction",
        "alt_rate", "seed"))
    out = os.path.join(cache, f"corpus-{key}")
    return signals.write_corpus(out, c["num_clips"], cfg["sampling_rate"],
                                c["seconds_min"], c["seconds_max"],
                                c["alt_rate_fraction"], c["alt_rate"],
                                c["seed"])


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str], what: str) -> Dict[str, float]:
    """Each leaf's |norm(prog) - norm(ref)| over the larger of norm(ref)
    and the median leaf's norm(ref), over the leaves ``keep``: the worst
    leaf's and the median leaf's."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].float())) for k in keep}
    rn = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in keep}
    median = float(np.median(list(rn.values())))
    gap = {k: abs(pn[k] - rn[k]) / max(rn[k], median) for k in keep}
    order = sorted(keep, key=lambda k: -gap[k])
    runners.log(f"{what} worst leaves: " + ", ".join(
        f"{k} {gap[k]:.4g} (norm {pn[k]:.4g} vs {rn[k]:.4g})"
        for k in order[:3]) + f"; median leaf norm {median:.4g}")
    return {"worst": gap[order[0]],
            "median": float(np.median(list(gap.values())))}


def reference(cfg: Dict, tr: Dict, seed: int, device, datafile: str,
              quant=None, rows=None):
    """(seeded weights, the reference's ``checked_steps`` steps on the
    rows and captions worked out from the corpus): ``quant`` and ``rows``
    (the first ``rows`` of each batch) make a control or a fault."""
    entries = signals.corpus_entries(datafile)
    tsd = runners.text_state(cfg, seed, device)
    batches = []
    with torch.no_grad():
        for k in range(tr["checked_steps"]):
            wave, caps = ref_train.batch_rows(
                entries, seed, k, tr["batch"], cfg["sampling_rate"],
                cfg["segment_seconds"])
            cond = ref_text.embed_captions(tsd, cfg["text"], caps, device)
            n = rows or len(caps)
            batches.append((torch.from_numpy(wave[:n]).to(device), cond[:n]))
    del tsd
    sd = runners.separator_state(cfg, seed, device)
    return sd, ref_train.train(sd, cfg, batches, seed, device, quant=quant)


def compare(prog: Dict, sd: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared, from the program's readings ``prog``
    ({'losses', 'grads1', 'params'}) and the reference's."""
    grads = ref["grads1"]
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
    median = float(np.median(list(norms.values())))
    # leaves whose gradient is nought to rounding in the reference (a
    # bias that a train-mode BatchNorm cancels) move by round-off alone
    keep = [k for k, n in norms.items() if n >= 1e-3 * median]
    runners.log(f"leaves compared: {len(keep)} of {len(norms)}")
    delta = {k: prog["params"][k] - sd[k] for k in keep}
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                    ref["losses"]))
    g = leaf_gaps(prog["grads1"], grads, keep, "grad1")
    d = leaf_gaps(delta, ref["delta"], keep, "delta")
    return {"loss_gap": loss, "grad1_gap": g["worst"],
            "grad1_median_gap": g["median"], "delta_gap": d["worst"],
            "delta_median_gap": d["median"]}


def control(bench, seed: int, device, mode: str) -> Dict[str, float]:
    """The reference put in the program's place: in float8 (``fp8``), on
    half of each batch (``half``), or through bfloat16 (``bf16``, the
    witness at the program's own precision), against the float32
    reference."""
    cfg, tr = bench.config, bench.traffic
    runners.set_precision()
    datafile = corpus(tr, cfg, CACHE)
    sd, ref = reference(cfg, tr, seed, device, datafile)
    _, alt = reference(cfg, tr, seed, device, datafile,
                       quant={"fp8": ref_sep.fp8,
                              "bf16": ref_sep.bf16}.get(mode),
                       rows=tr["batch"] // 2 if mode == "half" else None)
    prog = {"losses": alt["losses"], "grads1": alt["grads1"],
            "params": {k: sd[k] + d for k, d in alt["delta"].items()}}
    return compare(prog, sd, ref)


def build_trainer(run, device, datafile: str):
    from lass_torch.train.loop import Trainer

    bench, seed = run.bench, run.seed
    cfg, tr = bench.config, bench.traffic
    os.environ["LASS_TPU_REMAT"] = tr["remat"]
    ws = runners.workdir(run)
    shutil.rmtree(ws, ignore_errors=True)
    os.makedirs(ws)
    yaml = runners.program_yaml(os.path.join(ws, "config.yaml"), cfg, seed,
                                [datafile], batch=tr["batch"],
                                num_workers=tr["num_workers"])
    enc = runners.query_encoder(cfg, seed, device)
    trainer = Trainer(yaml, os.path.join(ws, "workspace"), query_encoder=enc,
                      device=str(device))
    trainer.task.model.load_state_dict(
        runners.separator_state(cfg, seed, device))
    return trainer, ws


def run(run, device) -> None:
    bench, seed = run.bench, run.seed
    cfg, tr = bench.config, bench.traffic
    runners.set_precision()
    datafile = corpus(tr, cfg, run.cache)
    trainer, ws = build_trainer(run, device, datafile)
    task = trainer.task
    runners.describe_device(run, device, 1)
    checked, warm = tr["checked_steps"], tr["warmup_steps"]
    on_card = str(device).startswith("cuda")
    prog: Dict = {"losses": []}
    names = [k for k, _ in task.model.named_parameters()]
    window = runners.Window(run, device)
    mark: Dict = {}

    step_fn = task.train_step

    def train_step(batch, generator):
        with runners.span(run, "train_step"):
            metrics = step_fn(batch, generator)
        if task.step <= checked:
            prog["losses"].append(metrics["train_loss"].detach().clone())
        return metrics

    task.train_step = train_step

    def hook(step: int) -> None:
        # set-up's readings go to the host, out of the window's memory
        if step == 1:
            state = task.optimizer.state
            prog["grads1"] = {
                k: (state[p]["exp_avg"] / (1 - ref_train.BETAS[0])).cpu()
                for k, p in task.model.named_parameters()
                if p in state}
        if step == checked:
            prog["params"] = {k: p.detach().to("cpu", copy=True)
                              for k, p in task.model.named_parameters()}
        if step == warm:
            trainer.ckpt.wait()  # the step-1 checkpoint is set-up's
            runners.sync(device)
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            runners.card_state(run, "before")
            run.setup_s = time.perf_counter() - run.t_start
            mark.update(step=step, timing=dict(trainer.timing))
            window.open()
            mark["t0"] = time.perf_counter()
        elif step > warm and time.perf_counter() - mark["t0"] >= run.seconds:
            runners.sync(device)
            mark["t1"] = time.perf_counter()
            window.end()
            runners.card_state(run, "after")
            mark["steps"] = step - mark["step"]
            raise WindowClosed

    try:
        trainer.fit(step_hook=hook)
    except WindowClosed:
        pass
    window.close()
    run.window_s = mark["t1"] - mark["t0"]
    run.units = mark["steps"]
    run.attempted = run.units
    run.timing = {k: trainer.timing[k] - mark["timing"][k]
                  for k in trainer.timing}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    run.device["memory_peak_bytes"] = int(peak)
    b = tr["batch"]
    run.e2e = {"train_clips_per_s": run.units * b / run.window_s,
               "train_peak_gib": peak / 2 ** 30, "setup_s": run.setup_s}
    if run.traced:
        frames = int(cfg["segment_seconds"] * cfg["sampling_rate"]) \
            // ref_sep.HOP + 1
        run.info["mask_elements"] = b * frames * (ref_sep.BINS - 1)
        run.flops["bfloat16"] = flops.separator_flops(cfg, b, train=True)
        run.flops["float32"] = flops.text_flops(cfg["text"], b)

    zero = {k: torch.zeros(()) for k in names}  # a leaf never updated
    readings = {"losses": [float(x) for x in prog["losses"][:checked]],
                "grads1": {k: prog.get("grads1", {}).get(k, zero[k]).to(
                    device) for k in names},
                "params": {k: v.to(device) for k, v in
                           prog["params"].items()}}
    del trainer, task, prog, step_fn, train_step, hook
    runners.free(device)
    shutil.rmtree(ws, ignore_errors=True)
    sd, ref = reference(cfg, tr, seed, device, datafile)
    runners.set_checks(run, compare(readings, sd, ref))
