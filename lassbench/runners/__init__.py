"""Runners: each traffic mix's ``runner`` names one of these modules, whose
``run(run, device)`` builds the program from the seed, warms it up on the
cell's shapes, measures the window into ``run`` and checks what it
produced against ``lassbench.reference``.

The helpers below are shared: the program's config file from a
configuration, the seeded weights, the query encoder, the card's
description, the traced window.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

import torch

from lassbench import weights
from lassbench.reference import audio as ref_audio
from lassbench.reference import separator as ref_sep
from lassbench.reference import text as ref_text

RANGE = "lassbench::"


def workdir(run) -> str:
    """A directory of this cell under the run's TMPDIR, at a fixed path."""
    path = os.path.join(tempfile.gettempdir(), f"lassbench-{run.bench.name}")
    os.makedirs(path, exist_ok=True)
    return path


def program_yaml(path: str, cfg: Dict, seed: int, datafiles: List[str],
                 batch: int = 16, num_workers: int = 1) -> str:
    """The program's config file for configuration ``cfg`` (JSON, which is
    YAML): text conditioning; checkpoints and evaluation past any run."""
    t = cfg["train"]
    raw = {
        "task_name": "AudioSep",
        "data": {"datafiles": datafiles,
                 "sampling_rate": cfg["sampling_rate"],
                 "segment_seconds": cfg["segment_seconds"],
                 "loudness_norm": {"lower_db": t["lower_db"],
                                   "higher_db": t["higher_db"]},
                 "max_mix_num": t["max_mix_num"]},
        "model": {"query_net": "CLAP", "model_type": "ResUNet30",
                  "condition_size": cfg["condition_size"],
                  "input_channels": cfg["input_channels"],
                  "output_channels": cfg["output_channels"],
                  "use_text_ratio": 1.0,
                  "compute_dtype": cfg["compute_dtype"]},
        "train": {"optimizer": {k: t[k] for k in (
                      "optimizer_type", "learning_rate", "warm_up_steps",
                      "reduce_lr_steps", "lr_lambda_type")},
                  "num_workers": num_workers, "loss_type": t["loss_type"],
                  "batch_size_per_device": batch,
                  "evaluate_step_frequency": 10 ** 9,
                  "save_step_frequency": 10 ** 9,
                  "random_seed": int(seed)},
    }
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def separator_state(cfg: Dict, seed: int, device) -> Dict:
    return weights.seeded_state(ref_sep.param_shapes(cfg["condition_size"]),
                                seed, "separator", device)


def text_state(cfg: Dict, seed: int, device) -> Dict:
    return weights.seeded_state(ref_text.param_shapes(cfg["text"]), seed,
                                "text", device)


def audio_state(cfg: Dict, seed: int, device) -> Dict:
    return weights.seeded_state(ref_audio.param_shapes(cfg["audio"]), seed,
                                "audio", device)


def query_encoder(cfg: Dict, seed: int, device):
    """The program's CLAP query encoder with the seeded text tower (and,
    for a configuration with one, the seeded audio tower), built on the
    device; captions through the hash tokenizer (no vocabulary is in the
    repository)."""
    from lass_torch.models.clap.htsat import HTSATConfig
    from lass_torch.models.clap.roberta import RobertaConfig
    from lass_torch.models.clap.tokenizer import WhitespaceFallbackTokenizer
    from lass_torch.models.query_encoder import CLAPQueryEncoder
    from lass_torch.dsp.mel import LogMelConfig

    t = cfg["text"]
    rcfg = RobertaConfig(**{k: t[k] for k in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "type_vocab_size")})
    with torch.device(device):
        enc = CLAPQueryEncoder(
            text_state_dict=text_state(cfg, seed, device),
            tokenizer=WhitespaceFallbackTokenizer(t["vocab_size"]),
            roberta_cfg=rcfg, joint_embed_dim=t["joint_embed_dim"],
            pad_to=t["pad_to"], device=str(device))
        a = cfg.get("audio")
        if a is not None:
            hcfg = HTSATConfig(
                spec_size=a["spec_size"], patch_size=a["patch_size"],
                patch_stride=a["patch_stride"], num_classes=a["num_classes"],
                embed_dim=a["embed_dim"], depths=tuple(a["depths"]),
                num_heads=tuple(a["num_heads"]),
                window_size=a["window_size"], mlp_ratio=a["mlp_ratio"],
                mel=LogMelConfig(**a["mel"]))
            enc.attach_audio_encoder(
                audio_state(cfg, seed, device), hcfg,
                sampling_rate=cfg["sampling_rate"],
                clip_samples=int(a["clip_seconds"]
                                 * a["mel"]["sample_rate"]))
    return enc


def _smi(fields: str) -> List[float]:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,"
         "nounits", "-i", "0"], capture_output=True, text=True,
        timeout=20).stdout.strip()
    return [float(x) for x in out.splitlines()[0].split(",")]


def describe_device(run, device, count: int) -> None:
    name = torch.cuda.get_device_name(device) if str(device).startswith(
        "cuda") else "cpu"
    run.device.update({"platform": "gpu" if name != "cpu" else "cpu",
                       "kind": name, "count": count})
    if name != "cpu":
        try:
            run.device["power_limit_w"] = _smi("power.limit")[0]
        except (OSError, ValueError, IndexError, subprocess.SubprocessError):
            pass


def card_state(run, when: str) -> None:
    """The card's SM clock (MHz), temperature (C) and power draw (W) before
    and after the window, beside the result (not metrics: they say why
    two runs differ)."""
    if run.device.get("platform") != "gpu":
        return
    try:
        clock, temp, power = _smi("clocks.sm,temperature.gpu,power.draw")
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return
    run.device[f"card_{when}"] = {"sm_mhz": clock, "temp_c": temp,
                                  "power_w": power}


def sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()


class Window:
    """The measured window: under ``--trace 1`` a ``torch.profiler`` over
    it and the range ``lassbench::window`` around it; ``close`` reduces
    the profile into ``run.trace``."""

    def __init__(self, run, device):
        self.run, self.device = run, device
        self._prof = self._range = None

    def open(self) -> None:
        if self.run.traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if str(self.device).startswith("cuda"):
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._range = torch.autograd.profiler.record_function(
                RANGE + "window")
            self._range.__enter__()

    def end(self) -> None:
        """The window's range ends here; the profiler runs on until
        ``close``."""
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def close(self) -> None:
        if self._prof is None:
            return
        from lassbench.trace import Trace

        self.end()
        self._prof.__exit__(None, None, None)
        self.run.trace = Trace.collect(self._prof)
        self._prof = None
        if self.run.trace.window is not None:
            self.run.device["busy_s"] = self.run.trace.busy_s()
            self.run.device["window_s"] = self.run.trace.window_s()


def span(run, label: str):
    """A benchmark range around a call into the program (traced runs)."""
    if not run.traced:
        return contextlib.nullcontext()
    return torch.autograd.profiler.record_function(RANGE + label)


def set_precision() -> None:
    """IEEE float32 for every float32 matmul and convolution, program and
    reference alike: the configurations state float32 for the towers, and
    cuDNN would otherwise take float32 convolutions in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def set_checks(run, found: Dict[str, float]) -> None:
    """The numbers that the cell's limits name are compared; the others
    are only logged."""
    for k, v in found.items():
        log(f"reading {k} {v}")
    run.checks = {k: (found.get(k), lim) for k, lim in
                  run.bench.limits.items()}


def log(msg: str) -> None:
    print(f"lassbench: {msg}", file=sys.stderr, flush=True)


def quantile95(values: List[float]) -> Optional[float]:
    import statistics

    if len(values) < 2:
        return values[0] if values else None
    return statistics.quantiles(values, n=20, method="inclusive")[18]
