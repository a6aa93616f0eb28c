"""Training loop (counterpart of lass_tpu/train/loop.py), one card.

Workspace layout (``get_dirs``), datafile dataset and batch loader, the
separator, mixer, loss, AMSGrad optimizer and LR schedule, the frozen CLAP
caption encoder, checkpoints at step 1 and every ``save_step_frequency``
steps, metrics to ``metrics.jsonl`` and resume.

A host thread (``datamodule.BatchLoader``) decodes and crops batches a few
ahead; the main thread encodes the wire format, uploads, embeds the
captions and runs the step. The loader thread is closed and joined on
every way out of ``fit``. Resume restores model, optimizer, scheduler,
step and the mixer's generator, and skips the batches already trained on
without decoding them, so a resumed run sees the batches and mixes an
uninterrupted run would.

Not here yet (later slices): data parallelism over several cards,
hybrid or audio conditioning (``use_text_ratio < 1`` needs the CLAP audio
tower), and the periodic DCASE evaluation hook.
"""
from __future__ import annotations

import logging
import os
import pathlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lass_torch.config import load_config
from lass_torch.data.datafiles import AudioTextDataset
from lass_torch.data.datamodule import DataModule
from lass_torch.data.mixer import SegmentMixer
from lass_torch.losses import get_loss_function
from lass_torch.models.query_encoder import CLAPQueryEncoder
from lass_torch.models.resunet import build_model
from lass_torch.tasks.audiosep import AudioSepTask
from lass_torch.train.checkpoint import CheckpointManager, restore_file
from lass_torch.train.optim import build_optimizer
from lass_torch.utils.logging import MetricsLogger, create_logging

LOG_EVERY = 50  # steps between metric records (and step 1)


def get_dirs(workspace: str, filename: str, config_yaml: str,
             devices_num: int) -> List[str]:
    """[checkpoints, logs, tf_logs, statistics] directories under
    ``workspace/<kind>/<filename>/<config stem>,devices=<n>``."""
    yaml_name = pathlib.Path(config_yaml).stem
    sub = f"{yaml_name},devices={devices_num}"
    dirs = []
    for kind in ["checkpoints", "logs", "tf_logs", "statistics"]:
        d = os.path.join(workspace, kind, filename, sub)
        os.makedirs(d, exist_ok=True)
        dirs.append(d)
    return dirs


def _encode_wire(waveform: np.ndarray, wire_dtype: str) -> np.ndarray:
    """Host side of train.wire_dtype: 'int16' sends PCM samples scaled by
    32768 (half the bytes; ``tasks.audiosep._decode_wire`` inverts it
    exactly for PCM-sourced audio); 'float32' sends the batch as it is."""
    if wire_dtype != "int16":
        return waveform
    return np.clip(np.rint(np.asarray(waveform) * 32768.0),
                   -32768, 32767).astype(np.int16)


def _resume_path(path: str) -> str:
    """A checkpoint file, or a directory of them (its latest)."""
    if os.path.isdir(path):
        mgr = CheckpointManager(path)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {path}")
        return mgr.path(step)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


class Trainer:
    def __init__(self, config_yaml: str, workspace: str,
                 resume_checkpoint_path: Optional[str] = None,
                 query_encoder: Optional[CLAPQueryEncoder] = None,
                 device: str = "cuda", filename: str = "train",
                 log_every: int = LOG_EVERY):
        self.cfg = cfg = load_config(config_yaml)
        self.device = torch.device(device)
        if cfg.model.query_net != "CLAP":
            raise NotImplementedError(cfg.model.query_net)
        if cfg.model.use_text_ratio < 1.0:
            raise NotImplementedError(
                "use_text_ratio < 1 conditions on audio too, which needs "
                "the CLAP audio tower (HTSAT); lass_torch has the text "
                "tower only")
        (self.checkpoints_dir, self.logs_dir, self.tf_logs_dir,
         _stats_dir) = get_dirs(workspace, filename, config_yaml, 1)
        create_logging(self.logs_dir)
        logging.info("config: %s", cfg)
        self.log_every = log_every

        torch.manual_seed(cfg.train.random_seed)
        model = build_model(cfg).to(self.device)
        opt = cfg.train.optimizer
        optimizer, scheduler = build_optimizer(
            model.parameters(), opt.optimizer_type, opt.learning_rate,
            opt.lr_lambda_type, opt.warm_up_steps, opt.reduce_lr_steps)
        self.task = AudioSepTask(
            model, SegmentMixer(cfg.data.max_mix_num,
                                cfg.data.loudness_norm.lower_db,
                                cfg.data.loudness_norm.higher_db),
            optimizer, scheduler, get_loss_function(cfg.train.loss_type))
        # the mixer's draws; its state is checkpointed with the model
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.train.random_seed + 1)
        self.query_encoder = query_encoder or CLAPQueryEncoder(
            device=str(self.device))

        dataset = AudioTextDataset(cfg.data.datafiles,
                                   sampling_rate=cfg.data.sampling_rate,
                                   max_clip_len=cfg.data.segment_seconds)
        self.datamodule = DataModule(
            dataset, batch_size=cfg.train.batch_size_per_device,
            num_workers=cfg.train.num_workers, seed=cfg.train.random_seed)
        self.ckpt = CheckpointManager(
            self.checkpoints_dir,
            save_step_frequency=cfg.train.save_step_frequency)
        self.metrics = MetricsLogger(self.tf_logs_dir)
        if resume_checkpoint_path:
            path = _resume_path(resume_checkpoint_path)
            restore_file(path, self.task, self.generator)
            logging.info("resumed from %s at step %d", path, self.task.step)
        # wall-clock split of fit(): waiting for the loader, host->device
        # upload + caption embedding, the step, metric reads, saves
        self.timing = {"data_wait": 0.0, "prepare": 0.0, "step": 0.0,
                       "metrics_fetch": 0.0, "save_block": 0.0}

    def _prepare(self, batch: Dict) -> Dict[str, torch.Tensor]:
        at = batch["audio_text"]
        waveform = torch.from_numpy(_encode_wire(
            at["waveform"], self.cfg.train.wire_dtype)).to(self.device)
        condition = self.query_encoder.get_query_embed("text",
                                                       text=at["text"])
        return {"waveform": waveform, "condition": condition.clone()}

    def fit(self, max_steps: Optional[int] = None) -> AudioSepTask:
        """Train until ``max_steps`` (or train.early_stop_steps) updates
        have been done in all; returns the task."""
        cfg, timing, pc = self.cfg, self.timing, time.perf_counter
        stop_at = cfg.train.early_stop_steps
        if max_steps is not None:
            stop_at = min(stop_at, max_steps)
        step = self.task.step
        t_last, steps_since = pc(), 0
        loader = self.datamodule.train_dataloader(skip_batches=step)
        try:
            while step < stop_at:
                t0 = pc()
                batch = next(loader, None)
                timing["data_wait"] += pc() - t0
                if batch is None:
                    break
                t0 = pc()
                data = self._prepare(batch)
                timing["prepare"] += pc() - t0
                t0 = pc()
                metrics = self.task.train_step(data, self.generator)
                step = self.task.step
                steps_since += 1
                timing["step"] += pc() - t0
                if step % self.log_every == 0 or step == 1:
                    t0 = pc()
                    loss, gnorm = (float(metrics["train_loss"]),
                                   float(metrics["grad_norm"]))
                    timing["metrics_fetch"] += pc() - t0
                    sps = steps_since / (pc() - t_last)
                    t_last, steps_since = pc(), 0
                    logging.info("step %d loss %.5f (%.2f steps/s)", step,
                                 loss, sps)
                    self.metrics.log(step, {"train_loss": loss,
                                            "grad_norm": gnorm,
                                            "steps_per_sec": sps})
                if self.ckpt.should_save(step):
                    t0 = pc()
                    self.ckpt.save_async(step, self.task, self.generator)
                    timing["save_block"] += pc() - t0
        finally:
            loader.close()
            self.ckpt.wait()
            self.metrics.finish()
        logging.info("fit seconds: %s", {k: round(v, 3)
                                         for k, v in timing.items()})
        return self.task

