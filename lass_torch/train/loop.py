"""Training loop (counterpart of lass_tpu/train/loop.py), on one card or
on several with one process per card.

Workspace layout (``get_dirs``), datafile dataset and batch loader, the
separator, mixer, loss, AMSGrad optimizer and LR schedule, the frozen CLAP
query encoder, checkpoints at step 1 and every ``save_step_frequency``
steps, metrics to ``metrics.jsonl`` (the first record of a ``fit`` also
names the model's training-remat mode, ``LASS_TPU_REMAT``) and resume.

A host thread (``datamodule.BatchLoader``) decodes and crops batches a few
ahead; a second one (``prefetch.DevicePrefetcher``, on its own stream on a
card) encodes the wire format, uploads and, in text-only conditioning,
embeds the captions two batches ahead of the step, and times the upload
and the embed (``prefetch_h2d``, ``prefetch_embed``; CUDA events on its
stream, so it never waits for the card); the main thread runs the step
(and, under a grid, gathers its data rank's rows). Both threads
are closed and joined on every way out of ``fit``. Resume restores model,
optimizer, scheduler, step and the mixer's generator, and skips the
batches already trained on without decoding them, so a resumed run sees
the batches, mixes and conditions an uninterrupted run would.

Conditioning: with ``model.use_text_ratio`` 1 (the recipe) the captions;
below 1 ('hybird', which needs the query encoder's audio tower,
``attach_audio_encoder``) the batch is mixed first and each step draws
one coin, seeded by the step (``random_seed * 1000003 + step``, so a
resumed run draws what the uninterrupted one drew): the captions, or the
mixed segments through the audio tower (reference audiosep.py:77-88
embeds the segments after the mixer); then the premixed step. The mix
and that embed run on the main thread (they need the step's generator
and the mixed segments); under a grid each rank embeds its own rows (the
model group's ranks draw the same coin) and the model group gathers the
conditions.

``fit(eval_hook=)`` runs a hook (``make_dcase_eval_hook``: the DCASE
evaluator on the training model) every ``train.evaluate_step_frequency``
steps; its metrics go to ``metrics.jsonl`` and the statistics file, its
time to ``timing['eval']``, and the steps/s windows leave it out.

Several cards (``lass_torch.parallel``; launch under ``python -m
torch.distributed.run``, after ``initialize_distributed``): the directory
is ``<config stem>,devices=<world size>``; each rank loads
``batch_size_per_device`` rows of its strided share of every epoch, and
the step is the global batch's (``AudioSepTask``: DDP, global BatchNorm
statistics, the mix over the global batch, the global mean loss). Every
rank restores a checkpoint; rank 0 alone logs, writes metrics.jsonl, the
statistics and the checkpoints (the bare model, so one written at any
world size resumes at any other and serves through ``load_ss_model``) and
runs the eval hook, and every rank waits at the end of ``fit`` until rank
0's last checkpoint is on disk.

Tensor parallelism (``model_parallel`` M > 1, lass_tpu's ``--model_parallel``):
the ranks form a (W / M) x M grid (``lass_torch.parallel.mesh.make_grid``),
the model's wide layers are sharded over each model group
(``lass_torch.parallel.tensor.shard_model``) and so are the optimizer's
moments. Each rank still loads ``batch_size_per_device`` rows of its
strided share; a model group's ranks gather theirs (its data rank's rows)
on the main thread before the step, so the step at any layout of W ranks
is the function of the same W x ``batch_size_per_device`` global batch as
the W-rank data-parallel step (and as lass_tpu's, whose global batch is
``batch_size_per_device * len(devices)``). Every rank joins the
checkpoint's gathers; rank 0 writes the whole model.
"""
from __future__ import annotations

import logging
import os
import pathlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from lass_torch.config import load_config
from lass_torch.data.datafiles import AudioTextDataset
from lass_torch.data.datamodule import DataModule
from lass_torch.data.mixer import SegmentMixer
from lass_torch.losses import get_loss_function
from lass_torch.models.query_encoder import CLAPQueryEncoder
from lass_torch.models.resunet import build_model
from lass_torch.parallel.host import barrier, host_info
from lass_torch.parallel.mesh import make_grid
from lass_torch.parallel.tensor import shard_model
from lass_torch.tasks.audiosep import AudioSepTask
from lass_torch.train.checkpoint import (
    CheckpointManager, restore_file, snapshot)
from lass_torch.train.optim import build_optimizer
from lass_torch.train.prefetch import DevicePrefetcher, span, upload
from lass_torch.utils.logging import MetricsLogger, create_logging
from lass_torch.utils.statistics import StatisticsContainer

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
                 log_every: int = LOG_EVERY, model_parallel: int = 1):
        """``model_parallel``: the model axis of the grid (1: data
        parallelism only)."""
        self.cfg = cfg = load_config(config_yaml)
        self.device = torch.device(device)
        self.rank, world = host_info()
        self.main_process = self.rank == 0
        if cfg.model.query_net != "CLAP":
            raise NotImplementedError(cfg.model.query_net)
        self.use_text_ratio = cfg.model.use_text_ratio
        if self.use_text_ratio < 1.0 and (
                query_encoder is None or query_encoder.audio_model is None):
            raise NotImplementedError(
                "use_text_ratio < 1 conditions on audio too, which needs "
                "the CLAP audio tower: pass a query encoder after its "
                "attach_audio_encoder()")
        (self.checkpoints_dir, self.logs_dir, self.tf_logs_dir,
         stats_dir) = get_dirs(workspace, filename, config_yaml, world)
        create_logging(self.logs_dir, main_process=self.main_process)
        logging.info("config: %s", cfg)
        self.log_every = log_every

        torch.manual_seed(cfg.train.random_seed)
        model = build_model(cfg).to(self.device)
        # the training-remat mode (LASS_TPU_REMAT; a model without the
        # switch recomputes nothing), logged with the first record
        self.remat = getattr(model, "remat", "none")
        logging.info("remat: %s", self.remat)
        self.grid = make_grid(model_parallel)
        shard_model(model, self.grid)
        opt = cfg.train.optimizer
        optimizer, scheduler = build_optimizer(
            model.parameters(), opt.optimizer_type, opt.learning_rate,
            opt.lr_lambda_type, opt.warm_up_steps, opt.reduce_lr_steps)
        self.task = AudioSepTask(
            model, SegmentMixer(cfg.data.max_mix_num,
                                cfg.data.loudness_norm.lower_db,
                                cfg.data.loudness_norm.higher_db),
            optimizer, scheduler, get_loss_function(cfg.train.loss_type),
            grid=self.grid)
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
            num_workers=cfg.train.num_workers, seed=cfg.train.random_seed,
            process_index=self.rank, process_count=world)
        self.ckpt = CheckpointManager(
            self.checkpoints_dir,
            save_step_frequency=cfg.train.save_step_frequency)
        self.metrics = MetricsLogger(self.tf_logs_dir,
                                     enabled=self.main_process)
        self.statistics = StatisticsContainer(
            os.path.join(stats_dir, "statistics.pkl"))
        if resume_checkpoint_path:
            path = _resume_path(resume_checkpoint_path)
            restore_file(path, self.task, self.generator)
            logging.info("resumed from %s at step %d", path, self.task.step)
        # wall-clock split of fit() on the main thread: waiting for the
        # prefetcher, the main thread's part of a batch (the grid's row
        # gather; hybrid: + the mix and the condition), the step, metric
        # reads, saves, the eval hook; and the prefetch thread's spans,
        # which overlap the others: the upload and the caption embed
        self.timing = {"data_wait": 0.0, "prepare": 0.0, "step": 0.0,
                       "metrics_fetch": 0.0, "save_block": 0.0, "eval": 0.0,
                       "prefetch_embed": 0.0, "prefetch_h2d": 0.0}

    def _prefetch(self, i: int, batch: Dict) -> Dict:
        """The prefetch thread's part of a batch (no collective): upload
        the wire batch; text-only conditioning also embeds the captions
        (-> {'waveform', 'condition'}), hybrid keeps them for the main
        thread (-> {'waveform', 'text'})."""
        at = batch["audio_text"]
        with span("prefetch_h2d"):
            waveform = upload(_encode_wire(at["waveform"],
                                           self.cfg.train.wire_dtype),
                              self.device)
        if self.use_text_ratio < 1.0:
            return {"waveform": waveform, "text": at["text"]}
        with span("prefetch_embed"):
            condition = self.query_encoder.get_query_embed(
                "text", text=at["text"]).clone()
        return {"waveform": waveform, "condition": condition}

    def _prepare(self, item: Dict) -> Dict[str, torch.Tensor]:
        """The main thread's part: text-only -> {'waveform', 'condition'}
        for ``train_step``; hybrid -> {'mixture', 'segment', 'condition'}
        for ``train_step_premixed``; under a grid, the data rank's rows."""
        task = self.task
        waveform = task.gather_model_rows(item["waveform"])
        if "condition" in item:
            return {"waveform": waveform,
                    "condition": task.gather_model_rows(item["condition"])}
        mixtures, segments = task.mix(waveform, self.generator)
        seed = self.cfg.train.random_seed * 1000003 + task.step
        condition = self.query_encoder.get_query_embed(
            "hybird", text=item["text"], audio=task.own_rows(segments)[:, 0],
            use_text_ratio=self.use_text_ratio, seed=seed)
        return {"mixture": mixtures, "segment": segments,
                "condition": task.gather_model_rows(condition.clone())}

    def fit(self, max_steps: Optional[int] = None,
            eval_hook: Optional[Callable] = None,
            step_hook: Optional[Callable[[int], None]] = None
            ) -> AudioSepTask:
        """Train until ``max_steps`` (or train.early_stop_steps) updates
        have been done in all; returns the task. ``eval_hook(trainer,
        step)`` -> dict of metrics runs every
        ``train.evaluate_step_frequency`` steps (on rank 0);
        ``step_hook(step)`` after every step (the CLI's profiler)."""
        cfg, timing, pc = self.cfg, self.timing, time.perf_counter
        stop_at = cfg.train.early_stop_steps
        if max_steps is not None:
            stop_at = min(stop_at, max_steps)
        step = self.task.step
        sharded = self.grid.model_size > 1
        t_last, steps_since = pc(), 0
        first_record = {"remat": self.remat}
        loader = self.datamodule.train_dataloader(skip_batches=step)
        prefetch = None
        try:
            prefetch = DevicePrefetcher(loader, self._prefetch, self.device,
                                        timing)
            while step < stop_at:
                t0 = pc()
                item = next(prefetch, None)
                timing["data_wait"] += pc() - t0
                if item is None:
                    break
                t0 = pc()
                data = self._prepare(item)
                timing["prepare"] += pc() - t0
                t0 = pc()
                if "waveform" in data:
                    metrics = self.task.train_step(data, self.generator)
                else:
                    metrics = self.task.train_step_premixed(data)
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
                                            "steps_per_sec": sps,
                                            **first_record})
                    first_record = {}
                if step_hook is not None:
                    step_hook(step)
                # under a grid the model's forward gathers over the model
                # group, so every rank runs the hook; rank 0 records it
                if eval_hook is not None and (
                        self.main_process or sharded) and \
                        step % cfg.train.evaluate_step_frequency == 0:
                    t0 = pc()
                    eval_metrics = eval_hook(self, step)
                    if eval_metrics and self.main_process:
                        self.metrics.log(step, eval_metrics)
                        self.statistics.append(step, eval_metrics, "test")
                        logging.info("eval @ %d: %s", step, eval_metrics)
                    seconds = pc() - t0
                    timing["eval"] += seconds
                    t_last += seconds  # keep the steps/s windows eval-free
                if self.ckpt.should_save(step) and (
                        self.main_process or sharded):
                    # under a grid every rank joins the snapshot's gathers
                    t0 = pc()
                    state = snapshot(self.task, self.generator)
                    if self.main_process:
                        self.ckpt.write_async(step, state)
                    timing["save_block"] += pc() - t0
        finally:
            if prefetch is not None:
                prefetch.close()
            loader.close()
            self.ckpt.wait()
            self.metrics.finish()
        barrier()  # rank 0's last checkpoint is on disk for every rank
        logging.info("fit seconds: %s", {k: round(v, 3)
                                         for k, v in timing.items()})
        return self.task



def make_dcase_eval_hook(eval_indexes: str, audio_dir: str,
                         batch_size: int = 16) -> Callable:
    """An eval hook for ``Trainer.fit``: the DCASE evaluator
    (``lass_torch.evaluation.dcase``, 16 kHz) on the training model and
    query encoder -> {'eval_SISDR', 'eval_SDRi', 'eval_SDR'}. The next
    train step puts the model back in train mode."""
    from lass_torch.evaluation.dcase import (
        DCASEEvaluator, SeparationInference)

    evaluator = DCASEEvaluator(eval_indexes=eval_indexes,
                               audio_dir=audio_dir, batch_size=batch_size)

    def hook(trainer: Trainer, step: int) -> Dict[str, float]:
        model = SeparationInference(trainer.task.model,
                                    trainer.query_encoder,
                                    device=str(trainer.device))
        sisdr, sdri, sdr = evaluator(model)
        return {"eval_SISDR": sisdr, "eval_SDRi": sdri, "eval_SDR": sdr}

    return hook
