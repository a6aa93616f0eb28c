"""The trainer's device prefetcher (lass_torch/train/prefetch.py) on the
CPU: ``Trainer.fit`` through it gives the losses and grad norms of a
serial loop over the same batches to the bit, a run resumed from its
step-2 checkpoint repeats steps 3 and 4 to the bit, an error of the
producer re-raises on the consumer, and the producer and loader threads
are joined when a step fails. The trainer builds the small separator of
tests/torch_parallel_ranks.py (with a 512-wide condition) in place of
ResUNet30, whose trainer runs through the prefetcher in
tests/test_torch_trainer.py; float32, B=2 x 0.16 s, the small caption
encoder of that file.
"""
import json
import os
import threading

import pytest
import torch

from lass_torch.data.synth import make_synth_corpus, write_train_config
from lass_torch.train import loop
from lass_torch.train.prefetch import DevicePrefetcher
from test_torch_trainer import small_encoder
from torch_parallel_ranks import SmallSep
from torch_threads import torch_threads_per_worker  # noqa: F401

STEPS = 4


def _records(trainer):
    path = os.path.join(trainer.tf_logs_dir, "metrics.jsonl")
    return {r["step"]: (r["train_loss"], r["grad_norm"])
            for r in map(json.loads, open(path))}


def _threads():
    return [t.name for t in threading.enumerate()
            if t.name in ("device-prefetch", "batch-loader")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 4-step fit through the prefetcher (checkpoints 1, 2, 4), the
    serial loop's 4 steps from a fresh trainer, and a run resumed from
    the fit's step-2 checkpoint."""
    root = tmp_path_factory.mktemp("prefetch")
    datafile = make_synth_corpus(str(root / "synth"), num_clips=6,
                                 seconds_min=0.6, seconds_max=1.0,
                                 alt_rate_fraction=0.3, seed=4)
    config = write_train_config(str(root / "config.yaml"), datafile,
                                batch_size=2, segment_seconds=0.16,
                                num_workers=2, save_step_frequency=2,
                                compute_dtype="float32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "build_model",
                   lambda cfg: SmallSep(cfg.model.condition_size))
        return _runs(root, config)


def _runs(root, config):
    fitted = loop.Trainer(config, str(root / "fit"), device="cpu",
                          query_encoder=small_encoder(), log_every=1)
    fitted.fit(max_steps=STEPS)

    serial = loop.Trainer(config, str(root / "serial"), device="cpu",
                          query_encoder=small_encoder())
    task, encoder = serial.task, serial.query_encoder
    serial_records = {}
    with serial.datamodule.train_dataloader() as batches:
        for step in range(1, STEPS + 1):
            at = next(batches)["audio_text"]
            condition = encoder.get_query_embed("text", text=at["text"])
            metrics = task.train_step(
                {"waveform": torch.from_numpy(at["waveform"]),
                 "condition": condition.clone()}, serial.generator)
            serial_records[step] = (float(metrics["train_loss"]),
                                    float(metrics["grad_norm"]))

    resumed = loop.Trainer(config, str(root / "resumed"), device="cpu",
                           resume_checkpoint_path=fitted.ckpt.path(2),
                           query_encoder=small_encoder(), log_every=1)
    resumed.fit(max_steps=STEPS)
    return fitted, serial_records, resumed


def test_fit_through_the_prefetcher_is_the_serial_loop(runs):
    fitted, serial, _ = runs
    assert _records(fitted) == serial
    assert fitted.ckpt.steps() == [1, 2, 4]
    timing = fitted.timing
    assert {"prefetch_h2d", "prefetch_embed", "data_wait", "prepare",
            "step"} <= set(timing)
    assert timing["prefetch_embed"] > 0 and timing["step"] > 0
    assert not _threads()


def test_resumed_run_repeats_the_uninterrupted_steps(runs):
    fitted, _, resumed = runs
    got = _records(resumed)
    assert sorted(got) == [3, 4]
    assert got == {s: _records(fitted)[s] for s in (3, 4)}


def test_a_producer_error_reraises_on_the_consumer():
    def prepare(i, batch):
        if i == 2:
            raise ValueError("bad batch")
        return batch

    prefetch = DevicePrefetcher(iter(range(5)), prepare, "cpu")
    try:
        assert [next(prefetch), next(prefetch)] == [0, 1]
        with pytest.raises(RuntimeError, match="device prefetch failed") \
                as err:
            next(prefetch)
        assert isinstance(err.value.__cause__, ValueError)
    finally:
        prefetch.close()
    assert not prefetch._thread.is_alive()


def test_threads_joined_when_a_step_fails(runs, monkeypatch):
    fitted = runs[0]

    def boom(*_):
        raise RuntimeError("step failed")

    monkeypatch.setattr(fitted.task, "train_step", boom)
    with pytest.raises(RuntimeError, match="step failed"):
        fitted.fit(max_steps=STEPS + 2)
    assert not _threads()
