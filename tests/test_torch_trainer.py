"""The port's training loop on the CPU: Trainer.fit on a tiny synthetic
corpus, checkpoints, metrics and resume; the batch order against
lass_tpu's DataModule; safe collate; serving a trainer checkpoint; the CLI
with --device cpu. Full-width ResUNet30 in float32, B=2 x 0.16 s, a small
random caption encoder (the default RoBERTa-base takes seconds to build).

Resume tolerance: 1e-6 relative on the step-3 loss (the same float32
arithmetic on the same CPU from the same restored state).
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from lass_tpu.data.datafiles import AudioTextDataset as JaxDataset
from lass_tpu.data.datamodule import DataModule as JaxDataModule
from lass_tpu.data.synth import make_synth_corpus as jax_make_synth_corpus
from lass_torch.audio.io import write_wav
from lass_torch.config import load_config
from lass_torch.convert.checkpoint_io import load_ss_model
from lass_torch.data.datafiles import AudioTextDataset
from lass_torch.data.datamodule import DataModule
from lass_torch.data.synth import make_synth_corpus, write_train_config
from lass_torch.models.clap.roberta import RobertaConfig
from lass_torch.models.clap.tokenizer import WhitespaceFallbackTokenizer
from lass_torch.models.query_encoder import CLAPQueryEncoder
from lass_torch.train import __main__ as cli
from lass_torch.train import loop
from lass_torch.train.checkpoint import CheckpointManager
from lass_torch.utils.statistics import StatisticsContainer

SMALL = dict(vocab_size=200, hidden_size=32, num_hidden_layers=1,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=80)


def small_encoder(device="cpu"):
    """The same random weights at every call (a resumed run must see the
    conditioning the first run saw)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return CLAPQueryEncoder(roberta_cfg=RobertaConfig(**SMALL),
                                tokenizer=WhitespaceFallbackTokenizer(200),
                                device=device)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    datafile = make_synth_corpus(str(root / "synth"), num_clips=7,
                                 seconds_min=0.6, seconds_max=1.0,
                                 alt_rate_fraction=0.3, seed=3)
    config = write_train_config(str(root / "config.yaml"), datafile,
                                batch_size=2, segment_seconds=0.16,
                                num_workers=2, save_step_frequency=2,
                                compute_dtype="float32")
    return root, datafile, config


def _metrics(trainer):
    path = os.path.join(trainer.tf_logs_dir, "metrics.jsonl")
    return {r["step"]: r for r in map(json.loads, open(path))}


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == "batch-loader"]


@pytest.fixture(scope="module")
def trained(corpus):
    root, _, config = corpus
    trainer = loop.Trainer(config, str(root / "run"), device="cpu",
                           query_encoder=small_encoder(), log_every=1)
    trainer.fit(max_steps=3)
    return trainer


def test_fit_logs_and_checkpoints(trained):
    assert trained.task.step == 3
    records = _metrics(trained)
    assert sorted(records) == [1, 2, 3]
    assert all(np.isfinite(r["train_loss"]) and r["grad_norm"] > 0
               for r in records.values())
    # step 1 (the reference cadence) and every save_step_frequency = 2
    assert trained.ckpt.steps() == [1, 2]
    assert not _loader_threads()


def test_resume_continues_the_uninterrupted_run(corpus, trained):
    root, _, config = corpus
    resumed = loop.Trainer(config, str(root / "resumed"), device="cpu",
                           resume_checkpoint_path=trained.ckpt.path(2),
                           query_encoder=small_encoder(), log_every=1)
    assert resumed.task.step == 2
    resumed.fit(max_steps=3)
    got, ref = _metrics(resumed), _metrics(trained)
    assert sorted(got) == [3]
    assert got[3]["train_loss"] == pytest.approx(ref[3]["train_loss"],
                                                 rel=1e-6)
    # a checkpoint directory resumes from its latest file
    assert loop._resume_path(trained.checkpoints_dir) == trained.ckpt.path(2)


def test_trainer_checkpoint_serves_through_load_ss_model(corpus, trained):
    _, _, config = corpus
    sep = load_ss_model(load_config(config), trained.ckpt.path(2),
                        query_encoder=small_encoder(), device="cpu")
    ref = torch.load(trained.ckpt.path(2), weights_only=True)["state_dict"]
    got = sep.model.state_dict()
    assert torch.equal(got["base.encoder_block1.conv_block1.conv1.weight"],
                       ref["ss_model.base.encoder_block1.conv_block1."
                           "conv1.weight"])
    cond = sep.query_encoder.get_query_embed("text", text=["a tone"])
    mixture = np.random.RandomState(0).randn(1, 1, 4000).astype(
        np.float32) * 0.1
    out = sep.separate(mixture, cond)
    assert out.shape == (1, 1, 4000) and np.isfinite(out).all()


def test_batch_order_matches_lass_tpu(corpus):
    _, datafile, _ = corpus
    ours = DataModule(AudioTextDataset([datafile], 16000, 0.16), 2,
                      num_workers=2, seed=5)
    ref = JaxDataModule(JaxDataset([datafile], 16000, 0.16), 2,
                        num_workers=2, seed=5)
    for skip in (0, 4):
        it_ref = ref._iter_batches(skip)
        with ours.train_dataloader(skip_batches=skip) as it:
            for _ in range(5):  # across an epoch boundary (3 per epoch)
                a, b = next(it)["audio_text"], next(it_ref)["audio_text"]
                assert a["text"] == b["text"]
                np.testing.assert_array_equal(a["waveform"], b["waveform"])
        it_ref.close()
    assert not _loader_threads()


def test_collate_skips_a_corrupt_wav(tmp_path):
    entries = []
    for i in range(5):
        path = str(tmp_path / f"clip_{i}.wav")
        write_wav(path, 0.1 * np.random.RandomState(i).randn(1, 12000),
                  16000)
        entries.append({"wav": path, "caption": f"clip {i}"})
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"junk")
    short = str(tmp_path / "short.wav")
    write_wav(short, np.zeros((1, 4000)), 16000)
    entries += [{"wav": str(bad), "caption": "corrupt"},
                {"wav": short, "caption": "short"}]
    datafile = tmp_path / "data.json"
    datafile.write_text(json.dumps({"data": entries}))
    dataset = AudioTextDataset([str(datafile)], 16000, 0.5,
                               suppress_warnings=True)
    with DataModule(dataset, 3, num_workers=2, seed=1).train_dataloader() \
            as it:
        batches = [next(it)["audio_text"] for _ in range(4)]
    for b in batches:
        assert b["waveform"].shape == (3, 1, 8000)
        assert len(b["text"]) == 3
        assert not {"corrupt", "short"} & set(b["text"])
    assert dataset.get_dropped_count() >= 2


def test_loader_thread_joined_when_a_step_fails(trained, monkeypatch):
    def boom(*_):
        raise RuntimeError("step failed")

    monkeypatch.setattr(trained.task, "train_step", boom)
    with pytest.raises(RuntimeError, match="step failed"):
        trained.fit(max_steps=5)
    assert not _loader_threads()


def test_cli_trains_on_the_cpu(corpus, monkeypatch):
    root, _, config = corpus
    monkeypatch.setattr(loop, "CLAPQueryEncoder",
                        lambda device: small_encoder(device))
    counts = root / "counts.json"
    cli.main(["--workspace", str(root / "cli"), "--config_yaml", config,
              "--resume_checkpoint_path", "", "--max_steps", "1",
              "--device", "cpu", "--launch_counts", str(counts)])
    ckpts = os.path.join(str(root / "cli"), "checkpoints", "train",
                         "config,devices=1")
    assert os.listdir(ckpts) == ["1.ckpt"]
    # the CPU path launches no kernel
    assert set(json.loads(counts.read_text()).values()) == {0}


def test_hybrid_conditioning_waits_for_the_audio_tower(corpus, tmp_path):
    _, datafile, _ = corpus
    config = write_train_config(str(tmp_path / "hybrid.yaml"), datafile,
                                use_text_ratio=0.5)
    with pytest.raises(NotImplementedError, match="audio tower"):
        loop.Trainer(config, str(tmp_path / "ws"), device="cpu",
                     query_encoder=small_encoder())


def test_synth_corpus_is_byte_identical_to_lass_tpu(tmp_path):
    kwargs = dict(num_clips=3, seconds_min=0.2, seconds_max=0.4,
                  alt_rate_fraction=0.5, seed=9)
    a = make_synth_corpus(str(tmp_path / "a"), **kwargs)
    b = jax_make_synth_corpus(str(tmp_path / "b"), **kwargs)
    da, db = json.load(open(a)), json.load(open(b))
    assert [e["caption"] for e in da["data"]] == [
        e["caption"] for e in db["data"]]
    for ea, eb in zip(da["data"], db["data"]):
        assert open(ea["wav"], "rb").read() == open(eb["wav"], "rb").read()
    assert make_synth_corpus(str(tmp_path / "a"), **kwargs) == a  # reused


def test_checkpoint_cadence_and_statistics(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_step_frequency=3)
    assert [s for s in range(8) if mgr.should_save(s)] == [1, 3, 6]
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(None, None)
    stats = StatisticsContainer(str(tmp_path / "stats" / "statistics.pkl"))
    stats.append(1, {"sdr": 1.0}, "test")
    stats.append(5, {"sdr": 2.0}, "test")
    again = StatisticsContainer(stats.statistics_path)
    again.load(resume_steps=3)
    assert again.statistics_dict["test"] == [{"sdr": 1.0, "steps": 1}]
