"""The port's audio and hybrid query conditioning against lass_tpu's, on
the CPU: the host audio features, ``get_query_embed('audio' | 'hybird')``
through ``attach_audio_encoder`` (TINY HTSAT, a small text tower) at 32
and 16 kHz, ``from_npz`` with an audio branch, one hybrid premixed train
step, and the hybrid ``Trainer`` (resume, the eval hook, the CLI's eval
flags).

Both packages get the same weights: random values in the JAX variable
trees, through ``lass_torch.convert.from_jax`` (audio) and the port's text
tower through the JAX package's own converter (text). Tolerances:
embeddings rel err <= 1e-4 (the JAX package's float32 bound against the
torch reference); host features equal (the same numpy code); the premixed
step within tests/test_torch_train_step.py's bounds (loss, grad norm and
updated parameters at rel 1e-4); a resumed run's losses at rel 1e-6 of
the uninterrupted run's (tests/test_torch_trainer.py's bound).
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import numpy as np
import pytest
import torch

import test_torch_train_step as small_step
from lass_tpu.convert.torch_to_jax import convert_clap_text_encoder
from lass_tpu.models.clap import audio_features as jax_features
from lass_tpu.models.clap.model import CLAPAudioEncoder as JaxAudioEncoder
from lass_tpu.models.clap.roberta import RobertaConfig as JaxRobertaConfig
from lass_tpu.models.query_encoder import CLAPQueryEncoder as JaxQueryEncoder
from lass_tpu.tasks.audiosep import AudioSepTask as JaxTask
from lass_tpu.tasks.audiosep import TrainState as JaxTrainState
from lass_tpu.train.optim import build_optimizer as jax_build_optimizer
from lass_torch.convert.from_jax import clap_audio_state_dict_from_jax
from lass_torch.data.mixer import SegmentMixer
from lass_torch.data.synth import (
    make_synth_corpus, make_synth_eval_set, write_train_config)
from lass_torch.models.clap import audio_features
from lass_torch.models.clap.roberta import RobertaConfig
from lass_torch.models.clap.tokenizer import WhitespaceFallbackTokenizer
from lass_torch.models.query_encoder import CLAPQueryEncoder
from lass_torch.nn.layers import BatchNorm
from lass_torch.tasks.audiosep import AudioSepTask
from lass_torch.train import __main__ as cli
from lass_torch.train import loop
from lass_torch.train.optim import build_optimizer
from test_torch_htsat import configs, jax_variables, rel
from torch_threads import torch_threads_per_worker  # noqa: F401

REL = 1e-4
SMALL = dict(vocab_size=200, hidden_size=32, num_hidden_layers=1,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=80)
CLIP = 48000  # 1 s at 48 kHz: TINY's clip
CAPTIONS = ["a dog barking", "rain on a roof"]


def audio_variables(seed=0):
    """Random CLAPAudioEncoder variables (TINY HTSAT) in the JAX tree."""
    _, jcfg = configs()
    return jax_variables(JaxAudioEncoder(htsat_cfg=jcfg),
                         np.random.RandomState(seed), jnp.zeros((1, CLIP)))


def port_encoder(variables=None, sampling_rate=32000, clip_samples=CLIP,
                 device="cpu"):
    """A small text tower (the same weights at every call) and the TINY
    audio tower."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        enc = CLAPQueryEncoder(roberta_cfg=RobertaConfig(**SMALL),
                               tokenizer=WhitespaceFallbackTokenizer(200),
                               device=device)
    enc.attach_audio_encoder(
        clap_audio_state_dict_from_jax(variables or audio_variables(),
                                       configs()[0].depths),
        configs()[0], sampling_rate=sampling_rate, clip_samples=clip_samples)
    return enc


def jax_encoder(port, variables, sampling_rate):
    """lass_tpu's query encoder with the port encoder's text weights and
    the same audio variables."""
    text = convert_clap_text_encoder(port.text_model.state_dict(),
                                     SMALL["num_hidden_layers"])
    enc = JaxQueryEncoder(text_params=jax.tree_util.tree_map(jnp.asarray,
                                                             text),
                          tokenizer=port.tokenizer,
                          roberta_cfg=JaxRobertaConfig(**SMALL))
    enc.attach_audio_encoder(audio_params=jax.tree_util.tree_map(
        jnp.asarray, variables), htsat_cfg=configs()[1],
        sampling_rate=sampling_rate, clip_samples=CLIP)
    return enc


def clips(rate, rng, seconds=1.0):
    """Two different 1 s clips: a tone over noise, and noise."""
    n = int(rate * seconds)
    t = np.arange(n) / rate
    tone = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.02 * rng.randn(n)
    return np.stack([tone, 0.1 * rng.randn(n)]).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """{rate: (port encoder, JAX encoder)} on the same weights."""
    variables = audio_variables()
    out = {}
    for rate in (32000, 16000):
        port = port_encoder(variables, sampling_rate=rate)
        out[rate] = port, jax_encoder(port, variables, rate)
    return out


@pytest.mark.parametrize("length,filling", [
    (48000, "repeatpad"), (20000, "repeatpad"), (20000, "pad"),
    (20000, "repeat"), (70000, "repeatpad")])
def test_prepare_audio_equals_jax(length, filling, rng):
    x = (0.1 * rng.randn(3, length)).astype(np.float32)
    got = audio_features.prepare_audio(x[0], CLIP, filling,
                                       rng=np.random.default_rng(5))
    ref = jax_features.prepare_audio(x[0], CLIP, filling,
                                     rng=np.random.default_rng(5))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        audio_features.prepare_audio_batch(x, CLIP, filling),
        jax_features.prepare_audio_batch(x, CLIP, filling))


@pytest.mark.parametrize("rate", [32000, 16000])
def test_audio_embed_matches_jax(pair, rate, rng):
    port, ref_enc = pair[rate]
    audio = clips(rate, rng)
    got = port.get_query_embed("audio", audio=audio)
    ref = np.asarray(ref_enc.get_query_embed("audio",
                                             audio=jnp.asarray(audio)))
    assert got.shape == (2, 512)
    assert rel(got.numpy(), ref) <= REL
    torch.testing.assert_close(torch.linalg.vector_norm(got, dim=-1),
                               torch.ones(2))
    # (B, 1, L) and a length that is not 1 s (host fill) agree with JAX too
    short = audio[:, None, : rate // 2]
    got = port.get_query_embed("audio", audio=torch.from_numpy(short))
    ref = np.asarray(ref_enc.get_query_embed("audio",
                                             audio=jnp.asarray(short)))
    assert rel(got.numpy(), ref) <= REL


def test_whole_batch_is_embedded(pair, rng):
    port, _ = pair[32000]
    audio = clips(32000, rng)
    both = port.get_query_embed("audio", audio=audio)
    # random weights map different clips to nearby directions; the rows
    # still differ far beyond float32 noise
    assert both.shape == (2, 512) and (both[0] - both[1]).abs().max() > 1e-4
    for i in range(2):
        one = port.get_query_embed("audio", audio=audio[i:i + 1])
        torch.testing.assert_close(one[0], both[i], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
def test_hybrid_takes_jax_branch(pair, ratio, rng):
    port, ref_enc = pair[32000]
    audio = clips(32000, rng)
    as_audio = port.get_query_embed("audio", audio=audio)
    as_text = port.get_query_embed("text", text=CAPTIONS)
    kinds = []
    for seed in list(range(6)) + [None] * 3:  # None: the encoders' own rng
        got = port.get_query_embed("hybird", audio=audio, text=CAPTIONS,
                                   use_text_ratio=ratio, seed=seed)
        ref = np.asarray(ref_enc.get_query_embed(
            "hybird", audio=jnp.asarray(audio), text=CAPTIONS,
            use_text_ratio=ratio, seed=seed))
        assert rel(got.numpy(), ref) <= REL
        kind = "audio" if torch.equal(got, as_audio) else "text"
        assert kind == "audio" or torch.equal(got, as_text)
        kinds.append(kind)
    expect = {0.0: {"audio"}, 1.0: {"text"}, 0.5: {"audio", "text"}}[ratio]
    assert set(kinds) == expect


def test_no_audio_tower_raises():
    enc = CLAPQueryEncoder(roberta_cfg=RobertaConfig(**SMALL),
                           tokenizer=WhitespaceFallbackTokenizer(200),
                           device="cpu")
    assert enc.audio_model is None and not enc.has_pretrained_audio
    with pytest.raises(NotImplementedError, match="attach_audio_encoder"):
        enc.get_query_embed("hybird", audio=np.zeros((1, 32000)),
                            text=["x"], use_text_ratio=1.0, seed=0)


def test_from_npz_reads_the_audio_branch(pair, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "convert_ckpt", "scripts/convert_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    port, _ = pair[32000]
    text = convert_clap_text_encoder(port.text_model.state_dict(),
                                     SMALL["num_hidden_layers"])
    variables = audio_variables(seed=3)
    pack = tmp_path / "clap.npz"
    np.savez(pack, **{f"text/params/{k}": v
                      for k, v in mod.flatten(text).items()},
             **{f"audio/params/{k}": v
                for k, v in mod.flatten(variables["params"]).items()},
             **{f"audio/batch_stats/{k}": v
                for k, v in mod.flatten(variables["batch_stats"]).items()})
    enc = CLAPQueryEncoder.from_npz(
        str(pack), roberta_cfg=RobertaConfig(**SMALL), htsat_cfg=configs()[0],
        device="cpu", tokenizer=WhitespaceFallbackTokenizer(200))
    assert enc.has_pretrained_text and enc.has_pretrained_audio
    assert (enc.sampling_rate, enc.clip_samples) == (32000, 480000)
    # the pack's branches are the weights from_jax gives (whose forward
    # test_audio_embed_matches_jax holds against JAX's)
    want = port_encoder(variables)
    for got, ref in ((enc.audio_model, want.audio_model),
                     (enc.text_model, port.text_model)):
        ref = ref.state_dict()
        assert got.state_dict().keys() == ref.keys()
        for key, value in got.state_dict().items():
            assert torch.equal(value, ref[key]), key


def test_hybrid_premixed_step_matches_jax(pair):
    """One premixed step of tests/test_torch_train_step.py's small
    separator (its batch, its random BN affines) on each side, with a
    512-d condition from 'hybird' (a seed whose coin picks audio) on the
    segments; the port's condition fed to both steps (the two towers'
    conditions agree at REL, checked here too). Its bounds: loss and grad
    norm at REL, the grads as one vector at REL and per tensor at
    10 * REL, the updated parameters and BN statistics at REL."""
    port, ref_enc = pair[16000]
    seed = 0  # np.random.default_rng(0).random() = 0.64 > 0.5: audio
    batch = small_step._batch(np.random.RandomState(3))
    segment = torch.from_numpy(batch["segment"][:, 0])
    cond = port.get_query_embed("hybird", audio=segment, text=CAPTIONS,
                                use_text_ratio=0.5, seed=seed).clone()
    assert torch.equal(cond, port.get_query_embed("audio", audio=segment))
    assert rel(cond.numpy(), ref_enc.get_query_embed(
        "hybird", audio=jnp.asarray(segment.numpy()), text=CAPTIONS,
        use_text_ratio=0.5, seed=seed)) <= REL
    batch["condition"] = cond.numpy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(small_step, "COND", 512)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = small_step.TorchSmallSep()
            with torch.no_grad():
                for m in model.modules():
                    if isinstance(m, BatchNorm):
                        m.weight.add_(0.1 * torch.randn(m.weight.shape))
                        m.bias.add_(0.1 * torch.randn(m.bias.shape))
        params, stats = small_step._jax_variables(model.state_dict())
        jtask = JaxTask(small_step.JaxSmallSep(), small_step.JaxMixer(),
                        jax_build_optimizer(*small_step.OPTIM))
        state = JaxTrainState(step=jnp.zeros([], jnp.int32), params=params,
                              batch_stats=stats,
                              opt_state=jtask.optimizer.init(params))
        state, jmetrics = jax.jit(jtask.train_step_premixed)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    # the grads the JAX step used, from its AMSGrad first moment
    _, unravel = ravel_pytree(state.params)
    jgrads = small_step._state_dict(unravel(jnp.asarray(
        np.asarray(state.opt_state[0].mu) / np.float32(0.1))),
        state.batch_stats)
    optimizer, scheduler = build_optimizer(model.parameters(),
                                           *small_step.OPTIM)
    task = AudioSepTask(model, SegmentMixer(), optimizer, scheduler)
    metrics = task.train_step_premixed(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("train_loss", "grad_norm"):
        assert abs(float(metrics[key]) - float(jmetrics[key])) <= REL * abs(
            float(jmetrics[key])), key
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    names = sorted(grads)
    assert rel(np.concatenate([grads[k].ravel() for k in names]),
               np.concatenate([jgrads[k].numpy().ravel() for k in names])
               ) <= REL
    for name in names:
        if np.linalg.norm(jgrads[name].numpy()) == 0:  # dead FiLM columns
            assert not grads[name].any()
        else:
            assert rel(grads[name], jgrads[name].numpy()) <= 10 * REL, name
    jstate = small_step._state_dict(state.params, state.batch_stats)
    for name, v in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert rel(v.numpy(), jstate[name].numpy()) <= REL, name


def metrics_by_step(trainer):
    out = {}
    with open(os.path.join(trainer.tf_logs_dir, "metrics.jsonl")) as f:
        for record in map(json.loads, f):
            out.setdefault(record["step"], {}).update(record)
    return out


@pytest.fixture(scope="module")
def hybrid_runs(tmp_path_factory):
    """Full-width ResUNet30 in float32, B=2 x 0.16 s at 16 kHz,
    use_text_ratio 0.5 with random_seed 1 (coins: audio, text, audio),
    3 steps; then a run resumed from step 2."""
    root = tmp_path_factory.mktemp("hybrid")
    datafile = make_synth_corpus(str(root / "synth"), num_clips=6,
                                 seconds_min=0.6, seconds_max=1.0, seed=3)
    config = write_train_config(
        str(root / "config.yaml"), datafile, batch_size=2,
        segment_seconds=0.16, num_workers=2, save_step_frequency=2,
        compute_dtype="float32", use_text_ratio=0.5, random_seed=1)
    runs = {}
    for name, resume in (("run", None), ("resumed", "2.ckpt")):
        enc = port_encoder(sampling_rate=16000)
        calls = []
        enc.audio_model.register_forward_hook(
            lambda *_: calls.append(1))
        trainer = loop.Trainer(
            config, str(root / name), device="cpu", query_encoder=enc,
            log_every=1, resume_checkpoint_path=resume and os.path.join(
                runs["run"][0].checkpoints_dir, resume))
        trainer.fit(max_steps=3)
        runs[name] = trainer, calls
    return runs


def test_hybrid_trainer_resumes_exactly(hybrid_runs):
    (first, calls), (resumed, r_calls) = hybrid_runs["run"], \
        hybrid_runs["resumed"]
    got, ref = metrics_by_step(resumed), metrics_by_step(first)
    assert sorted(ref) == [1, 2, 3] and sorted(got) == [3]
    assert all(np.isfinite(r["train_loss"]) for r in ref.values())
    assert got[3]["train_loss"] == pytest.approx(ref[3]["train_loss"],
                                                 rel=1e-6)
    # the audio tower ran on the audio coins only: steps 1 and 3; step 3
    # in the resumed run
    assert len(calls) == 2 and len(r_calls) == 1


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    """One text-conditioned step with the DCASE eval hook at step 1 (one
    synthetic row, batch 1: the hook pads each row to 10 s, and a ragged
    batch to the batch size, so every extra row of the batch costs a
    10 s forward on the CPU)."""
    root = tmp_path_factory.mktemp("eval")
    datafile = make_synth_corpus(str(root / "synth"), num_clips=3,
                                 seconds_min=0.6, seconds_max=0.8, seed=2)
    eval_csv = make_synth_eval_set(str(root / "eval"), num_rows=1,
                                   seconds=0.5, num_captions=1)
    config = write_train_config(
        str(root / "config.yaml"), datafile, batch_size=2,
        segment_seconds=0.16, num_workers=1, save_step_frequency=10,
        compute_dtype="float32", evaluate_step_frequency=1)
    trainer = loop.Trainer(config, str(root / "ws"), device="cpu",
                           query_encoder=port_encoder(), log_every=1)
    trainer.fit(max_steps=1, eval_hook=loop.make_dcase_eval_hook(
        eval_csv, str(root / "eval"), batch_size=1))
    return root, config, eval_csv, trainer


def test_eval_hook_writes_the_eval_metrics(eval_run):
    *_, trainer = eval_run
    record = metrics_by_step(trainer)[1]
    for key in ("eval_SISDR", "eval_SDRi", "eval_SDR"):
        assert np.isfinite(record[key]), key
    assert trainer.timing["eval"] > 0
    assert [s["steps"] for s in trainer.statistics.statistics_dict["test"]] \
        == [1]
    assert os.path.exists(trainer.statistics.statistics_path)


def test_cli_eval_flags(eval_run, monkeypatch):
    """The CLI's flags reach make_dcase_eval_hook and its metrics reach
    metrics.jsonl (a stand-in hook: the real one is tested above)."""
    root, config, eval_csv, _ = eval_run
    made = []

    def fake_hook(csv, audio_dir):
        made.append((csv, audio_dir))
        return lambda trainer, step: {"eval_SDR": 1.5}

    monkeypatch.setattr(loop, "CLAPQueryEncoder",
                        lambda device: port_encoder(device=device))
    monkeypatch.setattr(loop, "make_dcase_eval_hook", fake_hook)
    args = ["--workspace", str(root / "cli"), "--config_yaml", config,
            "--resume_checkpoint_path", "", "--max_steps", "1",
            "--device", "cpu", "--eval_indexes", eval_csv]
    with pytest.raises(SystemExit):
        cli.main(args)
    cli.main(args + ["--eval_audio_dir", str(root / "eval")])
    assert made == [(eval_csv, str(root / "eval"))]
    path = os.path.join(str(root / "cli"), "tf_logs", "train",
                        "config,devices=1", "metrics.jsonl")
    records = [json.loads(line) for line in open(path)]
    assert [(r["step"], r["eval_SDR"]) for r in records
            if "eval_SDR" in r] == [(1, 1.5)]
