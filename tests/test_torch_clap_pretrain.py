"""lass_torch's CLAP pretraining against lass_tpu's, on the CPU: HTSAT in
train mode (batch statistics, the updated running statistics, fixed
spec-augment stripes; plain, 1D and 2D fusion), the port's own stripe
drawing, ``clip_loss``, one ``CLAPPretrainTask`` step, and the pretraining
CLI for one step in process.

The TINY HTSAT of tests/test_torch_htsat.py (the JAX package's
tests/test_clap_pretrain.py's size) and a 2-layer RoBERTa of width 32;
random weights in the JAX package's variable tree, carried into the port
by ``lass_torch.convert.from_jax``. Random draws cannot match across the
frameworks (flax folds the module path into its keys), so both packages
get the same stripes: lass_tpu's ``_spec_augment`` is monkeypatched to
apply a mask drawn here with numpy, and the port's ``draw_stripes`` to
return the same stripes.

Tolerances: forward and running statistics rel err <= 1e-4 (the JAX
package's float32 bound against the torch reference); the step's loss
<= 1e-5, its grads and updated parameters each as one vector <= 1e-4.
The first AdamW update is about lr * sign(g) wherever |g| >> eps, so a
grad near zero may flip its update; the updated parameters are compared
as one vector, where a few flips stay far below the bound.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lass_tpu.models.clap import htsat as jax_htsat
from lass_tpu.models.clap.model import CLAPAudioEncoder as JaxAudioEncoder
from lass_tpu.models.clap.model import CLAPTextEncoder as JaxTextEncoder
from lass_tpu.models.clap.roberta import RobertaConfig as JaxRobertaConfig
from lass_tpu.tasks import clap_pretrain as jax_task
from lass_tpu.train.optim import cosine_warm_up as jax_cosine
from lass_torch import clap_pretrain as cli
from lass_torch.convert import from_jax
from lass_torch.data.synth import make_synth_corpus, make_synth_shards
from lass_torch.models.clap import htsat
from lass_torch.models.clap import model as clap_model
from lass_torch.models.clap.model import CLAPAudioEncoder, CLAPTextEncoder
from lass_torch.models.clap.roberta import RobertaConfig
from lass_torch.tasks.clap_pretrain import (
    INIT_LOGIT_SCALE, MAX_LOGIT_SCALE, CLAPPretrainTask, clip_loss)
from lass_torch.train.checkpoint import restore_file
from lass_torch.train.optim import cosine_warm_up
from test_torch_htsat import configs, jax_encoder, jax_variables, rel
from torch_threads import torch_threads_per_worker  # noqa: F401

REL = 1e-4
LOSS_REL = 1e-5
ROBERTA = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=64,
               max_position_embeddings=40)
LR, WD = 1e-3, 0.1


# ---------------------------------------------------------------- stripes

def draw(rng, b, t, f):
    """Stripes by width, as the port's ``draw_stripes`` is asked for them
    (time: width 64, frequency: width 8), each at least one wide."""
    return {64: (rng.randint(0, max(t - 64, 1), (b, 2)),
                 rng.randint(1, 65, (b, 2))),
            8: (rng.randint(0, max(f - 8, 1), (b, 2)),
                rng.randint(1, 9, (b, 2)))}


def keep(starts, lengths, size):
    idx = np.arange(size)[None, None, :]
    hit = (idx >= starts[..., None]) & (idx < (starts + lengths)[..., None])
    return (~hit.any(axis=1)).astype(np.float32)


def same_stripes(monkeypatch, stripes):
    """Both packages mask with ``stripes``."""
    def jax_spec_augment(mel, rng, **_):
        t, f = mel.shape[-2], mel.shape[-1]
        tm, fm = keep(*stripes[64], t), keep(*stripes[8], f)
        if mel.ndim == 4:
            return mel * tm[:, None, :, None] * fm[:, None, None, :]
        return mel * tm[:, :, None] * fm[:, None, :]

    def port_draw(batch, size, width, count, generator=None):
        starts, lengths = stripes[width]
        assert starts.shape == (batch, count)
        return torch.from_numpy(starts), torch.from_numpy(lengths)

    monkeypatch.setattr(jax_htsat, "_spec_augment", jax_spec_augment)
    monkeypatch.setattr(htsat, "draw_stripes", port_draw)


def test_port_draws_its_own_stripes():
    """Stripe counts and widths within their ranges; the 4-channel stack
    masked alike in every channel; one generator state, one mask."""
    mel = torch.ones(3, 4, 101, 32)
    out = htsat.spec_augment(mel, torch.Generator().manual_seed(5))
    again = htsat.spec_augment(mel, torch.Generator().manual_seed(5))
    other = htsat.spec_augment(mel, torch.Generator().manual_seed(6))
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    assert not torch.equal(out, other)
    assert all(torch.equal(out[:, c], out[:, 0]) for c in range(4))
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        starts, lengths = htsat.draw_stripes(8, 101, 64, 2, gen)
        assert starts.shape == lengths.shape == (8, 2)
        assert starts.min() >= 0 and starts.max() < 101 - 64
        assert lengths.min() >= 0 and lengths.max() <= 64
        k = htsat.stripe_keep(starts, lengths, 101).numpy()
        np.testing.assert_array_equal(
            k, keep(starts.numpy(), lengths.numpy(), 101).astype(bool))
        # at most two stripes of at most 64 frames each
        assert ((~k).sum(axis=1) <= 128).all()
    # time rows and frequency columns: a zero is a whole row or column
    zero = (out[:, 0] == 0).numpy()
    rows, cols = zero.all(axis=2), zero.all(axis=1)
    np.testing.assert_array_equal(zero, rows[:, :, None] | cols[:, None, :])
    assert (~rows).sum(axis=1).min() >= 101 - 128 and cols.sum(axis=1).max() <= 16


# -------------------------------------------------------- HTSAT, train mode

@pytest.mark.parametrize("fusion_type", [None, "aff_1d", "iaff_2d"])
def test_htsat_train_mode_matches_jax(fusion_type, rng, monkeypatch):
    """The TINY audio tower in train mode: the embedding and every updated
    BN running statistic (bn0; with 1D fusion mel_conv1d's and the fusion
    block's; with 2D the fusion block's)."""
    cfg, _ = configs(fusion_type)
    jmodel, variables, inputs = jax_encoder(fusion_type, rng)
    same_stripes(monkeypatch, draw(rng, 2, 101, 32))
    ref, mutated = jax.jit(lambda v, kw: jmodel.apply(
        v, train=True, mutable=["batch_stats"],
        rngs={"specaug": jax.random.PRNGKey(0)}, **kw))(
        variables, {k: jnp.asarray(v) for k, v in inputs.items()})
    model = CLAPAudioEncoder(cfg)
    model.load_state_dict(from_jax.clap_audio_state_dict_from_jax(
        variables, cfg.depths))
    with torch.no_grad():
        eval_out = model.eval()(**{k: torch.from_numpy(v)
                                   for k, v in inputs.items()})
        got = model.train()(**{k: torch.from_numpy(v)
                               for k, v in inputs.items()})
    assert rel(got.numpy(), ref) <= REL
    assert rel(eval_out.numpy(), ref) > 10 * REL  # batch stats + stripes
    stats = from_jax.clap_audio_state_dict_from_jax(
        {"params": variables["params"], **mutated}, cfg.depths)
    running = [k for k in stats if "running_" in k]
    assert len(running) == {None: 2, "aff_1d": 2 + 2 + 8,
                            "iaff_2d": 2 + 12}[fusion_type]
    own = model.state_dict()
    for key in running:
        assert rel(own[key].numpy(), stats[key].numpy()) <= REL, key


# ------------------------------------------------------------- clip_loss

def test_clip_loss_matches_jax(rng):
    a = rng.randn(6, 16).astype(np.float32)
    t = rng.randn(6, 16).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    scales = np.float32(2.0), np.float32(2.6)
    ref, ref_g = jax.value_and_grad(jax_task.clip_loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (a, t) + scales))
    args = [torch.tensor(x, requires_grad=True) for x in (a, t) + scales]
    got = clip_loss(*args)
    got.backward()
    assert abs(float(got) - float(ref)) <= LOSS_REL * abs(float(ref))
    for x, g in zip(args, ref_g):
        assert rel(x.grad.numpy(), g) <= REL
    # aligned pairs score lower than shuffled ones
    eye = torch.eye(4, 16)
    assert clip_loss(eye, eye, *args[2:]) < clip_loss(eye, eye.flip(0),
                                                      *args[2:])


# --------------------------------------------------------- the train step

def grad_capture():
    """An optax transformation that keeps the grads it is handed in its
    state (the first in the chain: the raw grads)."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


@pytest.fixture(scope="module")
def step_runs():
    """One step of each package's task from the same weights and batch:
    B=4 x 1 s at 48 kHz, captions of 5-9 tokens, the CLI's optimizer chain
    (Adam 0.9 / 0.99 / 1e-8, decayed weights WD on every leaf, LR times a
    one-step warm-up, so the full LR from update 0)."""
    rng = np.random.RandomState(3)
    cfg, jcfg = configs()
    b = 4
    wave = (0.2 * rng.randn(b, 48000)).astype(np.float32)
    ids = rng.randint(3, 100, (b, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    for i, n in enumerate((9, 7, 5, 9)):
        ids[i, n:], mask[i, n:] = 1, 0
    stripes = draw(rng, b, 101, 32)

    jaudio = JaxAudioEncoder(htsat_cfg=jcfg)
    jtext = JaxTextEncoder(JaxRobertaConfig(**ROBERTA))
    audio_vars = jax_variables(jaudio, rng, jnp.asarray(wave[:1]))
    params = {"audio": audio_vars["params"],
              "text": jax_variables(jtext, rng, jnp.asarray(ids[:1]),
                                    jnp.asarray(mask[:1]))["params"],
              "logit_scale_a": np.float32(INIT_LOGIT_SCALE),
              "logit_scale_t": np.float32(INIT_LOGIT_SCALE)}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    schedule = jax_cosine(1, 100)
    chain = optax.chain(
        grad_capture(), optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-8),
        optax.add_decayed_weights(WD),
        optax.scale_by_learning_rate(lambda s: LR * schedule(s)))
    jt = jax_task.CLAPPretrainTask(jaudio, jtext, chain)
    state = jax_task.CLAPTrainState(
        step=jnp.zeros([], jnp.int32), params=params,
        batch_stats=audio_vars["batch_stats"], opt_state=chain.init(params))
    batch = {"waveform": wave, "input_ids": ids, "attention_mask": mask}
    with pytest.MonkeyPatch.context() as mp:
        same_stripes(mp, stripes)
        new_state, jmetrics = jax.jit(jt.train_step)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        torch.manual_seed(0)
        task = CLAPPretrainTask(
            CLAPAudioEncoder(cfg), CLAPTextEncoder(RobertaConfig(**ROBERTA)),
            lr=LR, betas=(0.9, 0.99), eps=1e-8, weight_decay=WD,
            schedule=cosine_warm_up(1, 100))
        task.load_state_dict(from_jax.clap_pretrain_state_dict_from_jax(
            jax.device_get(params), jax.device_get(audio_vars["batch_stats"]),
            ROBERTA["num_hidden_layers"], depths=cfg.depths))
        before = {k: v.clone() for k, v in task.state_dict().items()}
        metrics = task.train_step({"waveform": torch.from_numpy(wave),
                                   "input_ids": torch.from_numpy(ids).long(),
                                   "attention_mask":
                                       torch.from_numpy(mask).long()})

    def port_layout(tree, stats):
        return from_jax.clap_pretrain_state_dict_from_jax(
            jax.device_get(tree), jax.device_get(stats),
            ROBERTA["num_hidden_layers"], depths=cfg.depths)

    return dict(task=task, metrics=metrics, jmetrics=jmetrics, before=before,
                new=port_layout(new_state.params, new_state.batch_stats),
                grads=port_layout(new_state.opt_state[0],
                                  new_state.batch_stats))


def as_vector(sd, keys):
    return np.concatenate([np.asarray(sd[k], np.float64).ravel()
                           for k in keys])


def test_pretrain_step_matches_jax(step_runs):
    task, new, grads = step_runs["task"], step_runs["new"], step_runs["grads"]
    loss = float(step_runs["metrics"]["contrastive_loss"])
    ref = float(step_runs["jmetrics"]["contrastive_loss"])
    assert np.isfinite(loss)
    assert abs(loss - ref) <= LOSS_REL * abs(ref)
    names = {**dict(task.audio_encoder.named_parameters()),
             **dict(task.text_encoder.named_parameters()),
             "logit_scale_a": task.logit_scale_a,
             "logit_scale_t": task.logit_scale_t}
    assert sorted(names) == sorted(k for k in new if "running_" not in k
                                   and "num_batches" not in k)
    own_grads = {k: p.grad.numpy() for k, p in names.items()}
    err = rel(as_vector(own_grads, sorted(names)),
              as_vector(grads, sorted(names)))
    print(f"grads as one vector: rel err {err:.2e}")
    assert err <= REL
    own = task.state_dict()
    err = rel(as_vector(own, sorted(names)), as_vector(new, sorted(names)))
    print(f"updated params as one vector: rel err {err:.2e}")
    assert err <= REL
    running = sorted(k for k in new if "running_" in k)
    assert running == ["audio_branch.bn0.running_mean",
                       "audio_branch.bn0.running_var"]
    assert rel(as_vector(own, running), as_vector(new, running)) <= REL
    # every parameter moved, and the logit scales decayed and trained
    before = step_runs["before"]
    assert all(not torch.equal(own[k], before[k]) for k in names)
    assert abs(float(own["logit_scale_a"]) - float(new["logit_scale_a"])) \
        <= REL * INIT_LOGIT_SCALE


def test_scales_clamp_at_ln_100(step_runs):
    task = step_runs["task"]
    metrics = step_runs["metrics"]
    assert float(metrics["logit_scale_a"]) == pytest.approx(
        float(np.exp(float(task.logit_scale_a))), rel=1e-6)
    with torch.no_grad():
        task.logit_scale_a.fill_(MAX_LOGIT_SCALE + 0.5)
    task.optimizer.param_groups[0]["lr"] = 0.0
    wave = torch.zeros(2, 48000)
    ids = torch.full((2, 4), 5)
    out = task.train_step({"waveform": wave, "input_ids": ids,
                           "attention_mask": torch.ones_like(ids)})
    assert float(task.logit_scale_a) == pytest.approx(MAX_LOGIT_SCALE)
    assert float(out["logit_scale_a"]) == pytest.approx(100.0, rel=1e-6)
    assert task.step == 2


# ------------------------------------------------------------------ CLI

def test_pretrain_cli_one_step(tmp_path, capsys, monkeypatch):
    """``python -m lass_torch.clap_pretrain`` in process, HTSAT-tiny, B=2 x
    0.5 s of FLAC tar shards, one step, val retrieval on a synthetic
    datafile; the step-1 checkpoint restores into ``build_task``'s task.
    Then one step over that datafile through ``--datafiles``
    (``AudioTextDataset`` + ``DataModule``), which records no decode_s.
    The text tower is narrowed to 2 layers of width 32 (RoBERTa-base's
    vocabulary and more than 77 positions, for the CLI's tokenizer), so
    the checkpoint is 0.3 GB, not 1.85; the card runs RoBERTa-base
    (chip_smoke.py phase 10)."""
    narrow = RobertaConfig(**{**ROBERTA, "vocab_size": 50265,
                              "max_position_embeddings": 80})
    monkeypatch.setattr(clap_model, "CLAPTextEncoder",
                        lambda: CLAPTextEncoder(narrow))
    shards = make_synth_shards(str(tmp_path / "shards"), num_shards=2,
                               per_shard=2, seconds=0.5, audio_format="flac")
    val = make_synth_corpus(str(tmp_path / "val"), num_clips=2,
                            sample_rate=48000, seconds_min=0.5,
                            seconds_max=0.5, alt_rate_fraction=0.0)
    argv = ["--workspace", str(tmp_path / "ws"), "--train_shards", shards,
            "--val_datafiles", val, "--amodel", "HTSAT-tiny",
            "--batch_size", "2", "--clip_seconds", "0.5", "--max_steps", "1",
            "--num_workers", "1", "--device", "cpu"]
    cli.main(argv)
    out = capsys.readouterr().out
    assert "finished at step 1" in out
    final = out.split("final retrieval:")[1].splitlines()[0]
    assert "'num_samples': 2.0" in final and "R@1" in final
    sub = os.path.join("clap_pretrain", "clap_pretrain,devices=1")
    with open(tmp_path / "ws" / "tf_logs" / sub / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows[0]["step"] == 1 and np.isfinite(rows[0]["contrastive_loss"])
    assert rows[0]["decode_s"] > 0
    ckpt = str(tmp_path / "ws" / "checkpoints" / sub / "1.ckpt")
    task = cli.build_task(cli.parser().parse_args(argv), "cpu")
    assert restore_file(ckpt, task) == 1
    assert len(task.optimizer.state_dict()["state"]) == len(task.parameters())
    with pytest.raises(SystemExit):
        cli.main(argv[:4] + ["--datafiles", val, "--device", "cpu"])

    cli.main(["--workspace", str(tmp_path / "ws2"), "--datafiles", val,
              *argv[6:]])
    assert "finished at step 1" in capsys.readouterr().out
    with open(tmp_path / "ws2" / "tf_logs" / sub / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows[0]["step"] == 1 and np.isfinite(rows[0]["contrastive_loss"])
    assert "decode_s" not in rows[0]
    assert os.path.exists(tmp_path / "ws2" / "checkpoints" / sub / "1.ckpt")
