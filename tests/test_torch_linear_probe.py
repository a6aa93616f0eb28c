"""lass_torch's linear probe, its losses and metrics, retrieval and
zero-shot against lass_tpu's, on the CPU, and the linear-probe CLI for one
step in process (with ``--init_npz``).

The probe: the TINY HTSAT at 16 kHz of tests/test_linear_probe.py and a
Cnn6 trunk, random weights in the JAX package's variable tree through
``linear_probe_state_dict_from_jax``; head Linear or MLP, each ``act``;
with ``freeze`` the trunk runs in eval mode and gets no gradient, without
it it trains (fixed spec-augment stripes on both sides); the MLP head's
dropout replays numpy masks on both sides (flax ``nn.Dropout`` and the
port's ``dropout`` monkeypatched). Tolerances: logits and lp_layer grads
rel err <= 1e-4 (float32, the JAX package's bound against the torch
reference), losses <= 1e-6 relative; the numpy metrics (mAP, acc, mAUC,
retrieval) equal to 1e-12; zero-shot accuracies equal (counts of the same
top-k sets).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.dsp.mel import LogMelConfig as JaxMelConfig
from lass_tpu.evaluation import linear_probe as jax_lp_eval
from lass_tpu.evaluation import retrieval as jax_retrieval
from lass_tpu.evaluation import zero_shot as jax_zero_shot
from lass_tpu.models.clap import htsat as jax_htsat
from lass_tpu.models.clap import linear_probe as jax_lp
from lass_tpu.models.clap import pann as jax_pann
from lass_tpu.models.clap.model import CLAPAudioEncoder as JaxAudioEncoder
from lass_torch import linear_probe as cli
from lass_torch.convert import from_jax
from lass_torch.data.synth import make_synth_shards
from lass_torch.dsp.mel import LogMelConfig
from lass_torch.evaluation import linear_probe as lp_eval
from lass_torch.evaluation import retrieval, zero_shot
from lass_torch.models.clap import htsat, linear_probe, pann
from lass_torch.models.clap.linear_probe import LinearProbe
from lass_torch.train.checkpoint import restore_file
from test_torch_clap_pretrain import draw, same_stripes
from test_torch_htsat import jax_variables, random_tree, rel
from test_torch_pann import Masks
from torch_threads import torch_threads_per_worker  # noqa: F401

REL = 1e-4
TINY = dict(spec_size=128, embed_dim=16, depths=(1, 1, 1, 1),
            num_heads=(2, 2, 2, 2), window_size=4)
MEL = dict(sample_rate=16000, n_fft=256, hop_length=160, n_mels=32)
PANN_MEL = dict(sample_rate=16000, n_fft=256, hop_length=160, n_mels=64)


def trunk_configs(audio_model):
    if audio_model == "PANN":
        return (pann.PANNConfig("Cnn6", mel=LogMelConfig(**PANN_MEL)),
                jax_pann.PANNConfig("Cnn6", mel=JaxMelConfig(**PANN_MEL)))
    return (htsat.HTSATConfig(mel=LogMelConfig(**MEL), **TINY),
            jax_htsat.HTSATConfig(mel=JaxMelConfig(**MEL), **TINY))


def probes(rng, audio_model="HTSAT", **kw):
    """(JAX probe, its variables, the port's probe with them, a B=2 x 1 s
    batch)."""
    cfg, jcfg = trunk_configs(audio_model)
    jprobe = jax_lp.LinearProbe(audio_model=audio_model, audio_cfg=jcfg, **kw)
    wave = (0.1 * rng.randn(2, 16000)).astype(np.float32)
    variables = jax_variables(jprobe, rng, jnp.asarray(wave))
    probe = LinearProbe(audio_model=audio_model, audio_cfg=cfg, **kw)
    probe.load_state_dict(from_jax.linear_probe_state_dict_from_jax(
        variables, audio_model, depths=TINY["depths"]))
    return jprobe, variables, probe, wave


@pytest.mark.parametrize("audio_model,mlp,act", [
    ("HTSAT", False, None), ("HTSAT", True, "sigmoid"),
    ("HTSAT", False, "softmax"), ("HTSAT", True, "elu"),
    ("PANN", False, "relu")])
def test_probe_eval_matches_jax(audio_model, mlp, act, rng):
    jprobe, variables, probe, wave = probes(rng, audio_model, out_ch=7,
                                            mlp=mlp, act=act)
    ref = jax.jit(jprobe.apply)(variables, jnp.asarray(wave))
    with torch.no_grad():
        got = probe.eval()(torch.from_numpy(wave))
    assert got.shape == (2, 7)
    assert rel(got.numpy(), ref) <= REL
    keys = [k for k in probe.state_dict() if k.startswith("lp_layer.")]
    assert keys == (["lp_layer.0.weight", "lp_layer.0.bias",
                     "lp_layer.3.weight", "lp_layer.3.bias"] if mlp
                    else ["lp_layer.weight", "lp_layer.bias"])


@pytest.mark.parametrize("freeze", [True, False])
def test_probe_train_step_grads_match_jax(freeze, rng, monkeypatch):
    """An MLP probe in train mode, lp_loss('bce'): the loss and the head's
    grads; frozen, the trunk keeps eval mode and gets no grad; unfrozen,
    it trains (batch statistics, stripes) and its grads match too."""
    jprobe, variables, probe, wave = probes(rng, out_ch=5, mlp=True,
                                            freeze=freeze)
    target = (rng.rand(2, 5) > 0.5).astype(np.float32)
    same_stripes(monkeypatch, draw(rng, 2, 101, 32))
    masks = Masks(3)
    monkeypatch.setattr(jax_lp.nn, "Dropout", masks.flax_dropout)
    monkeypatch.setattr(linear_probe, "dropout", masks.port_dropout)

    def loss_fn(params):
        out, _ = jprobe.apply({**variables, "params": params},
                              jnp.asarray(wave), True,
                              mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0),
                                    "specaug": jax.random.PRNGKey(1)})
        return jax_lp_eval.lp_loss("bce")(out, jnp.asarray(target))

    ref, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    probe.train()
    assert probe.clap_model.training is not freeze
    loss = lp_eval.lp_loss("bce")(probe(torch.from_numpy(wave)),
                                  torch.from_numpy(target))
    loss.backward()
    assert masks.replayed == len(masks.drawn) == 1
    assert abs(float(loss) - float(ref)) <= 1e-6 * abs(float(ref))
    grads = from_jax.linear_probe_state_dict_from_jax(
        {"params": jax.device_get(jgrads),
         "batch_stats": variables["batch_stats"]}, depths=TINY["depths"])
    head = {k: p.grad for k, p in probe.named_parameters()
            if k.startswith("lp_layer.")}
    for key, g in head.items():
        assert rel(g.numpy(), grads[key].numpy()) <= REL, key
    trunk = [(k, p) for k, p in probe.named_parameters()
             if k.startswith("clap_model.")]
    if freeze:
        assert all(p.grad is None for _, p in trunk)
        assert all(float(np.abs(grads[k].numpy()).max()) == 0
                   for k, _ in trunk)
    else:
        # tscam_conv is off the embedding's path: no grad in either
        own = np.concatenate([p.grad.numpy().ravel() for k, p in trunk
                              if p.grad is not None])
        ref_g = np.concatenate([grads[k].numpy().ravel() for k, p in trunk
                                if p.grad is not None])
        assert rel(own, ref_g) <= REL


@pytest.mark.parametrize("name", ["bce", "ce", "mse"])
def test_lp_losses_match_jax(name, rng):
    pred = (3 * rng.randn(8, 6)).astype(np.float32)
    target = np.eye(6, dtype=np.float32)[rng.randint(0, 6, 8)]
    if name == "bce":
        target = np.maximum(target, (rng.rand(8, 6) > 0.7)).astype(
            np.float32)
    ref = float(jax_lp_eval.lp_loss(name)(jnp.asarray(pred),
                                          jnp.asarray(target)))
    got = float(lp_eval.lp_loss(name)(torch.from_numpy(pred),
                                      torch.from_numpy(target)))
    assert abs(got - ref) <= 1e-6 * abs(ref)
    with pytest.raises(ValueError):
        lp_eval.lp_loss("hinge")


def test_lp_metrics_match_jax(rng):
    pred = rng.randn(40, 9)
    pred[:5, 0] = pred[5:10, 0] = 0.25  # ties
    target = (rng.rand(40, 9) > 0.6).astype(np.float32)
    target[0, :] = target[:, 3] = 1
    target[:, 4] = 0  # classes without negatives (3) or positives (4):
    # AUC nan in both
    got = lp_eval.LPMetrics().evaluate_metrics(pred, target)
    ref = jax_lp_eval.LPMetrics().evaluate_metrics(pred, target)
    assert sorted(got) == ["acc", "map", "mauc"]
    for key in ("map", "acc"):
        assert got[key] == pytest.approx(ref[key], abs=1e-12)
    assert np.isnan(got["mauc"]) and np.isnan(ref["mauc"])
    keep = np.ones(9, bool)
    keep[[3, 4]] = False
    for fn in ("get_map", "get_acc", "get_mauc"):
        assert getattr(lp_eval, fn)(pred[:, keep], target[:, keep]) == \
            pytest.approx(getattr(jax_lp_eval, fn)(pred[:, keep],
                                                   target[:, keep]),
                          abs=1e-12)
    with pytest.raises(ValueError):
        lp_eval.LPMetrics(["f1"])


def test_retrieval_metrics_match_jax(rng):
    a = rng.randn(24, 8)
    t = a + 0.8 * rng.randn(24, 8)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    got = retrieval.retrieval_metrics(a.astype(np.float32),
                                      t.astype(np.float32))
    ref = jax_retrieval.retrieval_metrics(a.astype(np.float32),
                                          t.astype(np.float32))
    assert sorted(got) == sorted(ref) and len(got) == 13
    for key in ref:
        assert got[key] == pytest.approx(ref[key], abs=1e-12), key


def test_zero_shot_matches_jax(rng):
    """Prompt-ensemble classifier, top-k counts and a whole run over
    deterministic embedding callables (fixed random projections)."""
    words = rng.randn(50, 16)
    proj = rng.randn(8, 16)

    def embed_text(texts):
        return np.stack([words[sum(map(ord, t)) % 50] for t in texts])

    templates = (lambda c: f"This is a sound of {c}.",
                 lambda c: f"a recording of {c}")
    classes = [f"class {k}" for k in range(6)]
    ref_w = jax_zero_shot.zero_shot_classifier(
        lambda t: jnp.asarray(embed_text(t)), classes, templates)
    got_w = zero_shot.zero_shot_classifier(
        lambda t: torch.from_numpy(embed_text(t)), classes, templates)
    assert got_w.shape == (16, 6)
    assert rel(got_w.numpy(), ref_w) <= 1e-6
    logits = rng.randn(10, 6)
    target = rng.randint(0, 6, 10)
    assert zero_shot.topk_accuracy(logits, target, (1, 3)) == \
        jax_zero_shot.topk_accuracy(logits, target, (1, 3))
    batches = [(rng.randn(5, 8), rng.randint(0, 6, 5)) for _ in range(3)]
    ref = jax_zero_shot.zero_shot_run(
        lambda x: jnp.asarray(x @ proj), ref_w, batches)
    got = zero_shot.zero_shot_run(
        lambda x: torch.from_numpy(x @ proj), got_w, batches)
    assert got == ref and set(got) == {"zeroshot-top1", "zeroshot-top5"}


def _write_pack(path, variables):
    """An npz CLAP pack (scripts/convert_checkpoint.py's layout:
    '/'-joined paths) holding ``audio``."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk({"audio": variables}, "")
    np.savez(path, **flat)


def test_linear_probe_cli_one_step(tmp_path, capsys):
    """``python -m lass_torch.linear_probe`` in process: HTSAT-tiny trunk
    from an ``--init_npz`` pack, MLP head, B=2 x 0.5 s WAV shards with 3
    classes, one step, eval on the same shards; the checkpoint holds the
    pack's trunk unchanged and a trained head."""
    shards = make_synth_shards(str(tmp_path / "shards"), num_shards=1,
                               per_shard=4, seconds=0.5, num_classes=3,
                               tags_per_clip=1)
    classes = str(tmp_path / "shards" / "classes.json")
    jenc = JaxAudioEncoder(htsat_cfg=jax_htsat.htsat_tiny_config())
    abstract = jax.eval_shape(jenc.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 24000)))
    variables = random_tree(jax.device_get(abstract),
                            np.random.RandomState(2))
    pack = str(tmp_path / "clap.npz")
    _write_pack(pack, variables)
    argv = ["--workspace", str(tmp_path / "ws"), "--train_shards", shards,
            "--val_shards", shards, "--class_index", classes,
            "--amodel", "HTSAT-tiny", "--mlp", "--init_npz", pack,
            "--batch_size", "2", "--clip_seconds", "0.5", "--max_steps", "1",
            "--num_workers", "1", "--device", "cpu"]
    cli.main(argv)
    out = capsys.readouterr().out
    assert "finished at step 1" in out and "final lp metrics" in out
    sub = os.path.join("linear_probe", "linear_probe,devices=1")
    with open(tmp_path / "ws" / "tf_logs" / sub / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows[0]["step"] == 1 and np.isfinite(rows[0]["lp_loss"])
    args = cli.parser().parse_args(argv)
    with open(classes) as f:
        task = cli.build_task(args, len(json.load(f)), "cpu")
    fresh = {k: v.clone() for k, v in task.probe.state_dict().items()}
    assert restore_file(str(tmp_path / "ws" / "checkpoints" / sub /
                            "1.ckpt"), task) == 1
    expect = from_jax.clap_audio_state_dict_from_jax(
        variables, jax_htsat.htsat_tiny_config().depths)
    restored = task.probe.state_dict()
    for key, v in expect.items():
        torch.testing.assert_close(restored[f"clap_model.{key}"], v,
                                   rtol=0, atol=0)
    assert not torch.equal(restored["lp_layer.0.weight"],
                           fresh["lp_layer.0.weight"])
