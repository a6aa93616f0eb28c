"""lass_torch's data parallelism against lass_tpu on the global batch, on
the CPU: two ranks in a gloo group, started from here
(``lass_torch.parallel.host.run_local_ranks``), each a fresh process that
imports no JAX (tests/torch_parallel_ranks.py); the JAX references are
computed in this process.

- The host split: ``shard_indices_for_host`` and ``DataModule(
  process_index, process_count)``'s batches equal lass_tpu's.
- The train step of tests/test_torch_train_step.py's small separator,
  one row per rank (so per-rank BatchNorm statistics would differ), equals
  the JAX ``AudioSepTask`` step on the global batch of 2 within 1e-4 (that
  file's bound): the loss, the grads and the updated parameters, each as
  one vector, and every BatchNorm running statistic.
- The mix of each rank's rows, fed JAX's draws of the global batch, equals
  the JAX mixer on the global batch within 1e-6 (a rank-local roll would
  pair rank 0's last clip with its own first clip).
- A train-mode BatchNorm over the last axis (momentum 0.1) over 2 ranks
  equals the one-process BatchNorm of the global batch; the ranks'
  train-mode draws are the global draws' rows.
- One contrastive step of tests/test_torch_clap_pretrain.py's TINY HTSAT
  and 2-layer RoBERTa, two rows per rank, equals the JAX step on the
  global batch of 4 within that file's bounds (loss 1e-5; grads, updated
  parameters and BN statistics 1e-4).
- The DCASE evaluator with ``data_parallel`` over 2 ranks gives the
  one-rank metrics, and a rank that fails stops the group.
- Tensor parallelism on a (1 x 2) grid (``make_grid``, ``shard_model``
  with thresholds that shard every 8-wide conv, the transposed conv and
  the FiLM of the small separator): its step on the global batch of 2
  equals the JAX step within 1e-4 (the loss, the grads, the updated
  parameters and the BatchNorm statistics, each as one vector); the
  replicated parameters stay bitwise equal across the model group; each
  AMSGrad moment has its parameter's local shape and the ranks' moment
  bytes are below the whole model's; the whole checkpoint state, resumed
  in one process, takes the grid's second step within 1e-4.
- The trainer at 2 ranks: its step-2 checkpoint resumed by the 2 ranks
  repeats steps 3 and 4 to the bit; the full-width ResUNet30 trainer on
  a (1 x 2) grid shards what ``shard_layout`` picks, and its step-1
  checkpoint (written from the grid) resumes in one process, whose step
  2 on the same global batch repeats the grid's within 1e-5, and serves
  through ``load_ss_model``.
- Hybrid conditioning (use_text_ratio 0.5, coins audio then text) on a
  (1 x 2) grid with the small separator sharded: its two steps' losses
  equal a one-process trainer's on the same global batch within 1e-5.
"""
import concurrent.futures
import json

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import numpy as np
import optax
import pytest
import torch

from lass_tpu.data.datafiles import AudioTextDataset as JaxDataset
from lass_tpu.data.datamodule import DataModule as JaxDataModule
from lass_tpu.data.mixer import SegmentMixer as JaxMixer
from lass_tpu.models.clap.model import CLAPAudioEncoder as JaxAudioEncoder
from lass_tpu.models.clap.model import CLAPTextEncoder as JaxTextEncoder
from lass_tpu.models.clap.roberta import RobertaConfig as JaxRobertaConfig
from lass_tpu.parallel.host import (
    shard_indices_for_host as jax_shard_indices)
from lass_tpu.tasks import clap_pretrain as jax_clap
from lass_tpu.tasks.audiosep import AudioSepTask as JaxTask
from lass_tpu.tasks.audiosep import TrainState as JaxTrainState
from lass_tpu.train.optim import build_optimizer as jax_build_optimizer
from lass_tpu.train.optim import cosine_warm_up as jax_cosine
from lass_torch.config import load_config
from lass_torch.convert import from_jax
from lass_torch.convert.checkpoint_io import load_ss_model
from lass_torch.data.datafiles import AudioTextDataset
from lass_torch.data.mixer import SegmentMixer
from lass_torch.data.datamodule import DataModule
from lass_torch.data.synth import (
    make_synth_corpus, make_synth_eval_set, write_train_config)
from lass_torch.models.clap.roberta import RobertaConfig
from lass_torch.models.resunet import ResUNet30
from lass_torch.nn.layers import BatchNorm
from lass_torch.parallel.host import run_local_ranks, shard_indices_for_host
from lass_torch.parallel.mesh import shard_layout
from lass_torch.tasks.audiosep import AudioSepTask
from lass_torch.train.loop import Trainer
from lass_torch.train.optim import build_optimizer
from test_torch_clap_pretrain import (
    LR, ROBERTA, WD, draw, grad_capture, same_stripes)
from test_torch_htsat import configs, jax_variables
from test_torch_train_step import (
    JaxSmallSep, TorchSmallSep, _jax_variables, _state_dict)
from torch_parallel_ranks import (
    OPTIM, TP_SMALL, SmallSep, evaluate, fail_on_rank_one, hybrid_encoder,
    run_checks, small_encoder)
from torch_threads import torch_threads_per_worker  # noqa: F401

REL = 1e-4
LOSS_REL = 1e-5
WORLD = 2
TIMEOUT_S = 120.0
MIX_SEED = 11  # the JAX mixer's key


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def vector(tree, keys):
    return np.concatenate([np.asarray(tree[k], np.float64).ravel()
                           for k in keys])


# ----------------------------------------------------------- inputs, JAX

def separator_inputs(rng):
    """SmallSep's weights (random BN affines) and a global batch of 2
    premixed 0.32 s clips."""
    torch.manual_seed(0)
    model = SmallSep()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.add_(0.1 * torch.randn(m.weight.shape))
                m.bias.add_(0.1 * torch.randn(m.bias.shape))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    seg = (0.1 * rng.randn(WORLD, 1, 5120)).astype(np.float32)
    batch = {"mixture": seg + (0.1 * rng.randn(WORLD, 1, 5120)).astype(
                 np.float32),
             "segment": seg,
             "condition": rng.randn(WORLD, 16).astype(np.float32)}
    return sd, batch


def separator_reference(sd, batch):
    """The JAX step on ``separator_inputs`` (its grads read back from its
    AMSGrad first moment, as tests/test_torch_train_step.py does)."""
    jtask = JaxTask(JaxSmallSep(), JaxMixer(), jax_build_optimizer(*OPTIM))
    params, stats = _jax_variables(sd)
    state = JaxTrainState(step=jnp.zeros([], jnp.int32), params=params,
                          batch_stats=stats,
                          opt_state=jtask.optimizer.init(params))
    state, metrics = jax.jit(jtask.train_step_premixed)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    _, unravel = ravel_pytree(state.params)
    grads = unravel(jnp.asarray(np.asarray(state.opt_state[0].mu)
                                / np.float32(0.1)))
    return {
        "loss": float(metrics["train_loss"]),
        "grads": _state_dict(grads, state.batch_stats),
        "state": _state_dict(state.params, state.batch_stats)}


def mix_inputs(rng, max_mix=3):
    """6 clips (3 per rank, one loud: the declip branch) and JAX's draws
    of the global batch."""
    w = (0.3 * rng.randn(6, 1, 700)).astype(np.float32)
    w[2] *= 20
    key = jax.random.PRNGKey(MIX_SEED)
    k_mix, k_db, k_final = jax.random.split(key, 3)
    draws = (np.array(jax.random.randint(k_mix, (6,), 2, max_mix + 1)),
             np.array(jax.random.randint(k_db, (6, max_mix - 1), -10, 11),
                      np.float32),
             np.array(jax.random.randint(k_final, (6,), -10, 11),
                      np.float32))
    return w, draws


def mix_reference(w, max_mix=3):
    """JAX's mixer's output on ``mix_inputs``' clips, global and each
    rank's rows alone."""
    key = jax.random.PRNGKey(MIX_SEED)
    jmixer = JaxMixer(max_mix, -10, 10)
    ref = [np.asarray(x) for x in jmixer(jnp.asarray(w), key)]
    # each rank mixing its own rows alone: another function
    local = np.concatenate([np.asarray(jmixer(jnp.asarray(w[r:r + 3]),
                                              key)[0]) for r in (0, 3)])
    return ref, local


def clap_inputs():
    """tests/test_torch_clap_pretrain.py's step, its draws included: TINY
    HTSAT + 2-layer RoBERTa, B=4 x 1 s at 48 kHz, captions of 5-9 tokens
    padded to 9, the CLI's optimizer chain, fixed stripes. Returns the
    ranks' inputs and a function that computes the JAX step on the global
    batch of 4. (Steps at random init whose InfoNCE grads
    cancel across rows are ill-conditioned: on other draws the port's
    one-process step differs from lass_tpu's by up to 1.6e-4, lass_tpu's
    BatchNorm taking one-pass float32 statistics; ROADMAP.md queue C.)"""
    rng = np.random.RandomState(3)
    cfg, jcfg = configs()
    b = 2 * WORLD
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
              "logit_scale_a": np.float32(np.log(1 / 0.07)),
              "logit_scale_t": np.float32(np.log(1 / 0.07))}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    schedule = jax_cosine(1, 100)
    chain = optax.chain(
        grad_capture(), optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-8),
        optax.add_decayed_weights(WD),
        optax.scale_by_learning_rate(lambda s: LR * schedule(s)))
    jt = jax_clap.CLAPPretrainTask(jaudio, jtext, chain)
    state = jax_clap.CLAPTrainState(
        step=jnp.zeros([], jnp.int32), params=params,
        batch_stats=audio_vars["batch_stats"], opt_state=chain.init(params))
    batch = {"waveform": wave, "input_ids": ids.astype(np.int64),
             "attention_mask": mask.astype(np.int64)}

    def port_layout(tree, stats):
        return from_jax.clap_pretrain_state_dict_from_jax(
            jax.device_get(tree), jax.device_get(stats),
            ROBERTA["num_hidden_layers"], depths=cfg.depths)

    def reference():
        with pytest.MonkeyPatch.context() as mp:
            same_stripes(mp, stripes)
            new, metrics = jax.jit(jt.train_step)(
                state, {k: jnp.asarray(v) for k, v in batch.items()})
        return {"loss": float(metrics["contrastive_loss"]),
                "new": port_layout(new.params, new.batch_stats),
                "grads": port_layout(new.opt_state[0], new.batch_stats)}

    inputs = {"clap_htsat": cfg, "clap_roberta": RobertaConfig(**ROBERTA),
              "clap_optim": (LR, WD), "clap_batch": batch,
              "clap_stripes": {w: tuple(np.asarray(a, np.int64) for a in s)
                               for w, s in stripes.items()},
              "clap_state": port_layout(params, audio_vars["batch_stats"])}
    return inputs, reference


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every check's inputs, the JAX references, and the 2-rank results
    (the ranks run while this process computes the references)."""
    rng = np.random.RandomState(3)
    sep_state, sep_batch = separator_inputs(rng)
    w, draws = mix_inputs(rng)
    clap_in, clap_reference = clap_inputs()
    bn = BatchNorm(5, momentum=0.1, dim=-1)
    with torch.no_grad():
        bn.weight.normal_(1.0, 0.2)
        bn.bias.normal_(0.0, 0.2)
    root = tmp_path_factory.mktemp("parallel")
    eval_csv = make_synth_eval_set(str(root / "eval"), num_rows=5,
                                   seconds=1.0, num_captions=3)
    datafile = make_synth_corpus(str(root / "corpus"), num_clips=8,
                                 seconds_min=0.6, seconds_max=1.0,
                                 alt_rate_fraction=0.3, seed=3)
    # one row a rank (checkpoints 1, 2, 4; the grid's at step 1 only); the
    # one-process resume takes the global batch of 2 and saves nothing
    trainer_configs = [write_train_config(
        str(root / f"config_{b}_{every}.yaml"), datafile, batch_size=b,
        segment_seconds=0.16, num_workers=1, save_step_frequency=every,
        compute_dtype="float32") for b, every in ((1, 2), (1, 1000),
                                                   (WORLD, 1000))]
    # hybrid conditioning, random_seed 1: coins audio, text (one row a
    # rank, and the one-process run's global batch)
    hybrid_configs = [write_train_config(
        str(root / f"hybrid_{b}.yaml"), datafile, batch_size=b,
        segment_seconds=0.16, num_workers=1, save_step_frequency=1000,
        compute_dtype="float32", use_text_ratio=0.5, random_seed=1)
        for b in (1, WORLD)]
    inp = {"sep_state": sep_state, "sep_batch": sep_batch,
           "mix_waveforms": w, "mix_draws": draws, "max_mix": 3,
           "bn_x": (3.0 + 2.0 * rng.randn(4, 3, 6, 5)).astype(np.float32),
           "bn_gy": rng.randn(4, 3, 6, 5).astype(np.float32),
           "bn_state": {k: v.clone() for k, v in bn.state_dict().items()},
           "draw_rows": 6, "draw_seed": 17,
           "eval_csv": eval_csv, "eval_dir": str(root / "eval"),
           "trainer_config": trainer_configs[0],
           "grid_config": trainer_configs[1],
           "hybrid_config": hybrid_configs[0],
           "trainer_root": str(root / "trainer"), **clap_in}
    # the JAX step reads a copy: handing the ranks their inputs moves the
    # tensors' storage to shared memory under any view of it
    sep_copy = {k: v.clone() for k, v in sep_state.items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        group = pool.submit(run_local_ranks, run_checks, WORLD, (inp,),
                            timeout_s=TIMEOUT_S)
        sep_ref = separator_reference(sep_copy, sep_batch)
        mix_ref, mix_local = mix_reference(w)
        clap_ref = clap_reference()
        out = group.result()
    return {"inp": inp, "out": out, "sep": sep_ref, "clap": clap_ref,
            "mix": (mix_ref, mix_local), "root": root,
            "global_config": trainer_configs[2],
            "hybrid_global_config": hybrid_configs[1]}


# ----------------------------------------------------------------- tests

def test_host_split_matches_jax(tmp_path):
    idx = np.random.RandomState(0).permutation(11)
    for count in (1, 2, 3, 4):
        for i in range(count):
            np.testing.assert_array_equal(
                shard_indices_for_host(idx, i, count),
                jax_shard_indices(idx, i, count))
    data = make_synth_corpus(str(tmp_path / "corpus"), num_clips=9,
                             seconds_min=0.5, seconds_max=0.7)
    for i in range(2):
        got = DataModule(AudioTextDataset([data], 16000, 0.5), batch_size=2,
                         num_workers=1, seed=5, process_index=i,
                         process_count=2)
        ref = JaxDataModule(JaxDataset([data], 16000, 0.5), batch_size=2,
                            num_workers=1, seed=5, process_index=i,
                            process_count=2)
        with got.train_dataloader() as loader:
            mine = [next(loader)["audio_text"] for _ in range(3)]
        theirs = ref._iter_batches()
        for a in mine:  # 2 batches a share of 4 clips: into epoch 1
            b = next(theirs)["audio_text"]
            assert a["text"] == b["text"]
            np.testing.assert_array_equal(a["waveform"], b["waveform"])
        theirs.close()


def test_rank_separator_is_the_train_step_tests_separator(ranks):
    ours, theirs = SmallSep(), TorchSmallSep()
    theirs.load_state_dict(ranks["inp"]["sep_state"])
    ours.load_state_dict(theirs.state_dict())
    batch = {k: torch.from_numpy(v) for k, v in
             ranks["inp"]["sep_batch"].items()}
    with torch.no_grad():
        torch.testing.assert_close(ours.eval()(batch)["waveform"],
                                   theirs.eval()(batch)["waveform"],
                                   rtol=0, atol=0)


def test_two_rank_train_step_is_the_jax_global_step(ranks):
    ref = ranks["sep"]
    out = [r["train_step"] for r in ranks["out"]]
    for r in out:
        assert abs(r["loss"] - ref["loss"]) <= REL * abs(ref["loss"])
    names = sorted(out[0]["grads"])
    for r in out:  # DDP's all-reduce: one set of grads on every rank
        assert rel(vector(r["grads"], names),
                   vector(ref["grads"], names)) <= REL
    # the updated parameters as one vector: AdamW's first update is about
    # lr * sign(g), so a grad at float noise (|g| ~ 1e-8) may flip its entry
    assert rel(vector(out[0]["state"], names),
               vector(ref["state"], names)) <= REL
    for name, v in out[0]["state"].items():
        np.testing.assert_array_equal(v, out[1]["state"][name])
        if name.endswith("num_batches_tracked"):
            assert int(v) == 1
        elif "running_" in name:
            assert rel(v, ref["state"][name]) <= REL, name


def test_two_rank_mix_is_the_jax_global_mix(ranks):
    (ref_mix, ref_seg), local = ranks["mix"]
    got_mix = np.concatenate([r["mix"]["mixtures"] for r in ranks["out"]])
    got_seg = np.concatenate([r["mix"]["segments"] for r in ranks["out"]])
    np.testing.assert_allclose(got_mix, ref_mix, atol=1e-6)
    np.testing.assert_allclose(got_seg, ref_seg, atol=1e-6)
    # the ranks' own rows mixed alone are another function
    assert np.abs(local - ref_mix).max() > 1e-2


def test_two_rank_batch_norm_is_the_global_batch_norm(ranks):
    inp = ranks["inp"]
    bn = BatchNorm(5, momentum=0.1, dim=-1)
    bn.load_state_dict(inp["bn_state"])
    x = torch.from_numpy(inp["bn_x"]).requires_grad_()
    y = bn.train()(x)
    (y * torch.from_numpy(inp["bn_gy"])).sum().backward()
    out = [r["batch_norm"] for r in ranks["out"]]
    np.testing.assert_allclose(np.concatenate([r["y"] for r in out]),
                               y.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in out]),
                               x.grad.numpy(), rtol=1e-5, atol=1e-5)
    for key, param in (("dweight", bn.weight), ("dbias", bn.bias)):
        np.testing.assert_allclose(out[0][key] + out[1][key],
                                   param.grad.numpy(), rtol=1e-5, atol=1e-5)
    for key in ("running_mean", "running_var"):
        np.testing.assert_array_equal(out[0][key], out[1][key])
        np.testing.assert_allclose(out[0][key],
                                   getattr(bn, key).numpy(), rtol=1e-5)


def test_rank_draws_are_rows_of_the_global_draws(ranks):
    from lass_torch.models.clap import htsat
    from lass_torch.nn.layers import dropout

    inp = ranks["inp"]
    gen = torch.Generator().manual_seed(inp["draw_seed"])
    starts, lengths = htsat.draw_stripes(inp["draw_rows"], 101, 64, 2, gen)
    gen = torch.Generator().manual_seed(inp["draw_seed"])
    kept = dropout(torch.ones(inp["draw_rows"], 3, 7), 0.5, gen)
    out = [r["draws"] for r in ranks["out"]]
    assert [r["row_span"] for r in out] == [(6, 0), (6, 3)]
    for key, ref in (("starts", starts), ("lengths", lengths),
                     ("dropout", kept)):
        np.testing.assert_array_equal(
            np.concatenate([r[key] for r in out]), ref.numpy())


def test_two_rank_clap_step_is_the_jax_global_step(ranks):
    ref = ranks["clap"]
    out = [r["clap_step"] for r in ranks["out"]]
    names = sorted(out[0]["grads"])
    for r in out:
        assert abs(r["loss"] - ref["loss"]) <= LOSS_REL * abs(ref["loss"])
        assert rel(vector(r["grads"], names),
                   vector(ref["grads"], names)) <= REL
        assert rel(vector(r["state"], names),
                   vector(ref["new"], names)) <= REL
        running = sorted(k for k in ref["new"] if "running_" in k)
        assert running and rel(vector(r["state"], running),
                               vector(ref["new"], running)) <= REL
    for name in out[0]["state"]:
        np.testing.assert_array_equal(out[0]["state"][name],
                                      out[1]["state"][name])


def test_two_rank_evaluator_gives_the_one_rank_metrics(ranks):
    inp = ranks["inp"]
    one = evaluate(inp["eval_csv"], inp["eval_dir"], inp["sep_state"], False)
    for r in ranks["out"]:
        assert r["evaluate"] == one
    assert np.isfinite(one).all()


def test_a_failing_rank_stops_the_group():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_local_ranks(fail_on_rank_one, WORLD, timeout_s=TIMEOUT_S)


def test_quantize_with_data_parallel_raises(ranks):
    """As in lass_tpu (dcase.py:210-212): int8 calibration is not wired
    for a sharded evaluator, in the class and in the CLI's ``evaluate``."""
    from lass_torch import dcase_evaluator
    from lass_torch.evaluation.dcase import DCASEEvaluator

    inp = ranks["inp"]
    evaluator = DCASEEvaluator(16000, inp["eval_csv"], inp["eval_dir"],
                               batch_size=2, data_parallel=True)
    with pytest.raises(NotImplementedError):
        evaluator.calibrate(None)
    with pytest.raises(NotImplementedError):
        dcase_evaluator.evaluate(evaluator, "unused.ckpt", quantize=True,
                                 device="cpu")


# ----------------------------------------------------- tensor parallelism

def _running(state):
    return sorted(k for k in state if "running_" in k)


def test_grid_train_step_is_the_jax_global_step(ranks):
    ref = ranks["sep"]
    out = [r["grid_step"] for r in ranks["out"]]
    sharded = set(out[0]["sharded"])
    assert sharded == {n for n, p in SmallSep().named_parameters()
                       if (p.dim() == 4 and p.shape[0] >= TP_SMALL[
                           "min_channels"]) or n == "film.weight"}
    assert "decoder_block1.conv1.weight" in sharded  # the transposed conv
    names = sorted(out[0]["grads"])
    for r in out:
        assert abs(r["loss"] - ref["loss"]) <= REL * abs(ref["loss"])
        assert rel(vector(r["grads"], names),
                   vector(ref["grads"], names)) <= REL
        assert rel(vector(r["state"], names),
                   vector(ref["state"], names)) <= REL
        running = _running(ref["state"])
        assert running and rel(vector(r["state"], running),
                               vector(ref["state"], running)) <= REL
    # the model group's replicated parameters, and every whole parameter
    # and BatchNorm running statistic: bitwise one copy
    assert sorted(out[0]["replicated"]) == sorted(set(names) - sharded)
    for name, v in out[0]["replicated"].items():
        np.testing.assert_array_equal(v, out[1]["replicated"][name])
    assert _running(out[0]["state"])
    for name in out[0]["state"]:
        np.testing.assert_array_equal(out[0]["state"][name],
                                      out[1]["state"][name])


def test_grid_moments_follow_the_local_slices(ranks):
    whole = {n: p for n, p in SmallSep().named_parameters()}
    global_bytes = 3 * sum(p.numel() * 4 for p in whole.values())
    for r in (r["grid_step"] for r in ranks["out"]):
        for name, shapes in r["moments"].items():
            assert shapes == [r["local_shapes"][name]] * 3, name
            if name in r["sharded"]:
                assert r["local_shapes"][name][0] * WORLD == \
                    whole[name].shape[0]
        assert r["moment_bytes"] < global_bytes


def test_grid_checkpoint_resumes_in_one_process(ranks):
    grid = ranks["out"][0]["grid_step"]
    for name in grid["checkpoint"]["state_dict"]:
        torch.testing.assert_close(grid["checkpoint"]["state_dict"][name],
                                   ranks["out"][1]["grid_step"][
                                       "checkpoint"]["state_dict"][name],
                                   rtol=0, atol=0)
    model = SmallSep()
    optimizer, scheduler = build_optimizer(model.parameters(), *OPTIM)
    task = AudioSepTask(model, SegmentMixer(), optimizer, scheduler)
    task.load_checkpoint_state(grid["checkpoint"])
    assert task.step == 1
    for name, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), grid["state"][name])
    batch = {k: torch.from_numpy(v) for k, v in
             ranks["inp"]["sep_batch"].items()}
    metrics = task.train_step_premixed(batch)
    second = grid["second"]
    assert abs(float(metrics["train_loss"]) - second["loss"]) <= \
        REL * abs(second["loss"])
    names = sorted(second["state"])
    assert rel(vector({k: v.numpy() for k, v in model.state_dict().items()},
                      names), vector(second["state"], names)) <= REL


def test_two_rank_resume_repeats_the_uninterrupted_steps(ranks):
    """ROADMAP.md C.1: a checkpoint resumes exactly at several ranks."""
    runs = ranks["out"][0]["trainer"]
    assert sorted(runs["first"]) == [1, 2, 3, 4]
    assert runs["resumed"] == {s: runs["first"][s] for s in (3, 4)}
    assert all(np.isfinite(list(runs["first"].values())))


def test_grid_trainer_checkpoint_resumes_and_serves_in_one_process(
        ranks, tmp_path):
    runs = ranks["out"][0]["trainer"]
    assert runs["grid_sharded"] == shard_layout(ResUNet30())
    assert sorted(runs["grid"]) == [1, 2]
    assert runs["grid_timing"]["prefetch_embed"] > 0
    ckpt = f"{runs['grid_dir']}/1.ckpt"
    one = Trainer(ranks["global_config"], str(tmp_path / "one"),
                  device="cpu", log_every=1, query_encoder=small_encoder(),
                  resume_checkpoint_path=ckpt)
    one.fit(max_steps=2)
    with open(f"{one.tf_logs_dir}/metrics.jsonl") as f:
        got = {r["step"]: r["train_loss"] for r in map(json.loads, f)}
    assert sorted(got) == [2]
    assert abs(got[2] - runs["grid"][2]) <= LOSS_REL * abs(runs["grid"][2])
    sep = load_ss_model(load_config(ranks["global_config"]), ckpt,
                        query_encoder=small_encoder(), device="cpu")
    cond = sep.query_encoder.get_query_embed("text", text=["a tone"])
    mixture = 0.1 * np.random.RandomState(0).randn(1, 1, 4000).astype(
        np.float32)
    out = sep.separate(mixture, cond)
    assert out.shape == (1, 1, 4000) and np.isfinite(out).all()


def test_hybrid_grid_trainer_is_the_one_process_trainer(ranks, tmp_path,
                                                       monkeypatch):
    runs = ranks["out"][0]["trainer"]
    assert set(runs["hybrid_sharded"]) == {
        n for n, p in SmallSep().named_parameters()
        if (p.dim() == 4 and p.shape[0] >= TP_SMALL["min_channels"])
        or n == "film.weight"}
    assert runs["hybrid_audio_calls"] == 1  # the audio coin's step
    monkeypatch.setattr("lass_torch.train.loop.build_model",
                        lambda cfg: SmallSep(cfg.model.condition_size))
    encoder = hybrid_encoder()
    one = Trainer(ranks["hybrid_global_config"], str(tmp_path / "one"),
                  device="cpu", log_every=1, query_encoder=encoder)
    one.fit(max_steps=2)
    assert len(encoder.calls) == 1
    with open(f"{one.tf_logs_dir}/metrics.jsonl") as f:
        got = {r["step"]: r["train_loss"] for r in map(json.loads, f)}
    assert sorted(got) == sorted(runs["hybrid"]) == [1, 2]
    for step, loss in runs["hybrid"].items():
        assert abs(got[step] - loss) <= LOSS_REL * abs(loss), step
