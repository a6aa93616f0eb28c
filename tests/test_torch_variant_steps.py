"""One train step of the port's variant tasks against lass_tpu's, on the
CPU: ``MultiSTFTAudioSepTask`` and ``NegQueryAudioSepTask`` on the
single-window (512,) MultiSTFTResUNet30 at full width, B=2 x 0.32 s,
float32, from the same weights (the port's, converted; no flax init) and
batch, the JAX grads read back from its AMSGrad first moment.

The loss and the BN running statistics hold tests/test_torch_train_step.py's
1e-4 (measured <= 6e-7 and 3e-6). Its grad bounds do not hold at this
depth: with batch statistics in train mode the full-width net's grads at
random init are chaotic (JAX's own grads move by 1.5e-4 to 3e-3 when its
input moves by 1e-7 relative; in eval mode by 1e-5), the first AMSGrad
update is lr * 3.16 * sign(g), so noise-level grads flip their updates,
and the port and JAX sum in other orders. Measured port vs JAX: grad norm
2.4e-4 / 3.5e-5 (multistft / negquery), the grads as one vector 1.4e-3 /
1.8e-2, the worst tensor holding >= 1e-3 of the grads' norm 2.6e-2 /
3.3e-2, the updated parameters 1.6e-3 / 3.6e-3 and their updates 6.5e-2 /
1.3e-1. Bounds: GRAD_NORM_REL, GRADS_REL, TENSOR_REL, STATE_REL and
DELTA_REL below, each about 3x the worse measurement; a wrong grad moves
them by O(1). The fusion moves, and a checkpoint round trip restores the
task bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from lass_tpu.models.resunet_multistft import MultiSTFTResUNet30 as JaxMulti
from lass_tpu.tasks.audiosep import TrainState as JaxTrainState
from lass_tpu.tasks.audiosep_variants import (
    MultiSTFTAudioSepTask as JaxMultiTask)
from lass_tpu.tasks.audiosep_variants import (
    NegQueryAudioSepTask as JaxNegTask)
from lass_tpu.train.optim import build_optimizer as jax_build_optimizer
from lass_torch.convert.from_jax import (
    multistft_state_dict_from_jax, neg_query_fusion_state_dict_from_jax)
from lass_torch.tasks.audiosep_variants import (
    MultiSTFTAudioSepTask, NegQueryAudioSepTask, NegQueryFusion)
from lass_torch.train.checkpoint import CheckpointManager, restore_file
from lass_torch.train.optim import build_optimizer
from variant_helpers import (
    BATCH, REL, jax_variables, rel_err, stft_bank, port_model)
from torch_threads import torch_threads_per_worker  # noqa: F401

STEP_SAMPLES = 5120
GRAD_NORM_REL, GRADS_REL, TENSOR_REL = 1e-3, 5e-2, 1e-1
STATE_REL, DELTA_REL = 1e-2, 3e-1
OPTIM = ("AdamW", 1e-3, "cosine_warm_up", 1, 100)  # full LR from step 0


def _step_batch(seed):
    bank, cond = stft_bank((512,), STEP_SAMPLES, seed)
    rng = np.random.RandomState(seed + 100)
    target = (0.1 * rng.randn(BATCH, 1, STEP_SAMPLES)).astype(np.float32)
    neg = rng.randn(BATCH, 512).astype(np.float32)
    return bank, target, cond, neg


def _jax_batch(bank, target):
    return {"stfts": {"mixture": {512: tuple(jnp.asarray(a)
                                             for a in bank[512])}},
            "target_waveform": jnp.asarray(target)}


def _torch_batch(bank, target):
    return {"stfts": {"mixture": {512: tuple(torch.from_numpy(a)
                                             for a in bank[512])}},
            "target_waveform": torch.from_numpy(target)}


@pytest.fixture(scope="module", params=["multistft", "negquery"])
def variant_step(request):
    """One train step of each package from the same weights and batch:
    the JAX grads (from its AMSGrad first moment), metrics and state after
    it; the port's metrics, grads, state after it and parameters before."""
    variant = request.param
    model = port_model((512,))
    modules = {"model": model}
    torch.manual_seed(7)
    if variant == "negquery":
        modules["neg_query_fusion"] = NegQueryFusion()
    params = [p for m in modules.values() for p in m.parameters()]
    optimizer, scheduler = build_optimizer(params, *OPTIM)
    task = (NegQueryAudioSepTask(model, modules["neg_query_fusion"],
                                 optimizer, scheduler)
            if variant == "negquery" else
            MultiSTFTAudioSepTask(model, optimizer, scheduler))

    variables = jax_variables(model.state_dict())
    jparams = dict(variables["params"])
    if variant == "negquery":
        jparams["neg_query_fusion"] = jax_variables(
            modules["neg_query_fusion"].state_dict())["params"]
    jtask = (JaxNegTask if variant == "negquery" else JaxMultiTask)(
        JaxMulti(win_lengths=(512,)), jax_build_optimizer(*OPTIM))
    state0 = JaxTrainState(step=jnp.zeros([], jnp.int32), params=jparams,
                           batch_stats=variables["batch_stats"],
                           opt_state=jtask.optimizer.init(jparams))

    bank, target, pos, neg = _step_batch(seed=8)
    if variant == "negquery":
        jcond, cond = ((jnp.asarray(pos), jnp.asarray(neg)),
                       (torch.from_numpy(pos), torch.from_numpy(neg)))
    else:
        jcond, cond = jnp.asarray(pos), torch.from_numpy(pos)
    _, unravel = ravel_pytree(state0.params)
    step_fn = jax.jit(jtask.train_step)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    def flat(params, stats):
        out = {f"model.{k}": v for k, v in multistft_state_dict_from_jax(
            {"params": params, "batch_stats": stats}).items()}
        if "neg_query_fusion" in params:
            out.update({f"neg_query_fusion.{k}": v for k, v in
                        neg_query_fusion_state_dict_from_jax(
                            params["neg_query_fusion"]).items()})
        return out

    def jax_step(stft):
        state, metrics = step_fn(state0, _jax_batch({512: stft}, target),
                                 jcond)
        mu = np.asarray(state.opt_state[0].mu, np.float64)
        grads = unravel(jnp.asarray(mu / np.float32(0.1), jnp.float32))
        stats = np_tree(state.batch_stats)
        return ({k: float(v) for k, v in metrics.items()},
                flat(np_tree(grads), stats),
                flat(np_tree(state.params), stats))

    jmetrics, jgrads, jstate = jax_step(bank[512])

    names = {f"{k}.{n}": p for k, m in modules.items()
             for n, p in m.named_parameters()}
    before = {k: v.detach().clone() for k, v in names.items()}
    metrics = task.train_step(_torch_batch(bank, target), cond)
    return dict(
        variant=variant, task=task, modules=modules, jmetrics=jmetrics,
        metrics={k: float(v) for k, v in metrics.items()}, jgrads=jgrads,
        jstate=jstate,
        grads={k: p.grad.clone() for k, p in names.items()},
        state={f"{k}.{n}": v.clone() for k, m in modules.items()
               for n, v in m.state_dict().items()},
        before=before, batch=(bank, target, cond))


def test_step_loss_and_grad_norm_match_jax(variant_step):
    s = variant_step
    for key, bound in (("train_loss", REL), ("grad_norm", GRAD_NORM_REL)):
        ref = s["jmetrics"][key]
        assert abs(s["metrics"][key] - ref) <= bound * abs(ref), key


def test_step_grads_match_jax(variant_step):
    """All grads as one vector at GRADS_REL; each tensor that holds at
    least 1e-3 of the grads' norm at TENSOR_REL (module docstring)."""
    s = variant_step
    names = sorted(s["grads"])

    def vec(tree):
        return np.concatenate([np.asarray(tree[n]).ravel() for n in names])

    ref = vec(s["jgrads"])
    assert rel_err(vec(s["grads"]), ref) <= GRADS_REL
    for name in names:
        ref_t = s["jgrads"][name].numpy()
        if np.linalg.norm(ref_t) == 0:  # the dead decoder beta2 rows
            assert not s["grads"][name].any(), name
        elif np.linalg.norm(ref_t) >= 1e-3 * np.linalg.norm(ref):
            assert rel_err(s["grads"][name].numpy(), ref_t) <= TENSOR_REL, name


def test_step_updated_state_matches_jax(variant_step):
    """The parameters after the step as one vector at STATE_REL and their
    updates at DELTA_REL; the BatchNorm running statistics (the train-mode
    forward's) per tensor at REL."""
    s = variant_step
    for name, v in s["state"].items():
        if name.endswith("num_batches_tracked"):
            assert int(v) == 1
        elif "running" in name:
            assert rel_err(v.numpy(), s["jstate"][name].numpy()) <= REL, name
    names = sorted(s["before"])
    new = np.concatenate([s["state"][n].numpy().ravel() for n in names])
    ref = np.concatenate([s["jstate"][n].numpy().ravel() for n in names])
    old = np.concatenate([s["before"][n].numpy().ravel() for n in names])
    assert rel_err(new, ref) <= STATE_REL
    assert rel_err(new - old, ref - old) <= DELTA_REL
    assert np.abs(new - old).max() > 1e-4  # the step moved the weights


def test_step_checkpoint_round_trip(variant_step, tmp_path):
    """The variant's snapshot restores the model and the fusion (negquery:
    it moved in the step) bit for bit, and the step; the val step gives
    the same loss after the restore."""
    s = variant_step
    task = s["task"]
    if s["variant"] == "negquery":
        w = s["state"]["neg_query_fusion.fusion.weight"]
        assert not torch.equal(w, s["before"]["neg_query_fusion.fusion.weight"])
    bank, target, cond = s["batch"]
    batch = _torch_batch(bank, target)
    val = float(task.val_step(batch, cond))
    ckpt = CheckpointManager(str(tmp_path), save_step_frequency=1)
    ckpt.save_async(1, task)
    ckpt.wait()
    with torch.no_grad():
        for p in task.parameters():
            p.zero_()
    task.step = 0
    assert restore_file(ckpt.path(1), task) == 1
    for name, module in task.modules().items():
        for k, v in module.state_dict().items():
            assert torch.equal(v, s["state"][f"{name}.{k}"]), (name, k)
    assert float(task.val_step(batch, cond)) == val
