"""The port's train step against lass_tpu's, on the CPU.

(a) Two ``train_step_premixed`` steps of a small separator built twice
from the same blocks (STFT -> bn0 -> FusedFiLM -> one EncoderBlockRes1B
and one DecoderBlockRes1B at 8 channels -> after_conv ->
apply_mask_and_reconstruct), once of lass_tpu's flax modules and once of
the port's, through the real AudioSepTask and optimizer of each package,
from the same weights (the port's init, converted to the JAX layout) and
batches. Loss, grads, updated parameters and BatchNorm running statistics
agree at rel err <= 1e-4 per tensor (the bound the JAX package sets itself
against the torch reference; float32 on two backends, the STFT by FFT on
one side and by a HIGHEST-precision DFT matmul on the other); the grads
as one vector, each grad tensor at 1e-3 (see test_grads_match_jax). The
JAX grads are the ones its step used, read back from its AMSGrad first
moment, so the JAX side compiles the task's step and nothing else.
(b) The mixer on draws from a JAX key, fed to the port's draws-explicit
``mix``, at <= 1e-6 abs, and its invariants.
(c) One train step of the full-width ResUNet30 on the port only (the JAX
full-model grad takes minutes to compile on the CPU).
(d) Training rematerialization: the JAX side of (a) runs its blocks under
lass_tpu's own ``_maybe_remat(..., True)`` (one compile serves both), and
the port's small separator runs twice from the same weights and batches,
its blocks plain and under the port's ``remat_call``: each port run is
held to the JAX one at (a)'s bounds. The full-width ResUNet30's steps under
``remat`` 'wide' and 'all' against 'none' at rel err <= 1e-6 (on the CPU
they are in fact bitwise equal: the recompute repeats the first pass's
kernels on the same inputs, and BatchNorm updates its statistics once);
``LASS_TPU_REMAT`` read as lass_tpu reads it; an eval forward under 'all'
bitwise the 'none' one.
Plus the LR multipliers of the three schedules against the JAX ones.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lass_tpu.data.mixer import SegmentMixer as JaxMixer
from lass_tpu.dsp.stft import STFTConfig as JaxSTFTConfig
from lass_tpu.dsp.stft import wav_to_spectrogram_complex
from lass_tpu.models.film import FusedFiLM as JaxFiLM
from lass_tpu.models.resunet import (
    ResUNet30Base as JaxResUNet30Base, _maybe_remat,
    apply_mask_and_reconstruct as jax_mask_and_reconstruct)
from lass_tpu.nn.blocks import (
    DecoderBlockRes1B as JaxDecoder, EncoderBlockRes1B as JaxEncoder)
from lass_tpu.nn.layers import BatchNorm as JaxBN, conv2d as jax_conv2d
from lass_tpu.tasks.audiosep import AudioSepTask as JaxTask
from lass_tpu.tasks.audiosep import TrainState as JaxTrainState
from lass_tpu.train.optim import build_optimizer as jax_build_optimizer
from lass_tpu.train.optim import get_lr_schedule as jax_schedule
from lass_torch.convert import from_jax
from lass_torch.data.mixer import SegmentMixer
from lass_torch.dsp.stft import STFTConfig, istft, stft
from lass_torch.losses import get_loss_function, l1
from lass_torch.models.film import FusedFiLM
from lass_torch.models.resunet import (
    REMAT_BLOCKS, ResUNet30, apply_mask_and_reconstruct, remat_call,
    remat_mode)
from lass_torch.nn.blocks import DecoderBlockRes1B, EncoderBlockRes1B
from lass_torch.nn.layers import BatchNorm, Conv2d
from lass_torch.tasks.audiosep import AudioSepTask, _decode_wire
from lass_torch.train.optim import build_optimizer, get_lr_schedule
from torch_threads import torch_threads_per_worker  # noqa: F401

REL = 1e-4
COND, CH, SAMPLES, BATCH = 16, 8, 5120, 2  # B=2 x 0.32 s at 16 kHz
SPEC = (
    (("encoder_block1", "conv_block1", "beta1"), CH, True),
    (("encoder_block1", "conv_block1", "beta2"), CH, True),
    (("decoder_block1", "beta1"), CH, True),
    (("decoder_block1", "beta2"), CH, False),
    (("decoder_block1", "conv_block2", "beta1"), 2 * CH, True),
    (("decoder_block1", "conv_block2", "beta2"), CH, True),
)
OPTIM = ("AdamW", 1e-3, "cosine_warm_up", 1, 100)  # full LR from step 0


class JaxSmallSep(fnn.Module):
    remat: bool = False  # both blocks under lass_tpu's _maybe_remat

    @fnn.compact
    def __call__(self, input_dict, train: bool = False):
        mixture, condition = input_dict["mixture"], input_dict["condition"]
        cfg = JaxSTFTConfig(n_fft=1024, hop_length=160)
        film = JaxFiLM(SPEC, COND, name="film")(condition.astype(jnp.float32))
        real_in, imag_in = wav_to_spectrogram_complex(
            mixture, cfg, precision=jax.lax.Precision.HIGHEST)
        mag = jnp.sqrt(jnp.maximum(real_in ** 2 + imag_in ** 2, 1e-10))
        origin_t = mag.shape[1]
        x = JaxBN(cfg.freq_bins, axis=2, name="bn0")(mag, train)
        x = jnp.pad(x, ((0, 0), (0, -origin_t % 2), (0, 0), (0, 0)))
        x = jax_conv2d(CH, (1, 1), name="pre_conv")(x[:, :, :512])
        enc = _maybe_remat(JaxEncoder, (3,), self.remat)
        dec = _maybe_remat(JaxDecoder, (4,), self.remat)
        x1p, x1 = enc(CH, CH, (2, 2), name="encoder_block1")(
            x, film["encoder_block1"], train)
        h = dec(CH, CH, (2, 2), name="decoder_block1")(
            x1p, x1, film["decoder_block1"], train)
        out = jax_conv2d(3, (1, 1), name="after_conv")(h)[:, :origin_t]
        return {"waveform": jax_mask_and_reconstruct(
            out, real_in, imag_in, mixture.shape[-1], cfg, 1, 3,
            precision=jax.lax.Precision.HIGHEST)}


class TorchSmallSep(torch.nn.Module):
    def __init__(self, remat: bool = False):
        super().__init__()
        self.remat = remat  # both blocks under the port's remat_call
        self.cfg = STFTConfig(n_fft=1024, hop_length=160)
        self.film = FusedFiLM(SPEC, COND)
        self.bn0 = BatchNorm(self.cfg.freq_bins, dim=3)
        self.pre_conv = Conv2d(1, CH, (1, 1))
        self.encoder_block1 = EncoderBlockRes1B(CH, CH, (2, 2))
        self.decoder_block1 = DecoderBlockRes1B(CH, CH, (2, 2))
        self.after_conv = Conv2d(CH, 3, (1, 1))

    def forward(self, input_dict):
        mixture = input_dict["mixture"]
        film = self.film(input_dict["condition"])
        real_in, imag_in = stft(mixture, self.cfg)
        mag = torch.sqrt(torch.clamp(real_in ** 2 + imag_in ** 2, min=1e-10))
        origin_t = mag.shape[2]
        x = F.pad(self.bn0(mag), (0, 0, 0, -origin_t % 2))[..., :512]
        call = remat_call if self.remat and self.training else (
            lambda block, *args: block(*args))
        x1p, x1 = call(self.encoder_block1, self.pre_conv(x),
                       film["encoder_block1"])
        h = call(self.decoder_block1, x1p, x1, film["decoder_block1"])
        out = self.after_conv(h)[:, :, :origin_t]
        return {"waveform": apply_mask_and_reconstruct(
            out, real_in, imag_in, mixture.shape[-1], self.cfg, 1)}


def _state_dict(params, stats):
    """lass_tpu variables (or grads in their place) -> the port's names."""
    sd = {}
    from_jax._linear(sd, "film", params["film"])
    from_jax._bn(sd, "bn0", params["bn0"], stats["bn0"])
    from_jax._conv(sd, "pre_conv", params["pre_conv"])
    from_jax._conv(sd, "after_conv", params["after_conv"])
    from_jax._conv_block(sd, "encoder_block1.conv_block1",
                         params["encoder_block1"]["conv_block1"],
                         stats["encoder_block1"]["conv_block1"])
    dec_p, dec_s = params["decoder_block1"], stats["decoder_block1"]
    from_jax._bn(sd, "decoder_block1.bn1", dec_p["bn1"], dec_s["bn1"])
    sd["decoder_block1.conv1.weight"] = from_jax._conv_w(
        dec_p["conv1"]["kernel"])
    from_jax._conv_block(sd, "decoder_block1.conv_block2",
                         dec_p["conv_block2"], dec_s["conv_block2"])
    return sd


def _jax_variables(sd):
    """The port's state dict -> lass_tpu (params, batch_stats), the
    inverse of _state_dict: conv kernels (O, I, kh, kw) -> (kh, kw, I, O),
    Linear weights transposed, BatchNorm weight/bias/running stats ->
    scale/bias/mean/var."""
    params, stats = {}, {}
    bns = {k[:-len(".running_mean")] for k in sd if k.endswith(
        ".running_mean")}
    for key, v in sd.items():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        v = v.detach().numpy()
        if prefix in bns:
            tree, name = ((stats, {"running_mean": "mean",
                                   "running_var": "var"}[leaf])
                          if leaf.startswith("running") else
                          (params, {"weight": "scale", "bias": "bias"}[leaf]))
        elif leaf == "weight":
            tree, name = params, "kernel"
            v = v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0)
        else:
            tree, name = params, "bias"
        node = tree
        for part in prefix.split("."):
            node = node.setdefault(part, {})
        node[name] = jnp.asarray(np.ascontiguousarray(v))
    return params, stats


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _batch(rng):
    seg = (0.1 * rng.randn(BATCH, 1, SAMPLES)).astype(np.float32)
    mix = seg + (0.1 * rng.randn(BATCH, 1, SAMPLES)).astype(np.float32)
    cond = rng.randn(BATCH, COND).astype(np.float32)
    return {"mixture": mix, "segment": seg, "condition": cond}


@pytest.fixture(scope="module")
def both_steps():
    """Two steps on each side; per step the grads the JAX step used (from
    its AMSGrad first moment), the JAX state after it, and for each port
    run (``"port"``: plain blocks, ``"remat"``: under ``remat_call``) its
    metrics, grads, state dict after it and the parameters before it."""
    rng = np.random.RandomState(3)
    torch.manual_seed(0)
    model = TorchSmallSep()
    with torch.no_grad():  # random BN affines: every term of BN's backward
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.add_(0.1 * torch.randn(m.weight.shape))
                m.bias.add_(0.1 * torch.randn(m.bias.shape))
    # the same weights on the JAX side (no flax init: its compile costs
    # more than the step's)
    jtask = JaxTask(JaxSmallSep(remat=True), JaxMixer(),
                    jax_build_optimizer(*OPTIM))
    params, stats = _jax_variables(model.state_dict())
    state = JaxTrainState(step=jnp.zeros([], jnp.int32), params=params,
                          batch_stats=stats,
                          opt_state=jtask.optimizer.init(params))
    remat_model = TorchSmallSep(remat=True)
    remat_model.load_state_dict(model.state_dict())
    tasks = {}
    for run, m in (("port", model), ("remat", remat_model)):
        optimizer, scheduler = build_optimizer(m.parameters(), *OPTIM)
        tasks[run] = AudioSepTask(m, SegmentMixer(), optimizer, scheduler)

    step_fn = jax.jit(jtask.train_step_premixed)
    _, unravel = ravel_pytree(state.params)
    steps, prev_mu = [], 0.0
    for _ in range(2):
        batch = _batch(rng)
        state, jmetrics = step_fn(state, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        # the grads the JAX step used, from its AMSGrad first moment
        # mu = b1 * mu_prev + (1 - b1) * g (one float32 rounding each)
        mu = np.asarray(state.opt_state[0].mu, np.float64)
        jgrads = unravel(jnp.asarray(
            (mu - np.float32(0.9) * prev_mu) / np.float32(0.1),
            jnp.float32))
        prev_mu = mu
        record = dict(
            jgrads=_state_dict(jgrads, state.batch_stats),
            jstate=_state_dict(state.params, state.batch_stats),
            jmetrics={k: float(v) for k, v in jmetrics.items()})
        for run, task in tasks.items():
            names = dict(task.model.named_parameters())
            before = {k: v.detach().clone() for k, v in names.items()}
            metrics = task.train_step_premixed(
                {k: torch.from_numpy(v) for k, v in batch.items()})
            record[run] = dict(
                metrics={k: float(v) for k, v in metrics.items()},
                grads={k: p.grad.clone() for k, p in names.items()},
                state={k: v.clone()
                       for k, v in task.model.state_dict().items()},
                before=before)
        steps.append(record)
    assert int(state.step) == 2
    assert all(task.step == 2 for task in tasks.values())
    return steps


def _loss_and_grad_norm(s, run):
    for key in ("train_loss", "grad_norm"):
        assert abs(s[run]["metrics"][key] - s["jmetrics"][key]) <= REL * abs(
            s["jmetrics"][key]), key


def _grads(s, run):
    names = sorted(s[run]["grads"])
    got = np.concatenate([s[run]["grads"][n].numpy().ravel() for n in names])
    ref = np.concatenate([s["jgrads"][n].numpy().ravel() for n in names])
    assert _rel(got, ref) <= REL
    for name in names:
        ref = s["jgrads"][name].numpy()
        if np.linalg.norm(ref) == 0:  # the dead decoder beta2 columns
            assert not s[run]["grads"][name].any()
            continue
        assert _rel(s[run]["grads"][name].numpy(), ref) <= 10 * REL, name


def _updated_state(s, run, step):
    moved = []
    for name, v in s[run]["state"].items():
        if name.endswith("num_batches_tracked"):
            assert int(v) == step + 1
            continue
        assert _rel(v.numpy(), s["jstate"][name].numpy()) <= REL, name
        if name in s[run]["before"]:
            delta = v - s[run]["before"][name]
            ref = s["jstate"][name] - s[run]["before"][name]
            moved.append(float(delta.abs().max()))
            # AMSGrad's updates near |g| ~ eps are sensitive to the grads'
            # last bits; the update as a whole agrees far inside this
            assert _rel(delta.numpy(), ref.numpy()) <= 1e-2, name
    assert max(moved) > 1e-4  # the step moved the weights


@pytest.mark.parametrize("step", [0, 1])
def test_loss_and_grad_norm_match_jax(both_steps, step):
    _loss_and_grad_norm(both_steps[step], "port")


@pytest.mark.parametrize("step", [0, 1])
def test_grads_match_jax(both_steps, step):
    """All grads as one vector at REL; each tensor at 10 * REL (bn0's
    per-bin grads cancel: after one update float32 noise alone takes their
    rel err to ~1.4e-4 while the whole tree's stays ~6e-6)."""
    _grads(both_steps[step], "port")


@pytest.mark.parametrize("step", [0, 1])
def test_updated_params_and_bn_stats_match_jax(both_steps, step):
    _updated_state(both_steps[step], "port", step)


@pytest.mark.parametrize("step", [0, 1])
def test_remat_step_matches_jax_remat(both_steps, step):
    """The port's blocks under remat_call against lass_tpu's under
    _maybe_remat: loss, grads (10 * REL a tensor), updated parameters, BN
    running statistics and num_batches_tracked, at the plain run's bounds."""
    s = both_steps[step]
    _loss_and_grad_norm(s, "remat")
    _grads(s, "remat")
    _updated_state(s, "remat", step)


def test_lr_multipliers_match_jax_schedules():
    warm, total = 7, 40
    for kind in ("linear_warm_up", "constant_warm_up", "cosine_warm_up"):
        ours, ref = (get_lr_schedule(kind, warm, total),
                     jax_schedule(kind, warm, total))
        for k in (0, 1, warm, 2 * warm, 3 * warm, 3 * warm + 1):
            assert ours(k) == pytest.approx(float(ref(k)), rel=1e-6), (kind,
                                                                      k)
        # the k-th update (k from 0) runs at learning_rate * lam(k)
        p = torch.nn.Parameter(torch.zeros(1))
        optimizer, scheduler = build_optimizer([p], "AdamW", 0.5, kind, warm,
                                               total)
        for k in range(2 * warm + 2):
            assert optimizer.param_groups[0]["lr"] == pytest.approx(
                0.5 * float(ref(k)), rel=1e-6, abs=1e-12), (kind, k)
            optimizer.step()
            scheduler.step()
    assert optimizer.defaults["weight_decay"] == 0.0
    assert optimizer.defaults["amsgrad"]


def test_mixer_matches_jax_on_its_draws(rng):
    for max_mix in (2, 3):
        jmixer = JaxMixer(max_mix, -10, 10)
        w = (0.3 * rng.randn(6, 1, 700)).astype(np.float32)
        w[2] *= 20  # one loud clip: the declip branch
        key = jax.random.PRNGKey(11)
        ref_mix, ref_seg = jmixer(jnp.asarray(w), key)
        k_mix, k_db, k_final = jax.random.split(key, 3)
        mix_num = jax.random.randint(k_mix, (6,), 2, max_mix + 1)
        gains = jax.random.randint(k_db, (6, max_mix - 1), -10, 11)
        final = jax.random.randint(k_final, (6,), -10, 11)
        got_mix, got_seg = SegmentMixer(max_mix, -10, 10).mix(
            torch.from_numpy(w), torch.from_numpy(np.array(mix_num)),
            torch.from_numpy(np.array(gains, np.float32)),
            torch.from_numpy(np.array(final, np.float32)))
        np.testing.assert_allclose(got_mix.numpy(), np.asarray(ref_mix),
                                   atol=1e-6)
        np.testing.assert_allclose(got_seg.numpy(), np.asarray(ref_seg),
                                   atol=1e-6)


def test_mixer_invariants(rng):
    gen = torch.Generator().manual_seed(0)
    # draws inside their bounds, max_mix_num = 3
    mix_num, gains, final = SegmentMixer(3, -4, 6).draw(4000, gen)
    assert set(mix_num.tolist()) == {2, 3}
    assert gains.shape == (4000, 2)
    assert gains.min() == -4 and gains.max() == 6
    assert final.min() == -4 and final.max() == 6
    # declip: 0 dB always, loud input -> both rescaled to a 0.9 peak
    w = torch.from_numpy(((rng.rand(2, 1, 100) * 2 - 1) * 5).astype(
        np.float32))
    mixtures, segments = SegmentMixer(2, 0, 0)(w, gen)
    peak = mixtures.abs().reshape(2, -1).amax(1)
    torch.testing.assert_close(peak, torch.full((2,), 0.9))
    ratio = (segments / w).reshape(2, -1)
    assert torch.allclose(ratio, ratio[:, :1].expand_as(ratio))
    # quiet input: nothing clipped, the noise within the dB window
    w = torch.from_numpy((0.01 * rng.randn(16, 1, 4000)).astype(np.float32))
    mixtures, segments = SegmentMixer(2, -10, 10)(w, gen)
    torch.testing.assert_close(segments, w)
    noise = mixtures - segments
    snr_db = 10 * torch.log10((noise ** 2).mean((1, 2))
                              / (segments ** 2).mean((1, 2)))
    assert (snr_db > -10.5).all() and (snr_db < 10.5).all()


def test_loss_registry_and_wire_decode():
    a, b = torch.randn(2, 50), torch.randn(2, 50)
    assert float(get_loss_function("l1_wav")(
        {"segment": a}, {"segment": b})) == pytest.approx(
        float((a - b).abs().mean()), rel=1e-6)
    assert l1(a.bfloat16(), b).dtype == torch.float32
    with pytest.raises(NotImplementedError):
        get_loss_function("nope")
    pcm = torch.tensor([-32768, -1, 0, 16384, 32767], dtype=torch.int16)
    np.testing.assert_array_equal(
        _decode_wire(pcm).numpy(), pcm.numpy().astype(np.float32) / 32768)
    x = torch.randn(3)
    assert _decode_wire(x) is x


REMAT_MODES = ("none", "wide", "all")


@pytest.fixture(scope="module")
def full_width():
    """The full-width ResUNet30 (seed 0) under each remat mode, from the
    same weights, batch and generator, B=1 x 0.32 s, float32: two train
    steps under 'none', one under 'wide' and 'all'. Per mode its task,
    metrics, grads and state dict after its first step, the running mean
    of one BN before it, and how many times each residual block's forward
    began during its first step (a forward pre-hook: a recomputed block
    begins twice)."""
    torch.manual_seed(0)
    runs, initial = {}, None
    for mode in REMAT_MODES:
        model = ResUNet30(remat=mode)
        if initial is None:
            initial = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(initial)
        optimizer, scheduler = build_optimizer(
            model.parameters(), "AdamW", 1e-3, "linear_warm_up", 1, 100)
        task = AudioSepTask(model, SegmentMixer(), optimizer, scheduler)
        calls = {name: 0 for name in REMAT_BLOCKS["all"]}
        hooks = [getattr(model.base, name).register_forward_pre_hook(
            lambda *_, name=name: calls.__setitem__(name, calls[name] + 1))
            for name in calls]
        bn = model.base.encoder_block1.conv_block1.bn1
        mean0 = bn.running_mean.clone()
        gen = torch.Generator().manual_seed(0)
        batch = {"waveform": 0.1 * torch.randn(1, 1, SAMPLES, generator=gen),
                 "condition": torch.randn(1, 512, generator=gen)}
        metrics = [task.train_step(batch, gen)]
        for h in hooks:
            h.remove()
        runs[mode] = dict(
            task=task, batch=batch, calls=calls, mean0=mean0,
            grads={n: p.grad.clone() for n, p in model.named_parameters()},
            state={k: v.clone() for k, v in model.state_dict().items()})
        if mode == "none":
            metrics.append(task.train_step(batch, gen))
        runs[mode]["metrics"] = metrics
    return runs


def test_full_width_resunet30_train_step(full_width):
    """Port only (module docstring): B=1 x 0.32 s, float32, two steps,
    remat 'none'."""
    run = full_width["none"]
    task, batch = run["task"], run["batch"]
    bn = task.model.base.encoder_block1.conv_block1.bn1
    assert task.step == 2
    for m in run["metrics"]:
        assert np.isfinite(float(m["train_loss"]))
        assert float(m["grad_norm"]) > 0
    assert not torch.equal(bn.running_mean, run["mean0"])
    assert int(bn.num_batches_tracked) == 2
    out = task.eval_forward({"mixture": batch["waveform"],
                             "condition": batch["condition"]})
    assert out.shape == (1, 1, SAMPLES) and torch.isfinite(out).all()


@pytest.mark.parametrize("mode", ["wide", "all"])
def test_full_width_remat_step_matches_none(full_width, mode):
    """One step under ``mode`` against the first under 'none': loss and
    grad norm, every grad, every updated parameter and running statistic
    at rel err <= 1e-6, num_batches_tracked exactly 1 (the recompute
    updates no statistics), the same state dict keys. On the CPU they are
    in fact bitwise equal. The mode's blocks begin their forward twice in
    the step, the others once."""
    got, ref = full_width[mode], full_width["none"]
    for key in ("train_loss", "grad_norm"):
        m, r = float(got["metrics"][0][key]), float(ref["metrics"][0][key])
        assert abs(m - r) <= 1e-6 * abs(r), key
    def close(a, b):  # torch.equal first: the float64 norms cost seconds
        return torch.equal(a, b) or _rel(a.numpy(), b.numpy()) <= 1e-6

    for name, g in got["grads"].items():
        assert close(g, ref["grads"][name]), name
    assert list(got["state"]) == list(ref["state"])
    for name, v in got["state"].items():
        if name.endswith("num_batches_tracked"):
            assert int(v) == 1, name
        else:
            assert close(v, ref["state"][name]), name
    assert got["calls"] == {name: 2 if name in REMAT_BLOCKS[mode] else 1
                            for name in REMAT_BLOCKS["all"]}
    assert set(ref["calls"].values()) == {1}


def test_eval_forwards_under_remat_all_equal_none_bitwise(full_width):
    """The same weights (the 'none' run's, after its two steps) under
    'all' and 'none': an eval forward with grad enabled and a train-mode
    forward in inference mode (remat acts only where a train-mode forward
    records grads) give the same waveform bit for bit."""
    runs = full_width
    batch = runs["none"]["batch"]
    inputs = {"mixture": batch["waveform"], "condition": batch["condition"]}
    models = {mode: runs[mode]["task"].model for mode in ("none", "all")}
    models["all"].load_state_dict(models["none"].state_dict())
    out = {}
    for mode, model in models.items():
        model.eval()
        grad_on = model(inputs)["waveform"]
        model.train()
        with torch.inference_mode():
            train_inference = model(inputs)["waveform"]
        out[mode] = (grad_on.detach(), train_inference)
    for a, b in zip(out["all"], out["none"]):
        assert torch.equal(a, b)


def test_remat_mode_read_as_lass_tpu_reads_it(monkeypatch):
    """LASS_TPU_REMAT (default 'none') where ``remat`` is None, the same
    flags as lass_tpu's ``_remat_flags`` (the JAX package reads the
    variable into ``_REMAT`` at import) and its ValueError for any other
    mode. (The state dict's keys in every mode:
    test_full_width_remat_step_matches_none.)"""
    from lass_tpu.models import resunet as jax_resunet

    monkeypatch.delenv("LASS_TPU_REMAT", raising=False)
    assert remat_mode() == "none"
    for mode in REMAT_MODES:
        monkeypatch.setenv("LASS_TPU_REMAT", mode)
        monkeypatch.setattr(jax_resunet, "_REMAT", mode)
        assert remat_mode() == remat_mode(mode) == mode
        blocks = REMAT_BLOCKS[mode]
        flags = ("encoder_block1" in blocks, "encoder_block3" in blocks)
        assert JaxResUNet30Base()._remat_flags() == flags
        assert JaxResUNet30Base(remat=mode)._remat_flags() == flags
    assert ResUNet30().remat == "all"  # the constructor reads it too
    monkeypatch.setenv("LASS_TPU_REMAT", "some")
    monkeypatch.setattr(jax_resunet, "_REMAT", "some")
    with pytest.raises(ValueError) as jax_err:
        JaxResUNet30Base()._remat_flags()
    with pytest.raises(ValueError) as port_err:
        ResUNet30()
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError):
        remat_mode("All")


def test_training_after_serving_in_one_process():
    """A forward under torch.inference_mode() (serving) and then a train
    step in the same process: the STFT's cached device constants, made by
    the first caller, must serve autograd too."""
    cfg = STFTConfig(n_fft=64, hop_length=16)  # cache entries of its own
    with torch.inference_mode():
        re, im = stft(torch.randn(1, 1, 400), cfg)
        istft(re, im, 400, cfg)
    x = torch.randn(1, 1, 400, requires_grad=True)
    re, im = stft(x, cfg)
    istft(re, im, 400, cfg).sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
