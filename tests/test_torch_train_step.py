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
from lass_torch.models.resunet import ResUNet30, apply_mask_and_reconstruct
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
        x1p, x1 = JaxEncoder(CH, CH, (2, 2), name="encoder_block1")(
            x, film["encoder_block1"], train)
        h = JaxDecoder(CH, CH, (2, 2), name="decoder_block1")(
            x1p, x1, film["decoder_block1"], train)
        out = jax_conv2d(3, (1, 1), name="after_conv")(h)[:, :origin_t]
        return {"waveform": jax_mask_and_reconstruct(
            out, real_in, imag_in, mixture.shape[-1], cfg, 1, 3,
            precision=jax.lax.Precision.HIGHEST)}


class TorchSmallSep(torch.nn.Module):
    def __init__(self):
        super().__init__()
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
        x1p, x1 = self.encoder_block1(self.pre_conv(x),
                                      film["encoder_block1"])
        h = self.decoder_block1(x1p, x1, film["decoder_block1"])
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
    its AMSGrad first moment), the JAX state after it, the port's metrics,
    grads, state dict after it and the parameters before it."""
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
    jtask = JaxTask(JaxSmallSep(), JaxMixer(), jax_build_optimizer(*OPTIM))
    params, stats = _jax_variables(model.state_dict())
    state = JaxTrainState(step=jnp.zeros([], jnp.int32), params=params,
                          batch_stats=stats,
                          opt_state=jtask.optimizer.init(params))
    optimizer, scheduler = build_optimizer(model.parameters(), *OPTIM)
    task = AudioSepTask(model, SegmentMixer(), optimizer, scheduler)
    names = dict(model.named_parameters())

    step_fn = jax.jit(jtask.train_step_premixed)
    _, unravel = ravel_pytree(state.params)
    steps, prev_mu = [], 0.0
    for _ in range(2):
        batch = _batch(rng)
        before = {k: v.detach().clone() for k, v in names.items()}
        state, jmetrics = step_fn(state, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        # the grads the JAX step used, from its AMSGrad first moment
        # mu = b1 * mu_prev + (1 - b1) * g (one float32 rounding each)
        mu = np.asarray(state.opt_state[0].mu, np.float64)
        jgrads = unravel(jnp.asarray(
            (mu - np.float32(0.9) * prev_mu) / np.float32(0.1),
            jnp.float32))
        prev_mu = mu
        metrics = task.train_step_premixed(
            {k: torch.from_numpy(v) for k, v in batch.items()})
        steps.append(dict(
            jgrads=_state_dict(jgrads, state.batch_stats),
            jstate=_state_dict(state.params, state.batch_stats),
            jmetrics={k: float(v) for k, v in jmetrics.items()},
            metrics={k: float(v) for k, v in metrics.items()},
            grads={k: p.grad.clone() for k, p in names.items()},
            state={k: v.clone() for k, v in model.state_dict().items()},
            before=before))
    assert task.step == 2 and int(state.step) == 2
    return steps


@pytest.mark.parametrize("step", [0, 1])
def test_loss_and_grad_norm_match_jax(both_steps, step):
    s = both_steps[step]
    for key in ("train_loss", "grad_norm"):
        assert abs(s["metrics"][key] - s["jmetrics"][key]) <= REL * abs(
            s["jmetrics"][key]), key


@pytest.mark.parametrize("step", [0, 1])
def test_grads_match_jax(both_steps, step):
    """All grads as one vector at REL; each tensor at 10 * REL (bn0's
    per-bin grads cancel: after one update float32 noise alone takes their
    rel err to ~1.4e-4 while the whole tree's stays ~6e-6)."""
    s = both_steps[step]
    names = sorted(s["grads"])
    got = np.concatenate([s["grads"][n].numpy().ravel() for n in names])
    ref = np.concatenate([s["jgrads"][n].numpy().ravel() for n in names])
    assert _rel(got, ref) <= REL
    for name in names:
        ref = s["jgrads"][name].numpy()
        if np.linalg.norm(ref) == 0:  # the dead decoder beta2 columns
            assert not s["grads"][name].any()
            continue
        assert _rel(s["grads"][name].numpy(), ref) <= 10 * REL, name


@pytest.mark.parametrize("step", [0, 1])
def test_updated_params_and_bn_stats_match_jax(both_steps, step):
    s = both_steps[step]
    moved = []
    for name, v in s["state"].items():
        if name.endswith("num_batches_tracked"):
            assert int(v) == step + 1
            continue
        assert _rel(v.numpy(), s["jstate"][name].numpy()) <= REL, name
        if name in s["before"]:
            delta = v - s["before"][name]
            ref = s["jstate"][name] - s["before"][name]
            moved.append(float(delta.abs().max()))
            # AMSGrad's updates near |g| ~ eps are sensitive to the grads'
            # last bits; the update as a whole agrees far inside this
            assert _rel(delta.numpy(), ref.numpy()) <= 1e-2, name
    assert max(moved) > 1e-4  # the step moved the weights


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


def test_full_width_resunet30_train_step():
    """Port only (module docstring): B=1 x 0.32 s, float32."""
    torch.manual_seed(0)
    model = ResUNet30()
    optimizer, scheduler = build_optimizer(model.parameters(), "AdamW",
                                           1e-3, "linear_warm_up", 1, 100)
    task = AudioSepTask(model, SegmentMixer(), optimizer, scheduler)
    bn = model.base.encoder_block1.conv_block1.bn1
    mean0 = bn.running_mean.clone()
    gen = torch.Generator().manual_seed(0)
    batch = {"waveform": 0.1 * torch.randn(1, 1, SAMPLES, generator=gen),
             "condition": torch.randn(1, 512, generator=gen)}
    metrics = [task.train_step(batch, gen) for _ in range(2)]
    assert task.step == 2
    for m in metrics:
        assert np.isfinite(float(m["train_loss"]))
        assert float(m["grad_norm"]) > 0
    assert not torch.equal(bn.running_mean, mean0)
    assert int(bn.num_batches_tracked) == 2
    out = task.eval_forward({"mixture": batch["waveform"],
                             "condition": batch["condition"]})
    assert out.shape == (1, 1, SAMPLES) and torch.isfinite(out).all()


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
