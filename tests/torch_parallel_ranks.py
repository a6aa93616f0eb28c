"""The rank side of tests/test_torch_parallel.py: what each process of a
2-rank gloo group runs on the CPU. This module imports no JAX, no flax and
no lass_tpu (the test process computes the JAX references and hands the
ranks numpy arrays and state dicts).

``run_checks(rank, world, inputs)`` runs every check in one group and
returns numpy results; ``SmallSep`` is the small separator of
tests/test_torch_train_step.py (``TorchSmallSep``), repeated here because
that module imports JAX (the test holds the two to one state dict and one
output).
"""
import sys
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from lass_torch.data.mixer import SegmentMixer
from lass_torch.dsp.stft import STFTConfig, stft
from lass_torch.evaluation.dcase import DCASEEvaluator, SeparationInference
from lass_torch.models.clap import htsat
from lass_torch.models.film import FusedFiLM
from lass_torch.models.resunet import apply_mask_and_reconstruct
from lass_torch.nn.blocks import DecoderBlockRes1B, EncoderBlockRes1B
from lass_torch.nn.layers import BatchNorm, Conv2d, dropout
from lass_torch.parallel.host import host_info, row_span
from lass_torch.tasks.audiosep import AudioSepTask
from lass_torch.train.optim import build_optimizer

COND, CH = 16, 8
SPEC = (
    (("encoder_block1", "conv_block1", "beta1"), CH, True),
    (("encoder_block1", "conv_block1", "beta2"), CH, True),
    (("decoder_block1", "beta1"), CH, True),
    (("decoder_block1", "beta2"), CH, False),
    (("decoder_block1", "conv_block2", "beta1"), 2 * CH, True),
    (("decoder_block1", "conv_block2", "beta2"), CH, True),
)
OPTIM = ("AdamW", 1e-3, "cosine_warm_up", 1, 100)  # full LR from step 0


class SmallSep(torch.nn.Module):
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


class CaptionEmbeddings:
    """A query encoder stub: a seeded (COND,) vector per caption."""

    def get_query_embed(self, modality, text=None, **kwargs):
        return np.stack([np.random.RandomState(zlib.crc32(t.encode())).randn(
            COND).astype(np.float32) for t in text])


def evaluate(eval_csv, audio_dir, state_dict, data_parallel):
    """The DCASE evaluator's metrics of SmallSep(state_dict) over the set,
    batches of 2 rows of 1 s."""
    model = SmallSep()
    model.load_state_dict(state_dict)
    sep = SeparationInference(model, CaptionEmbeddings(), device="cpu")
    return DCASEEvaluator(16000, eval_csv, audio_dir, batch_size=2,
                          pad_seconds=1.0, data_parallel=data_parallel)(sep)


def _rows(x, rank, world):
    b = len(x) // world
    return x[rank * b:(rank + 1) * b]


def _train_step(rank, world, inp):
    model = SmallSep()
    model.load_state_dict(inp["sep_state"])
    optimizer, scheduler = build_optimizer(model.parameters(), *OPTIM)
    task = AudioSepTask(model, SegmentMixer(), optimizer, scheduler)
    batch = {k: torch.from_numpy(_rows(v, rank, world))
             for k, v in inp["sep_batch"].items()}
    metrics = task.train_step_premixed(batch)
    return {"loss": float(metrics["train_loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "grads": {k: p.grad.numpy().copy()
                      for k, p in model.named_parameters()},
            "state": {k: v.numpy().copy()
                      for k, v in model.state_dict().items()}}


def _mix(rank, world, inp):
    """AudioSepTask.mix on this rank's rows, the mixer's draws replaced by
    the JAX ones of the global batch (asked for at the global size)."""
    draws = [torch.from_numpy(d) for d in inp["mix_draws"]]
    global_rows = len(inp["mix_waveforms"])

    def jax_draws(batch, generator):
        assert batch == global_rows, batch
        return draws

    mixer = SegmentMixer(inp["max_mix"], -10, 10)
    object.__setattr__(mixer, "draw", jax_draws)
    task = AudioSepTask(torch.nn.Linear(1, 1), mixer, None, None)
    mixtures, segments = task.mix(
        torch.from_numpy(_rows(inp["mix_waveforms"], rank, world)),
        torch.Generator())
    return {"mixtures": mixtures.numpy(), "segments": segments.numpy()}


def _batch_norm(rank, world, inp):
    """A train-mode BatchNorm over the last axis, momentum 0.1 (HTSAT's and
    PANN's bn0, the fusion blocks' momentum): output, input grad, weight
    and bias grads, running statistics."""
    bn = BatchNorm(inp["bn_x"].shape[-1], momentum=0.1, dim=-1)
    bn.load_state_dict(inp["bn_state"])
    x = torch.from_numpy(_rows(inp["bn_x"], rank, world)).requires_grad_()
    y = bn.train()(x)
    (y * torch.from_numpy(_rows(inp["bn_gy"], rank, world))).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dweight": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def _draws(rank, world, inp):
    """Train-mode draws of this rank's rows: spec-augment stripes from a
    CPU generator, a dropout mask from a generator of the same seed."""
    b = inp["draw_rows"] // world
    gen = torch.Generator().manual_seed(inp["draw_seed"])
    starts, lengths = htsat.draw_stripes(b, 101, 64, 2, gen)
    gen = torch.Generator().manual_seed(inp["draw_seed"])
    kept = dropout(torch.ones(b, 3, 7), 0.5, gen)
    return {"starts": starts.numpy(), "lengths": lengths.numpy(),
            "dropout": kept.numpy(), "row_span": row_span(b)}


def _clap_step(rank, world, inp):
    """One contrastive step of this rank's rows, the spec-augment stripes
    this rank's rows of the global ones (what ``draw_stripes`` cuts from
    a global draw, tested apart in ``_draws``)."""
    from lass_torch.models.clap.model import CLAPAudioEncoder, CLAPTextEncoder
    from lass_torch.tasks.clap_pretrain import CLAPPretrainTask
    from lass_torch.train.optim import cosine_warm_up

    stripes = inp["clap_stripes"]

    def port_draw(batch, size, width, count, generator=None):
        total, first = row_span(batch)
        starts, lengths = stripes[width]
        assert starts.shape == (total, count)
        return (torch.from_numpy(starts[first:first + batch]),
                torch.from_numpy(lengths[first:first + batch]))

    htsat.draw_stripes = port_draw
    lr, wd = inp["clap_optim"]
    task = CLAPPretrainTask(
        CLAPAudioEncoder(inp["clap_htsat"]),
        CLAPTextEncoder(inp["clap_roberta"]),
        lr=lr, betas=(0.9, 0.99), eps=1e-8, weight_decay=wd,
        schedule=cosine_warm_up(1, 100))
    task.load_state_dict(inp["clap_state"])
    batch = {k: torch.from_numpy(_rows(v, rank, world))
             for k, v in inp["clap_batch"].items()}
    metrics = task.train_step(batch)
    names = {**dict(task.audio_encoder.named_parameters()),
             **dict(task.text_encoder.named_parameters()),
             "logit_scale_a": task.logit_scale_a,
             "logit_scale_t": task.logit_scale_t}
    return {"loss": float(metrics["contrastive_loss"]),
            "grads": {k: p.grad.numpy().copy() for k, p in names.items()},
            "state": {k: v.numpy().copy()
                      for k, v in task.state_dict().items()}}


def run_checks(rank, world, inp):
    """Every check of the group, in one order on every rank."""
    torch.set_num_threads(1)
    assert host_info() == (rank, world)
    assert not {"jax", "flax", "lass_tpu"} & set(sys.modules), "JAX in a rank"
    return {"train_step": _train_step(rank, world, inp),
            "mix": _mix(rank, world, inp),
            "batch_norm": _batch_norm(rank, world, inp),
            "draws": _draws(rank, world, inp),
            "clap_step": _clap_step(rank, world, inp),
            "evaluate": evaluate(inp["eval_csv"], inp["eval_dir"],
                                 inp["sep_state"], True)}


def fail_on_rank_one(rank, world):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()
