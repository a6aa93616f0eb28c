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
from lass_torch.dsp.mel import LogMelConfig
from lass_torch.dsp.stft import STFTConfig, stft
from lass_torch.evaluation.dcase import DCASEEvaluator, SeparationInference
from lass_torch.models.clap import htsat
from lass_torch.models.film import FusedFiLM
from lass_torch.models.resunet import apply_mask_and_reconstruct
from lass_torch.nn.blocks import DecoderBlockRes1B, EncoderBlockRes1B
from lass_torch.nn.layers import BatchNorm, Conv2d, dropout
from lass_torch.models.clap.roberta import RobertaConfig
from lass_torch.models.clap.tokenizer import WhitespaceFallbackTokenizer
from lass_torch.models.query_encoder import CLAPQueryEncoder
from lass_torch.parallel import tensor
from lass_torch.parallel.host import host_info, row_span
from lass_torch.parallel.mesh import make_grid
from lass_torch.tasks.audiosep import AudioSepTask
from lass_torch.train.checkpoint import snapshot
from lass_torch.train.loop import Trainer
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
# SmallSep's tensor-parallel thresholds: every CH-wide conv and the FiLM
TP_SMALL = {"min_channels": CH, "min_film": 4 * CH}
# tests/test_torch_trainer.py's small caption encoder
SMALL_ROBERTA = dict(vocab_size=200, hidden_size=32, num_hidden_layers=1,
                     num_attention_heads=4, intermediate_size=64,
                     max_position_embeddings=80)
# tests/test_torch_htsat.py's TINY HTSAT (its 1 s clip at 48 kHz)
TINY_HTSAT = dict(mel=LogMelConfig(n_fft=256, n_mels=32), spec_size=128,
                  embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
                  window_size=4)


class SmallSep(torch.nn.Module):
    def __init__(self, condition_size=COND):
        super().__init__()
        self.cfg = STFTConfig(n_fft=1024, hop_length=160)
        self.film = FusedFiLM(SPEC, condition_size)
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


def small_encoder():
    """The same random weights at every call (a resumed run must see the
    conditioning the first run saw)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return CLAPQueryEncoder(roberta_cfg=RobertaConfig(**SMALL_ROBERTA),
                                tokenizer=WhitespaceFallbackTokenizer(200),
                                device="cpu")


def hybrid_encoder():
    """``small_encoder`` with a TINY HTSAT audio tower for 16 kHz audio,
    random weights, the same at every call; ``calls`` counts the tower's
    forward passes."""
    enc = small_encoder()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        enc.attach_audio_encoder(None, htsat.HTSATConfig(**TINY_HTSAT),
                                 sampling_rate=16000, clip_samples=48000)
    enc.calls = []
    enc.audio_model.register_forward_hook(lambda *_: enc.calls.append(1))
    return enc


def _grid_step(rank, world, inp):
    """Two premixed steps of SmallSep on a (1 x world) grid, every conv and
    the FiLM sharded, each rank fed the global batch (its data rank's
    rows): the first step's loss, whole grads and whole state, the
    replicated parameters, the moments' shapes and bytes, the checkpoint
    state after it, and the second step's loss and whole state."""
    grid = make_grid(world)
    model = SmallSep()
    model.load_state_dict(inp["sep_state"])
    tensor.shard_model(model, grid, **TP_SMALL)
    optimizer, scheduler = build_optimizer(model.parameters(), *OPTIM)
    task = AudioSepTask(model, SegmentMixer(), optimizer, scheduler,
                        grid=grid)
    batch = {k: torch.from_numpy(v) for k, v in inp["sep_batch"].items()}
    metrics = task.train_step_premixed(batch)
    dims = tensor.sharded_dims(model)

    def whole(name, t):
        return (tensor.gather_full(t, dims[name], grid) if name in dims
                else t).numpy().copy()

    moments = {n: [tuple(v.shape) for v in optimizer.state[p].values()
                   if v.dim() > 0] for n, p in model.named_parameters()}
    out = {"loss": float(metrics["train_loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "grads": {n: whole(n, p.grad)
                     for n, p in model.named_parameters()},
           "state": {n: whole(n, v) for n, v in model.state_dict().items()},
           "sharded": dims,
           "local_shapes": {n: tuple(p.shape)
                            for n, p in model.named_parameters()},
           "moments": moments,
           "moment_bytes": sum(v.nbytes for p in model.parameters()
                               for v in optimizer.state[p].values()
                               if v.dim() > 0),
           "replicated": {n: p.detach().numpy().copy()
                          for n, p in model.named_parameters()
                          if n not in dims},
           "checkpoint": snapshot(task)}
    second = task.train_step_premixed(batch)
    out["second"] = {"loss": float(second["train_loss"]),
                     "state": {n: whole(n, v)
                               for n, v in model.state_dict().items()}}
    return out


def _losses(trainer):
    """{step: train_loss} of a trainer's metrics.jsonl (rank 0's)."""
    import json
    import os

    path = os.path.join(trainer.tf_logs_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {r["step"]: r["train_loss"] for r in map(json.loads, f)}


def _trainer_runs(rank, world, inp):
    """The trainer at ``world`` ranks, one row each. Data parallel, with
    SmallSep for the model (a 512-wide condition): 4 steps (checkpoints
    1, 2, 4), then its step-2 checkpoint resumed to step 4. Then the
    full-width ResUNet30 on a (1 x world) grid for 2 steps (its step-1
    checkpoint written from the grid). Then hybrid conditioning on a (1 x
    world) grid, SmallSep sharded at TP_SMALL, 2 steps. Returns rank 0's
    losses of each run, the grid's checkpoint directory, sharded weights
    and timing, the hybrid run's sharded weights and audio tower calls."""
    from lass_torch.train import loop

    config, root = inp["trainer_config"], inp["trainer_root"]
    build_model, shard_model = loop.build_model, loop.shard_model
    loop.build_model = lambda cfg: SmallSep(cfg.model.condition_size)
    try:
        first = Trainer(config, f"{root}/dp", device="cpu", log_every=1,
                        query_encoder=small_encoder())
        first.fit(max_steps=4)
        resumed = Trainer(config, f"{root}/dp_resumed", device="cpu",
                          log_every=1, query_encoder=small_encoder(),
                          resume_checkpoint_path=first.ckpt.path(2))
        resumed.fit(max_steps=4)
        loop.shard_model = lambda model, grid: tensor.shard_model(
            model, grid, **TP_SMALL)
        encoder = hybrid_encoder()
        hybrid = Trainer(inp["hybrid_config"], f"{root}/hybrid",
                         device="cpu", log_every=1, query_encoder=encoder,
                         model_parallel=world)
        hybrid.fit(max_steps=2)
    finally:
        loop.build_model, loop.shard_model = build_model, shard_model
    grid = Trainer(inp["grid_config"], f"{root}/grid", device="cpu",
                   log_every=1, query_encoder=small_encoder(),
                   model_parallel=world)
    grid.fit(max_steps=2)
    return {"first": _losses(first), "resumed": _losses(resumed),
            "grid": _losses(grid), "grid_dir": grid.checkpoints_dir,
            "grid_sharded": tensor.sharded_dims(grid.task.model),
            "grid_timing": grid.timing, "hybrid": _losses(hybrid),
            "hybrid_sharded": tensor.sharded_dims(hybrid.task.model),
            "hybrid_audio_calls": len(encoder.calls)}


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
                                 inp["sep_state"], True),
            "grid_step": _grid_step(rank, world, inp),
            "trainer": _trainer_runs(rank, world, inp)}


def fail_on_rank_one(rank, world):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()
