"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure raises and the script exits non-zero:

1. card: name, power limit, torch/CUDA versions, compute capability;
   TF32 off for the float32 phases;
2. build the CUDA kernels from lass_torch/csrc (one nvcc per source, in
   parallel, at first use);
3. each kernel against its plain PyTorch version at every distinct shape
   the serving forward gives it (B=16 clips of 10 s) and at ragged shapes
   (B3, B4 and B5 also at the edges of their persistent schedules:
   B3_EDGES, B4_EDGES, B5_EDGES), plus gradient cases
   for the mask kernels; B1 and its six-input mode (B2, no caller in
   either package: this phase is its path) at every layout of
   ``lass_torch.mask_bench.MASK_LAYOUTS`` (the serving and the variants'
   views, mixtures 1-3 floats off 16 bytes, F of 1, 5, 257 and 512, T = 1,
   70000 rows) and the real serving views; the time-tap
   conv (B7) at its microbench's shape (16, 1024, 128, 128) and ragged
   ones, activation off and on;
4. serve: ``load_ss_model`` on a random-weight full-width ResUNet30
   (config/audiosep_base.yaml, bf16) with the full RoBERTa-base caption
   encoder, four requests of 10 s, 4.5 s and 1 s, one caption repeated so
   that it hits the caption cache; then the fused-conv configurations A
   and B (``lass_torch.models.resunet.CONFIGS``) built from the served
   model's state dict answer the 10 s (A, B) and 4.5 s (A) requests, each
   waveform held against the default configuration's. Every path runs
   with the launch counts reset just before and read just after, and each
   forward must launch exactly its configuration's kernels;
4b. evaluation, int8 and chunked serving with the served weights: a
   synthetic DCASE set (EVAL_ROWS rows of 10 s, 16 captions,
   ``lass_torch.data.synth.make_synth_eval_set``) through
   ``DCASEEvaluator`` at batch EVAL_BATCH in bf16, default configuration
   and A (each forward's kernels counted; clips/s with the host's loading
   apart); the int8 gate: ``DCASEEvaluator.calibrate`` then the evaluator
   in float32, within INT8_GATE_DB of the float32 float run on every
   metric; the B=16 x 10 s bf16 int8 forward against the float one,
   default and A; the int8 conv route (``lass_torch.ops.quant``) at each
   conv shape of that forward, exact against a float64 conv and timed
   beside cuDNN's bf16 conv, and its chunk size at the widest shape; a
   CHUNK_SECONDS clip through ``separate_long`` on the card against the
   host stitch of the same forward, float32, within 1e-5;
4c. audio-queried serving: the CLAP audio tower (HTSAT-base, random
   weights from seed 0) attached at 16 kHz to the served query encoder; 16
   reference clips of 10 s through ``get_query_embed('audio')`` in float32
   (shape, unit norms, distinct rows); their conditions separate 16
   mixtures of 10 s in bf16, default and A, each forward launching exactly
   its configuration's kernels; ``'hybird'`` at use_text_ratio 0.5 on a
   seed whose coin picks audio and one that picks text (HYBRID_SEEDS), each
   equal to its pure branch; CUDA-event times of the B=16 embed in parts
   (resample, log-mel, HTSAT + projection) and of one 10 s audio-queried
   request;
4d. caption branches: for each of BERT (bert-base) and BART (the
   bart-base encoder), a full-width random text encoder (seeded) saved as
   a reference CLAP checkpoint (``module.text_branch.*``,
   ``module.text_projection.*``, BART's ``shared.weight`` and a decoder
   key, a logit scale), read with ``load_torch_ckpt``, converted by
   ``convert_clap_text_encoder(model_type=...)`` into an npz pack and
   built by ``CLAPQueryEncoder.from_npz(tmodel=...)`` on the card with the
   fallback tokenizer: 16 distinct captions give (16, 512) unit rows, the
   pack's embedding equals the source module's within CAPTION_PACK_ABS,
   card against CPU within CAPTION_CPU_REL (float32); their conditions
   separate 16 mixtures of 10 s in bf16 (default configuration), each
   forward launching B1 once and nothing else; caption encode ms beside
   RoBERTa's. Then ``python -m lass_torch.convert_checkpoint --kind clap``
   on a reference RoBERTa-base + HTSAT-base checkpoint, whose pack
   (``from_npz``) reproduces both source towers' embeddings; then the
   CLIP-style text transformer (512 wide, 12 layers, 8 heads, CLIP_BATCH x
   77 tokens), card against CPU, and its ms;
5. the default weights in float32, B=2 x 1 s, on the card and on the CPU;
   configuration A in bf16, B=1 x 1 s, on the card and on the CPU (the
   kernels' plain versions there); the audio tower in float32, B=2 x 10 s,
   on the card and on the CPU (embedding within 1e-4, log-mel within
   1e-3 dB);
6. times with CUDA events: the B=16 x 10 s bf16 forward of the default
   configuration, A and B, caption encoding, each kernel against its bound
   and its plain version at each serving shape (B1, B2 and B6 by their
   device time alone, ``lass_torch.mask_bench.device_time``: the
   profiler's kernel duration, or a CUDA graph of the launches, beside
   the wrapper's host time per call), with a context call
   beside B3, B4 and B5 that is not the same function (``context_call``:
   cuDNN's bare conv, the sparse route of two B3 launches and the add,
   cuDNN's bare transposed conv), the B7 microbench
   (``lass_torch.microbench_tridiag``, its launches counted), and the bf16
   train step's steps/s and peak memory at the phase-7 shape;
7. train: ``python -m lass_torch.train`` in a subprocess, full-width
   ResUNet30 in bf16 on 10 s segments of a synthetic corpus with the full
   RoBERTa-base caption encoder, TRAIN_BATCH clips per step, 4 steps:
   finite losses, checkpoints at steps 1, 2 and 4, one B1 launch per
   step's forward and per eval batch (the subprocess writes its launch
   counts); 7c: with ``--eval_indexes`` / ``--eval_audio_dir`` on
   TRAIN_EVAL_ROWS synthetic rows, the eval hook fires at step 4 and
   writes finite eval_SISDR / eval_SDRi / eval_SDR to metrics.jsonl; then
   a resume from step 2 to 4 whose losses match the first run's within
   1e-5 relative; then the step-4 checkpoint serves one 10 s request
   through ``load_ss_model``;
7b. hybrid training: an in-process ``Trainer`` with the phase-4c audio
   tower, use_text_ratio 0.5, random_seed HYBRID_TRAIN_SEED (coins audio,
   text, audio, text), the same model, batch and corpus, 4 steps: finite
   losses, the audio tower run at steps 1 and 3 only, one B1 launch per
   step; a resume from step 2 within 1e-5; steps/s;
8. one float32 train step (TF32 off), B=2 x 1 s, from the same weights
   and batch on the card and on the CPU: loss within 1e-5 relative, grads
   and updated BN running statistics within 1e-4;
9. the precomputed-STFT variants at full width (VARIANT_*): a synthetic
   corpus of 32 clips of 10-12 s; recipes in process, then ``python -m
   lass_torch.precompute_stfts --mode compute_stfts`` on the card (windows
   256, 512 and 2048 at hop 160, two files of 16 x 10 s), the stored
   segment STFT against a fresh one on the card, the device part (mix +
   STFT bank) timed with CUDA events apart from the copy to the host, the
   npz write and the load of a stored file; ``MultiSTFTResUNet30`` in bf16
   on the first file, launching exactly one B1 and no other kernel, B1
   against its plain version and timed at the inputs this forward hands it
   ((16, 1001, 256), spectrum rows 257 floats apart), the eval forward
   timed; the same weights in float32, B=2 x 10 s, card vs CPU within
   1e-4; ``python -m lass_torch.train_multistft`` for 4 steps of each
   variant (multistft, negquery): finite losses, checkpoints 1, 2 and 4,
   one B1 launch per step; in process the task restored from step 2
   repeats the step-3 loss exactly, and one val step; each variant's bf16
   train step at the stored batch timed, with its peak memory and the
   CLI's own steps/s and file loads;
10. CLAP pretraining and probing, float32 with the JAX CLI's defaults, at
   full width (random weights, the whitespace tokenizer): the contrastive
   step (``lass_torch.tasks.clap_pretrain``) of HTSAT-base + RoBERTa-base
   and of PANN-14 + RoBERTa-base at CLAP_BATCH x 10 s, captions of
   CLAP_TEXT_LEN tokens, timed over 5 synchronised steps after 2 warm-up
   with its peak memory, GFLOP and TF32 settings, every loss finite and
   both logit scales at most 100; one HTSAT-base step card vs CPU
   (CLAP_CPU_BATCH x 10 s, the same weights, batch and stripes, warm-up 1
   and weight decay 10 so that the step moves the parameters by more than
   10x the limit; loss within 1e-5, grads, updated parameters and BN
   statistics within 1e-4);
   ``python -m lass_torch.clap_pretrain`` for CLAP_CLI_STEPS steps of
   CLAP_CLI_BATCH over synthetic tar shards of 10 s WAV clips with
   ``--val_datafiles`` (finite losses, checkpoints 1, 2 and 4, the final
   retrieval dict), in process the step-2 checkpoint repeating the CLI's
   step-3 loss exactly, the step-4 state's zero-shot over the val clips
   held against its plain top-k; the same CLI over FLAC shards at
   CLAP_FLAC_BATCH (its steps/s and decode seconds); ``python -m
   lass_torch.linear_probe`` on a frozen HTSAT-base with PROBE_CLASSES
   classes for CLAP_CLI_STEPS steps and one eval (finite loss, mAP, acc,
   mAUC). None of these paths may launch a kernel of B1-B7 (the launch
   counts, in process and from each CLI);
11. data parallelism (``lass_torch.parallel``). (a) One rank per card over
   NCCL, or on one card two ranks over gloo (NCCL refuses two ranks on one
   device), each fed its rows of a global batch, against one process fed
   the whole batch, float32 with TF32 off: the full-width ResUNet30
   premixed train step of PARALLEL_SEP_BATCH x 10 s (loss, grads and
   updated parameters each as one vector, BN running statistics; within
   PARALLEL_REL; every rank's parameters identical), the global mix
   (PARALLEL_MIX_ABS), the CLAP HTSAT-base + RoBERTa-base step of
   PARALLEL_CLAP_BATCH x 10 s (as phase 10's card vs CPU: the loss within
   PARALLEL_LOSS_REL), the evaluator with ``data_parallel`` over
   PARALLEL_EVAL_ROWS synthetic clips (every metric within
   PARALLEL_EVAL_DB dB); B1's launches on each rank; each one-process
   step must move the parameters by at least 10 x PARALLEL_REL of their
   norm. (b) ``python -m torch.distributed.run
   --nproc_per_node <cards> -m lass_torch.train`` for PARALLEL_CLI_STEPS
   steps of TRAIN_BATCH x 10 s a card, bf16, full width, on phase 7's
   corpus: its steps/s per card, the share of the profiled steps in the
   collectives' kernels and in BatchNorm's collectives (``--profile``),
   the ``devices=<cards>`` directory and rank 0's checkpoints; its step-2
   checkpoint resumed by a single-process ``Trainer`` for steps 3 and 4,
   the step-4 checkpoint served. (c) The codec: ms to decode a
   CODEC_SECONDS clip, native against numpy, WAV and FLAC, bitwise equal;
   beside it phase 10's FLAC CLI, which decodes through the native one.
   The phase runs (b), (c), then (a).
   ``python3 chip_smoke.py --phase 11`` runs phases 1, 2 and 11 only (on
   four cards: W = 4);
12. tensor parallelism, the trainer's prefetcher and the soak, full-width
   ResUNet30. (a) On a (D x M) grid (``lass_torch.parallel.mesh.
   make_grid``, ``lass_torch.parallel.tensor.shard_model``) at the
   layouts of GRID_LAYOUTS, over gloo on one card (NCCL, one rank a card,
   where there are enough cards), float32 with TF32 off, the premixed
   step of PARALLEL_SEP_BATCH x 10 s, each rank fed its data rank's rows,
   against one process fed the whole batch: the loss, the whole grads,
   updated parameters and BN statistics within PARALLEL_REL (loss
   PARALLEL_LOSS_REL), the replicated parameters and the BN running
   statistics bitwise equal across each model group, each rank's
   optimizer-moment bytes against the whole
   model's; the second step's loss within PARALLEL_LOSS_REL (after two
   AdamW steps the parameters' sign flips on noise-level grads add up,
   so the second step is held by its loss); the checkpoint written at the
   last layout resumed in one process: the grid's parameters exactly,
   and its second step's loss within PARALLEL_LOSS_REL. (b) ``python
   -m lass_torch.train`` through the prefetcher, bf16, TRAIN_BATCH x 10 s,
   on phase 7's corpus: PREFETCH_CLI_STEPS steps in one process, and
   under ``torch.distributed.run`` with ``--model_parallel 2`` (two
   ranks, TRAIN_BATCH / 2 rows each: the same global batch) over gloo on
   one card for SHARED_CLI_STEPS steps (over NCCL, a card each, for
   PREFETCH_CLI_STEPS); the last logged window's steps/s and
   ``Trainer.timing`` (its ``prefetch_h2d`` and ``prefetch_embed``, the
   prefetch stream's CUDA-event spans, overlap the step) of each. (c) ``python -m lass_torch.soak`` at full
   width, bf16, TRAIN_BATCH x 10 s (SOAK_ARGS): killed after its
   checkpoint, resumed in a fresh process; its overlapping losses must be
   byte-exact.
   ``python3 chip_smoke.py --phase 12`` runs phases 1, 2 and 12 only;
   with ``--across_cards``, of phase 12 only (a) and (b), the parts that
   span cards (the four-card call: NCCL, one rank a card).

The last lines are the kernels' JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``; the lines before them give
every other measured number, and chiprun_out/chip_smoke.json holds them
all as one JSON object.
"""
import ast
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, float32 outside tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
# floating-point operations of the mask chain per element, counting each
# sqrt, division, exp and tanh as one (see lass_torch/csrc/masking.cu)
MASK_FLOPS_PER_ELEMENT = 30
SERVE_REQUESTS = [("a dog barking", 10.0), ("rain falling on a tin roof", 4.5),
                  ("a man speaking over traffic", 1.0), ("a dog barking", 4.5)]
# (kernel, lass_torch.ops module, its launch counter, source, TPU kernel)
KERNELS = [
    ("apply_complex_mask_ri", "masking", "LAUNCHES",
     "lass_torch/csrc/masking.cu", "lass_tpu/ops/pallas_masking.py:59"),
    ("fused_act_conv3x3", "act_conv", "LAUNCHES",
     "lass_torch/csrc/act_conv.cu", "lass_tpu/ops/pallas_folded_conv.py:178"),
    ("fused_residual_conv_block", "convblock", "LAUNCHES",
     "lass_torch/csrc/convblock.cu", "lass_tpu/ops/pallas_convblock.py:82"),
    ("fused_act_convT", "convt", "LAUNCHES",
     "lass_torch/csrc/convt.cu", "lass_tpu/ops/pallas_convt.py:51"),
    ("apply_head_mask", "masking", "HEAD_LAUNCHES",
     "lass_torch/csrc/head_mask.cu", "lass_tpu/ops/pallas_masking.py:248"),
    ("apply_complex_mask", "masking", "B2_LAUNCHES",
     "lass_torch/csrc/masking.cu", "lass_tpu/ops/pallas_masking.py:144"),
    ("timetap_conv", "timetap_conv", "LAUNCHES",
     "lass_torch/csrc/timetap_conv.cu", "scripts/microbench_tridiag.py:80"),
]
# launches per forward of each configuration; every other kernel: 0
PER_FORWARD = {
    "default": {"apply_complex_mask_ri": 1},
    "A": {"fused_act_conv3x3": 8, "fused_act_convT": 2, "apply_head_mask": 1},
    "B": {"fused_residual_conv_block": 1, "fused_act_convT": 2,
          "apply_head_mask": 1},
}
# requests (indices into SERVE_REQUESTS) each fused configuration answers
FUSED_REQUESTS = {"A": [0, 1], "B": [0]}
# bf16 rounding: a kernel and its plain version round the same float32
# activations at the same points and sum in another order, which moves an
# output's bf16 rounding by at most one unit in the last place (2^-7 of
# the largest output); the residual block rounds one more intermediate
BF16_ULP = 2.0 ** -7
# two bf16 forwards that round at different places differ by about what
# bf16 costs against float32 (tests/test_torch_resunet.py)
BF16_FORWARD_REL = 5e-2
# phase 4b: the synthetic eval set, its batch, the int8 quality gate
# (tests/test_dcase.py's), the chunked clip, the int8 product's chunk sizes
# tried at the widest conv
EVAL_ROWS = 48
EVAL_BATCH = 16
INT8_GATE_DB = 0.1
CHUNK_SECONDS = 60.0
CHUNK_SWEEP = (2 ** 26, 2 ** 28, 2 ** 30)
INT8_OPS_PER_S = 1979e12  # H100 SXM data sheet, dense int8 tensor cores
# clips of 10 s per train step in phase 7, fixed after measuring the step's
# peak memory on an 80 GB H100 (PERF.md)
TRAIN_BATCH = 16
# phase 4c: 'hybird' seeds whose coin picks audio and text at use_text_ratio
# 0.5 (np.random.default_rng(seed).random() = 0.637 and 0.262)
HYBRID_SEEDS = {"audio": 0, "text": 2}
# phase 7b: train.random_seed whose per-step coins (seed * 1000003 + step,
# steps 0-3) pick audio, text, audio, text
HYBRID_TRAIN_SEED = 1
# phase 7c: synthetic eval rows the training CLI's hook scores at step 4
TRAIN_EVAL_ROWS = 16
# phase 9: the precomputed-STFT variants: windows, clips of 10 s per file
# (and per step), files, CLI steps, the card-vs-CPU batch
VARIANT_WINS = (256, 512, 2048)
VARIANT_BATCH = 16
VARIANT_FILES = 2
VARIANT_STEPS = 4
VARIANT_CPU_BATCH = 2
# phase 10: CLAP pretraining and probing, float32: the timed steps at the
# JAX CLI's default batch, every caption padded to its --max_text_len; the
# CLIs over synthetic tar shards of 10 s clips (CLAP_CLI_BATCH x
# CLAP_CLI_STEPS clips a run; FLAC: CLAP_FLAC_BATCH a step, as PR 9's
# numpy decoder measured it, and CLAP_FLAC_DISTINCT different clips
# cycled, the encoder being slow); the linear probe's AudioSet classes,
# each clip tagged with half of them so that every class has positives and
# negatives among the eval clips (finite mAUC)
CLAP_BATCH = 32
CLAP_TEXT_LEN = 77
CLAP_CLI_BATCH = 4
CLAP_CLI_STEPS = 4
CLAP_FLAC_BATCH = 2
CLAP_FLAC_DISTINCT = 2
CLAP_VAL_CLIPS = 16
CLAP_CPU_BATCH = 2
PROBE_CLASSES = 527
DEVICE = "cuda"  # phases 4d and 10's device
# phase 11: data parallelism. (a) the parity checks' global batches: the
# full-width ResUNet30 premixed train step and the mix, the CLAP step, the
# evaluator's clips and batch (float32, TF32 off); (b) the training CLI
# under torch.distributed.run, TRAIN_BATCH clips a card, PARALLEL_CLI_STEPS
# steps; (c) the codec's clip: 10 s, mono, 48 kHz (the CLAP shards')
PARALLEL_SEP_BATCH = 4
PARALLEL_CLAP_BATCH = 4
PARALLEL_EVAL_ROWS = 16
PARALLEL_EVAL_BATCH = 4
PARALLEL_CLI_STEPS = 4
PARALLEL_REL = 1e-4
PARALLEL_LOSS_REL = 1e-5
PARALLEL_MIX_ABS = 1e-6
PARALLEL_EVAL_DB = 1e-6
CODEC_SECONDS = 10.0
# phase 4d: the caption branches. Each BERT / BART embedding built from its
# pack against its source module on the card (float32, TF32 off), and the
# card against the CPU; the CLIP-style transformer at open_clip's width
# (B=16 x 77 tokens), card against CPU
CAPTION_PACK_ABS = 1e-6
CAPTION_CPU_REL = 1e-4
CLIP_BATCH = 16
# phase 12: tensor parallelism's (data, model) layouts; the prefetching
# CLI's steps and logging window (its steps/s is the last window's), and
# those of the (1 x 2) grid's CLI where its ranks share one card over gloo
# (a few steps: they hold its launches and timing keys, not a rate); the
# soak's flags
GRID_LAYOUTS = ((1, 2), (2, 2))
PREFETCH_CLI_STEPS, PREFETCH_LOG_EVERY = 20, 10
SHARED_CLI_STEPS, SHARED_LOG_EVERY = 4, 2
SOAK_ARGS = ("--steps", "30", "--kill_after", "10", "--save_every", "10",
             "--eval_every", "30", "--log_every", "5")
RESULTS = {}


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3, reps=1):
    """Milliseconds of one fn() on the current stream by CUDA events: the
    median over ``iters`` samples, each a run of ``reps`` back-to-back
    calls divided by ``reps`` (reps > 1 keeps the card busy while the host
    enqueues, so a short kernel's time is not its launch overhead)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def rel_err(got, ref):
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    return ((got - ref).norm() / ref.norm()).item()


def max_err(got, ref):
    return max((g.float() - r.float()).abs().max().item()
               for g, r in zip(got, ref))


def serving_mask_inputs(device, b=16, seconds=10.0, t_pad=1024, seed=0):
    """The mask kernel's inputs as the serving forward hands them over:
    channel slices of (B, 3, T_pad, 512) logits cropped to T and the
    (B, 1, T, 513) spectrum cropped to 512 bins."""
    import torch

    from lass_torch.models.resunet import mask_inputs

    t = int(seconds * 16000) // 160 + 1
    gen = torch.Generator(device=device).manual_seed(seed)
    logits = 3 * torch.randn(b, 3, t_pad, 512, generator=gen, device=device)
    re = torch.randn(b, 1, t, 513, generator=gen, device=device)
    im = torch.randn(b, 1, t, 513, generator=gen, device=device)
    return mask_inputs(logits[:, :, :t], re, im, 1)


def mag_cos_sin(re, im):
    """The mixture terms B2 takes precomputed."""
    import torch

    mag = torch.sqrt(torch.clamp(re * re + im * im, min=1e-10))
    return mag, re / mag, im / mag


def check_mask_kernel(device, b2=False):
    """Phase 3 for B1 (five inputs) or B2 (``b2``: six, the mixture as
    mag/cos/sin): kernel vs plain at the serving views and at every layout
    of ``MASK_LAYOUTS``; a gradient through the autograd.Function. Returns
    the largest error at the serving views."""
    import torch

    from lass_torch.mask_bench import MASK_LAYOUTS, layout_inputs
    from lass_torch.ops import masking

    name = "B2 mask kernel" if b2 else "mask kernel"
    fn = masking.apply_complex_mask if b2 else masking.apply_complex_mask_ri
    plain = masking.mask_math if b2 else masking.mask_math_from_ri

    def compare(args, what):
        got = fn(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        err = max_err(got, ref)
        scale = max(1.0, max(r.abs().max().item() for r in ref))
        log(f"{name} vs plain, {what}: max abs err {err:.3e} "
            f"(limit {1e-5 * scale:.3e})")
        if not err <= 1e-5 * scale:
            raise AssertionError(f"{name} disagrees at {what}")
        return err

    serving = serving_mask_inputs(device)
    if b2:
        serving = (*serving[:3], *mag_cos_sin(*serving[3:]))
    err = compare(serving, f"serving views {tuple(serving[0].shape)}")
    for k, case in enumerate(MASK_LAYOUTS):
        args = layout_inputs(case, six=b2, device=device, seed=k)
        compare(args, f"{case[0]} {case[1]}, row strides "
                      f"{[a.stride(1) for a in args]}")
        del args
    gen = torch.Generator(device=device).manual_seed(1)
    n_in = 6 if b2 else 5
    args = [torch.randn(2, 5, 64, generator=gen, device=device,
                        requires_grad=True) for _ in range(n_in)]
    r, i = fn(*args)
    grads = torch.autograd.grad((r ** 2 + 0.5 * i).sum(), args)
    r2, i2 = plain(*args)
    grads_ref = torch.autograd.grad((r2 ** 2 + 0.5 * i2).sum(), args)
    gerr = max_err(grads, grads_ref)
    log(f"{name} gradient vs plain: max abs err {gerr:.3e}")
    if not gerr <= 1e-5:
        raise AssertionError(f"{name} gradient disagrees")
    return err


def check_timetap(device):
    """Phase 3 for B7: kernel vs plain at the microbench's shape and at a
    ragged T and G, each t_tile, activation off and on; within one bf16
    unit of the largest output. Returns the largest error at the
    microbench's shape."""
    import torch

    from lass_torch.microbench_tridiag import SHAPE, inputs
    from lass_torch.ops import timetap_conv as tt

    worst = 0.0
    cases = [(SHAPE, 16)] + [((2, 37, 5, 128), t) for t in tt.T_TILES] + [
        ((1, 70, 3, 64), 32)]
    for k, (shape, t_tile) in enumerate(cases):
        x, w3, _ = inputs(shape, seed=k)
        for act in (False, True):
            with torch.inference_mode():
                got = tt.timetap_conv(x, w3, act, t_tile)
                torch.cuda.synchronize()
                ref = tt.timetap_conv_plain(x, w3, act)
            err = max_err((got,), (ref,))
            limit = BF16_ULP * ref.float().abs().max().item()
            log(f"timetap_conv vs plain, {shape} t_tile {t_tile} act {act}: "
                f"max abs err {err:.3e} (limit {limit:.3e})")
            if not err <= limit:
                raise AssertionError(f"timetap_conv disagrees at {shape}")
            if shape == SHAPE:
                worst = max(worst, err)
    return worst


def kernel_counts():
    import importlib

    return {name: getattr(importlib.import_module(f"lass_torch.ops.{mod}"),
                          attr) for name, mod, attr, _, _ in KERNELS}


def reset_kernel_counts():
    import importlib

    for _, mod, attr, _, _ in KERNELS:
        setattr(importlib.import_module(f"lass_torch.ops.{mod}"), attr, 0)


def fused_cases(device, b=16, l1=(1024, 512), t_out=1001, head_channels=1,
                seed=0):
    """Every distinct shape the serving forward gives the fused kernels
    (at b=16, l1=(1024, 512), t_out=1001: B=16 clips of 10 s, level 1 of
    T_pad x 512, 1001 STFT frames), each with its launches per forward
    (n), the bytes a call must move (each input read once, each output
    written once), its operations and their peak rate."""
    import torch

    from lass_torch.ops import act_conv, convblock, convt, masking

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0, around=0.0):
        return around + scale * torch.randn(*shape, generator=gen,
                                            device=device)

    def act(c, t, f):
        return randn(b, c, t, f).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

    (t1, f1), (t2, f2), (t3, f3) = [(l1[0] // k, l1[1] // k) for k in (1, 2, 4)]
    cases = []
    for label, chans, cout, t, f, n in [
            ("encoder_block1 conv1+conv2, decoder_block6 conv2", (32,), 32,
             t1, f1, 3),
            ("encoder_block2 conv1", (32,), 64, t2, f2, 1),
            ("encoder_block2 conv2, decoder_block5 conv2", (64,), 64, t2, f2,
             2),
            ("decoder_block5 conv1", (64, 64), 64, t2, f2, 1),
            ("decoder_block6 conv1", (32, 32), 32, t1, f1, 1)]:
        cin, m = sum(chans), b * t * f
        cases.append(dict(
            kernel="fused_act_conv3x3", n=n, ulps=1,
            label=f"{label}: {'+'.join(map(str, chans))}->{cout} at "
                  f"{b}x{t}x{f}",
            fn=act_conv.fused_act_conv3x3, plain=act_conv.act_conv3x3_plain,
            args=([act(c, t, f) for c in chans],
                  randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5),
                  randn(b, cin, scale=0.1, around=1.0),
                  randn(b, cin, scale=0.1)),
            bytes=2 * m * (cin + cout) + 2 * 9 * cin * cout + 8 * b * cin,
            ops=2 * m * 9 * cin * cout, rate=BF16_FLOP_PER_S))
    u, m = 32, b * t1 * f1
    cases.append(dict(
        kernel="fused_residual_conv_block", n=1, ulps=2,
        label=f"encoder_block1 block: {u} at {b}x{t1}x{f1}",
        fn=convblock.fused_residual_conv_block,
        plain=convblock.residual_conv_block_plain,
        args=(act(u, t1, f1), randn(u, u, 3, 3, scale=(9 * u) ** -0.5),
              randn(u, u, 3, 3, scale=(9 * u) ** -0.5),
              randn(b, u, scale=0.1, around=1.0), randn(b, u, scale=0.1),
              randn(b, u, scale=0.1, around=1.0), randn(b, u, scale=0.1)),
        bytes=4 * m * u + 4 * 9 * u * u + 16 * b * u,
        ops=4 * m * 9 * u * u, rate=BF16_FLOP_PER_S))
    for label, cin, cout, t, f in [("decoder_block5 conv1", 128, 64, t3, f3),
                                   ("decoder_block6 conv1", 64, 32, t2, f2)]:
        m = b * t * f
        cases.append(dict(
            kernel="fused_act_convT", n=1, ulps=1,
            label=f"{label}: {cin}->{cout} at {b}x{t}x{f} -> "
                  f"{2 * t}x{2 * f}",
            fn=convt.fused_act_convT, plain=convt.act_convT_plain,
            args=(act(cin, t, f), randn(cin, scale=0.1, around=1.0),
                  randn(cin, scale=0.1), randn(b, cin, scale=0.1),
                  randn(cin, cout, 2, 2, scale=cin ** -0.5)),
            bytes=2 * m * cin + 8 * m * cout + 8 * cin * cout
            + 4 * (2 + b) * cin,
            ops=8 * m * cin * cout, rate=BF16_FLOP_PER_S))
    c, mo, m = 32, 3 * head_channels, b * t_out * f1
    cases.append(dict(
        kernel="apply_head_mask", n=1, ulps=0,
        label=f"head: {c}->{mo} logits + mask, {b}x{t_out} of {t1}x{f1}, "
              f"{head_channels} output channel(s)",
        fn=masking.apply_head_mask, plain=masking.head_mask_plain,
        args=(act(c, t1, f1), randn(mo, c, 1, 1, scale=c ** -0.5),
              randn(mo, scale=0.1), randn(b, 1, t_out, f1 + 1),
              randn(b, 1, t_out, f1 + 1), head_channels),
        bytes=m * (2 * c + 8 + 8 * head_channels) + 4 * (c + 1) * mo,
        ops=m * head_channels * (6 * c + MASK_FLOPS_PER_ELEMENT),
        rate=F32_FLOP_PER_S))
    return cases


def check_case(case):
    """Kernel vs plain version on the card; bf16 outputs within case['ulps']
    bf16 units of the largest output, float32 ones within 1e-4 of
    max(1, largest). Returns the max abs error."""
    import torch

    with torch.inference_mode():
        got = case["fn"](*case["args"])
        torch.cuda.synchronize()
        ref = case["plain"](*case["args"])
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    err = max_err(got, ref)
    scale = max(r.float().abs().max().item() for r in ref)
    limit = (case["ulps"] * BF16_ULP * scale if case["ulps"]
             else 1e-4 * max(1.0, scale))
    log(f"{case['kernel']} vs plain, {case['label']}: max abs err {err:.3e} "
        f"(limit {limit:.3e})")
    if not err <= limit:
        raise AssertionError(f"{case['kernel']} disagrees at {case['label']}")
    if case["ulps"] and not got[0].is_contiguous(
            memory_format=torch.channels_last):
        raise AssertionError(f"{case['kernel']} output is not channels_last")
    return err


# B3 at the edges of its persistent schedule (b, source channels, C_out,
# T, F): T and F off the 64-frequency strip, one batch (fewer columns than
# SMs), T = 1 and 2 (every halo row is padding), sources split 8 + 24, the
# widest input (64 + 64) -> 64, C_in 48 (a chunk count that does not
# divide a warpgroup)
B3_EDGES = [(2, (32,), 32, 70, 130), (1, (32,), 64, 5, 20),
            (1, (32,), 32, 1, 64), (2, (16, 16), 32, 2, 65),
            (2, (8, 24), 32, 19, 71), (2, (64, 64), 64, 11, 131),
            (1, (64, 64), 64, 1, 7), (2, (48,), 64, 6, 33)]


def b3_edge_cases(device, seed=2):
    import torch

    from lass_torch.ops import act_conv

    gen = torch.Generator(device=device).manual_seed(seed)
    cases = []
    for b, chans, cout, t, f in B3_EDGES:
        cin = sum(chans)
        srcs = [torch.randn(b, c, t, f, generator=gen, device=device).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
            for c in chans]
        cases.append(dict(
            kernel="fused_act_conv3x3", ulps=1,
            label=f"schedule edge {'+'.join(map(str, chans))}->{cout} at "
                  f"{b}x{t}x{f}",
            fn=act_conv.fused_act_conv3x3, plain=act_conv.act_conv3x3_plain,
            args=(srcs, (9 * cin) ** -0.5 * torch.randn(
                cout, cin, 3, 3, generator=gen, device=device),
                1 + 0.1 * torch.randn(b, cin, generator=gen, device=device),
                0.1 * torch.randn(b, cin, generator=gen, device=device))))
    return cases


# B4 and B5 at the edges of their persistent schedules: T = 1, 2 and 3
# (every halo row is padding), F off the strip (B4: 62 outputs, B5: 64
# positions), F smaller than one strip, the serving F = 512 (which 62 does
# not divide) at a short T, one batch (fewer columns than warpgroups), and
# a one-batch view into a larger tensor (its batch stride and offset are
# not a contiguous tensor's). B4: (b, T, F, batch view); B5: (b, C_in,
# C_out, T, F, batch view).
B4_EDGES = [(2, 1, 100, False), (2, 2, 512, False), (1, 3, 40, False),
            (2, 37, 100, False), (1, 9, 62, False), (3, 5, 63, False),
            (1, 11, 70, True)]
B5_EDGES = [(2, 128, 64, 1, 100, False), (2, 64, 32, 2, 20, False),
            (1, 64, 32, 3, 512, False), (1, 128, 64, 5, 37, False),
            (2, 64, 32, 7, 65, False), (1, 64, 32, 6, 33, True),
            (1, 128, 64, 4, 130, True)]


def b4_b5_edge_cases(device, seed=4):
    import torch

    from lass_torch.ops import convblock, convt

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0, around=0.0):
        return around + scale * torch.randn(*shape, generator=gen,
                                            device=device)

    def act(b, c, t, f, view):
        x = randn(2 * b if view else b, c, t, f).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        return x[1::2] if view else x

    cases = []
    for b, t, f, view in B4_EDGES:
        u = 32
        cases.append(dict(
            kernel="fused_residual_conv_block", ulps=2,
            label=f"schedule edge {u} at {b}x{t}x{f}"
                  + (", batch view" if view else ""),
            fn=convblock.fused_residual_conv_block,
            plain=convblock.residual_conv_block_plain,
            args=(act(b, u, t, f, view),
                  randn(u, u, 3, 3, scale=(9 * u) ** -0.5),
                  randn(u, u, 3, 3, scale=(9 * u) ** -0.5),
                  randn(b, u, scale=0.1, around=1.0), randn(b, u, scale=0.1),
                  randn(b, u, scale=0.1, around=1.0),
                  randn(b, u, scale=0.1))))
    for b, cin, cout, t, f, view in B5_EDGES:
        cases.append(dict(
            kernel="fused_act_convT", ulps=1,
            label=f"schedule edge {cin}->{cout} at {b}x{t}x{f}"
                  + (", batch view" if view else ""),
            fn=convt.fused_act_convT, plain=convt.act_convT_plain,
            args=(act(b, cin, t, f, view), randn(cin, scale=0.1, around=1.0),
                  randn(cin, scale=0.1), randn(b, cin, scale=0.1),
                  randn(cin, cout, 2, 2, scale=cin ** -0.5))))
    return cases


def check_fused_kernels(device):
    """Phase 3 for the fused kernels: every serving shape, the same set at
    ragged sizes (b=2, level 1 of 74 x 100, two output channels for the
    head), B3, B4 and B5 at the edges of their schedules (B3_EDGES,
    B4_EDGES, B5_EDGES), and a head gradient. Returns the largest error per kernel at the serving
    shapes."""
    import torch

    from lass_torch.ops import masking

    worst = {}
    for case in fused_cases(device):
        err = check_case(case)
        worst[case["kernel"]] = max(worst.get(case["kernel"], 0.0), err)
    edges = b3_edge_cases(device) + b4_b5_edge_cases(device)
    for case in fused_cases(device, b=2, l1=(74, 100), t_out=70,
                            head_channels=2, seed=1) + edges:
        check_case(case)
    gen = torch.Generator(device=device).manual_seed(3)
    h = torch.randn(1, 32, 5, 24, generator=gen, device=device).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    h.requires_grad_(True)
    w = (0.2 * torch.randn(3, 32, 1, 1, generator=gen, device=device)
         ).requires_grad_(True)
    bias = (0.1 * torch.randn(3, generator=gen, device=device)
            ).requires_grad_(True)
    spec = [torch.randn(1, 1, 5, 25, generator=gen, device=device)
            for _ in range(2)]

    def grads(fn):
        r, i = fn(h, w, bias, *spec, 1)
        return torch.autograd.grad((r ** 2 + 0.5 * i).sum(), (h, w, bias))

    gerr = max_err(grads(masking.apply_head_mask),
                   grads(masking.head_mask_plain))
    log(f"head kernel gradient vs plain: max abs err {gerr:.3e} (limit 2e-4)")
    if not gerr <= 2e-4:
        raise AssertionError("head kernel gradient disagrees")
    return worst


def build_server(device, ckpt_dir):
    """load_ss_model on a random-weight checkpoint written with the port's
    own saver, full width from config/audiosep_base.yaml."""
    import torch

    from lass_torch.config import load_config
    from lass_torch.convert.checkpoint_io import (
        load_ss_model, save_ss_checkpoint)
    from lass_torch.models.resunet import build_model

    cfg = load_config(os.path.join(REPO, "config", "audiosep_base.yaml"))
    torch.manual_seed(0)
    path = os.path.join(ckpt_dir, "random_resunet30.ckpt")
    save_ss_checkpoint(build_model(cfg), path)
    try:
        return cfg, load_ss_model(cfg, path, device=device)
    finally:
        os.remove(path)


def serve(sep, requests, config="default", sampling_rate=16000, seed=0):
    """Phase 4: answer the requests; each forward must launch exactly the
    kernels of its configuration (PER_FORWARD). Returns the per-request
    seconds and waveforms."""
    import numpy as np

    rng = np.random.RandomState(seed)
    on_card = next(sep.model.parameters()).is_cuda
    expect = {name: PER_FORWARD[config].get(name, 0) for name, *_ in KERNELS}
    seconds, outputs = [], []
    for caption, dur in requests:
        length = int(dur * sampling_rate)
        mixture = (0.1 * rng.randn(1, 1, length)).astype(np.float32)
        before = kernel_counts()
        start = time.perf_counter()
        cond = sep.query_encoder.get_query_embed("text", text=[caption])
        out = sep.separate(mixture, cond)
        seconds.append(time.perf_counter() - start)
        if out.shape != (1, 1, length) or not np.isfinite(out).all():
            raise AssertionError(f"bad output for {caption!r}: {out.shape}")
        launched = {k: v - before[k] for k, v in kernel_counts().items()}
        if on_card and launched != expect:
            raise AssertionError(f"config {config}: a forward launched "
                                 f"{launched}, expected {expect}")
        outputs.append(out)
        log(f"config {config}, request {caption!r} {dur} s: "
            f"{seconds[-1] * 1e3:.1f} ms, peak |y| {np.abs(out).max():.4f}")
    return seconds, outputs


def fused_server(sep, config):
    """The served model's state dict in a fused configuration, bound to the
    same caption encoder."""
    from lass_torch.config import load_config
    from lass_torch.evaluation.dcase import SeparationInference
    from lass_torch.models.resunet import CONFIGS, build_model

    cfg = load_config(os.path.join(REPO, "config", "audiosep_base.yaml"))
    model = build_model(cfg, **CONFIGS[config])
    model.load_state_dict(sep.model.state_dict())
    return SeparationInference(model, sep.query_encoder, device=sep.device)


def serve_fused(sep, default_outputs):
    """Phase 4 for configurations A and B: counts reset before each path
    and read after it; each waveform against the default configuration's
    for the same request. Returns {config: (launches, rel errs)}."""
    import numpy as np

    out = {}
    for config, picks in FUSED_REQUESTS.items():
        fsep = fused_server(sep, config)
        requests = [SERVE_REQUESTS[i] for i in picks]
        reset_kernel_counts()
        _, waves = serve(fsep, requests, config)
        launches = kernel_counts()
        errs = []
        for i, wave in zip(picks, waves):
            ref = default_outputs[i].astype(np.float64)
            errs.append(float(np.linalg.norm(wave - ref)
                              / (np.linalg.norm(ref) + 1e-20)))
            log(f"config {config} vs default, request {i}: rel err "
                f"{errs[-1]:.3e} (limit {BF16_FORWARD_REL})")
        log(f"launches during config {config} serving: {launches}")
        if max(errs) > BF16_FORWARD_REL:
            raise AssertionError(f"config {config} disagrees with default")
        out[config] = (launches, errs)
    return out


def run_evaluator(sep, evaluator, config, label):
    """Phase 4b: one pass of the evaluator, launch counts reset before and
    read after; each forward must launch its configuration's kernels."""
    batches = -(-len(evaluator.eval_list) // evaluator.batch_size)
    reset_kernel_counts()
    start = time.perf_counter()
    sisdr, sdri, sdr = evaluator(sep)
    seconds = time.perf_counter() - start
    launched = kernel_counts()
    expect = {name: batches * PER_FORWARD[config].get(name, 0)
              for name, *_ in KERNELS}
    if launched != expect:
        raise AssertionError(f"evaluator, {label}: launched {launched}, "
                             f"expected {expect}")
    if not all(math.isfinite(v) for v in (sisdr, sdri, sdr)):
        raise AssertionError(f"evaluator, {label}: metrics {sisdr, sdri, sdr}")
    timing = evaluator.timing
    row = {"sisdr": sisdr, "sdri": sdri, "sdr": sdr, "seconds": seconds,
           "clips_per_s": len(evaluator.eval_list) / seconds,
           "host_load_s": timing["load_s"], "separate_s": timing["separate_s"],
           "metrics_s": timing["metrics_s"],
           "host_share": (timing["load_s"] + timing["metrics_s"]) / seconds,
           "launches": launched}
    log(f"evaluator, {label}: SDR {sdr:.4f}, SDRi {sdri:.4f}, SI-SDR "
        f"{sisdr:.4f}; {row['clips_per_s']:.1f} clips/s over "
        f"{len(evaluator.eval_list)} clips ({seconds:.3f} s: host loading "
        f"and mixing {timing['load_s']:.3f} s, captions + separation "
        f"{timing['separate_s']:.3f} s, metrics {timing['metrics_s']:.3f} s)")
    return row


def int8_conv_shapes(model):
    """The (input shape, weight shape) of every int8 conv of one B=16 x 10 s
    forward of a calibrated quantized ``model``, with its count."""
    import torch

    from lass_torch.ops import quant

    shapes = {}

    def record(_, args):
        key = (tuple(args[0].shape), tuple(args[1].weight.shape))
        shapes[key] = shapes.get(key, 0) + 1

    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = {"mixture": 0.1 * torch.randn(16, 1, 160000, generator=gen,
                                          device="cuda"),
             "condition": torch.randn(16, 512, generator=gen, device="cuda")}
    hooks = [m.register_forward_pre_hook(record)
             for m in quant.quant_layers(model)]
    try:
        with torch.inference_mode():
            model(batch)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def time_int8_route(shapes, seed=9, iters=5, reps=3):
    """Phase 4b: the int8 conv route (quantize, im2col + torch._int_mm,
    dequantize) at each shape, bf16 in and out, channels_last as in the
    quantized model, its product alone, and cuDNN's bf16 conv at the same
    shape and layout (not the same function: context).
    The int32 product at two batch items must equal a float64 conv of the
    same int8 values, rounded (every partial sum is an integer below 2^27,
    so the rounding only undoes an FFT or Winograd algorithm's error).
    Returns rows."""
    import torch
    import torch.nn.functional as F

    from lass_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for (xs, ws), n in sorted(shapes.items(), key=lambda kv: -kv[0][0][3]):
        b, c, h, w = xs
        o, _, k, _ = ws
        x = torch.randn(*xs, generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wt = (k * k * c) ** -0.5 * torch.randn(*ws, generator=gen,
                                               device="cuda")
        scale = x.float().abs().amax(dim=(0, 2, 3)) / 127.0
        kq, sw = quant.quantize_weight(wt * scale[None, :, None, None])
        xq = quant.quantize_act(x, scale)
        with torch.inference_mode():
            got = quant.int8_conv_int32(xq[:2], kq)
            ref = F.conv2d(xq[:2].double(), kq.double(), padding=k // 2)
            if not torch.equal(got.permute(0, 3, 1, 2),
                               ref.round().to(torch.int32)):
                raise AssertionError(f"int8 product disagrees at {xs}, {ws}")
            wb = wt.to(torch.bfloat16)
            calls = {
                "route": lambda: quant.conv_int8(x, None, scale,
                                                 packed=(kq, sw)),
                "product": lambda: quant.int8_conv_int32(xq, kq),
                "cudnn_bf16": lambda: F.conv2d(x, wb, padding=k // 2)}
            runs = {name: [] for name in calls}
            for name in ("cudnn_bf16", "route", "product", "route",
                         "cudnn_bf16"):
                runs[name].append(cuda_ms(calls[name], iters, 2, reps))
        m = b * h * w
        bytes_ms = (2 * m * (c + o) + o * c * k * k) / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * m * o * c * k * k / INT8_OPS_PER_S * 1e3
        row = {"input": list(xs), "weight": list(ws), "per_forward": n,
               "ms": min(runs["route"]), "product_ms": min(runs["product"]),
               "cudnn_bf16_ms": min(runs["cudnn_bf16"]),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        rows.append(row)
        log(f"int8 conv route {c}->{o} k{k} at {b}x{h}x{w} (x{n} per "
            f"forward): {row['ms'] * 1e3:.1f} us (product alone "
            f"{row['product_ms'] * 1e3:.1f} us), bound "
            f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}); cuDNN bf16 "
            f"conv (context) {row['cudnn_bf16_ms'] * 1e3:.1f} us")
        del x, xq, got, ref, calls
    return rows


def chunk_sweep(shape, seed=10, iters=5):
    """Phase 4b: the int8 route at the widest conv with each CHUNK_SWEEP
    value of ``quant.CHUNK_ELEMENTS`` (im2col elements per product call),
    in turns; the module's value is restored."""
    import torch

    from lass_torch.ops import quant

    (xs, ws) = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(*xs, generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = torch.randn(*ws, generator=gen, device="cuda") * 0.05
    scale = x.float().abs().amax(dim=(0, 2, 3)) / 127.0
    packed = quant.quantize_weight(wt * scale[None, :, None, None])
    kept = quant.CHUNK_ELEMENTS
    times = {}
    try:
        with torch.inference_mode():
            for chunk in CHUNK_SWEEP + CHUNK_SWEEP[::-1]:
                quant.CHUNK_ELEMENTS = chunk
                t = cuda_ms(lambda: quant.conv_int8(x, None, scale,
                                                    packed=packed), iters)
                times[chunk] = min(times.get(chunk, t), t)
    finally:
        quant.CHUNK_ELEMENTS = kept
    log(f"int8 route at {xs} by im2col elements per product call: "
        + ", ".join(f"2^{c.bit_length() - 1}: {t:.3f} ms"
                    for c, t in times.items()))
    return {str(c): t for c, t in times.items()}


def eval_int8_chunked(sep, cfg, build_dir):
    """Phase 4b (module docstring). Returns its results and the launches
    of its evaluator, int8 and chunked paths."""
    import numpy as np
    import torch

    from lass_torch.data.synth import make_synth_eval_set
    from lass_torch.evaluation.dcase import DCASEEvaluator, SeparationInference
    from lass_torch.models.chunk import ChunkConfig, chunk_inference
    from lass_torch.models.resunet import CONFIGS, ResUNet30, build_model

    phase_start = time.perf_counter()
    out, launches = {}, {name: 0 for name, *_ in KERNELS}

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    def server(config="default", quantize=False, dtype=None):
        if dtype is None:
            model = build_model(cfg, quantize=quantize, **CONFIGS[config])
        else:
            model = ResUNet30(compute_dtype=dtype, quantize=quantize,
                              **CONFIGS[config])
        model.load_state_dict(sep.model.state_dict())
        return SeparationInference(model, sep.query_encoder, device="cuda")

    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        start = time.perf_counter()
        csv_path = make_synth_eval_set(root, num_rows=EVAL_ROWS, seconds=10.0)
        log(f"synthetic eval set: {EVAL_ROWS} rows of 10 s, "
            f"{time.perf_counter() - start:.1f} s to write")

        def evaluator():
            return DCASEEvaluator(16000, csv_path, root, EVAL_BATCH)

        # bf16: the served default model and config A; a first pass warms
        # the caption cache and cuDNN, the second is reported
        for config in ("default", "A"):
            s = sep if config == "default" else server(config)
            run_evaluator(s, evaluator(), config, f"{config} bf16 (warm-up)")
            out[f"eval_{config}_bf16"] = row = run_evaluator(
                s, evaluator(), config, f"{config} bf16")
            add(row["launches"])
            del s
        torch.cuda.empty_cache()

        # the int8 gate, float32 (TF32 is off since phase 1)
        f32 = server(dtype=torch.float32)
        out["eval_default_f32"] = ref = run_evaluator(
            f32, evaluator(), "default", "default float32")
        add(ref["launches"])
        q32 = server(quantize=True, dtype=torch.float32)
        ev = evaluator()
        start = time.perf_counter()
        ev.calibrate(q32)
        calib_s = time.perf_counter() - start
        out["eval_default_f32_int8"] = q = run_evaluator(
            q32, ev, "default", "default float32 int8")
        add(q["launches"])
        delta = {k: q[k] - ref[k] for k in ("sisdr", "sdri", "sdr")}
        out["int8_delta_db"] = delta
        out["int8_calibrate_s"] = calib_s
        log(f"int8 - float, float32, {EVAL_ROWS} clips: {delta} dB (limit "
            f"{INT8_GATE_DB}); calibrate (3 batches + pack) {calib_s:.2f} s")
        if not max(abs(v) for v in delta.values()) < INT8_GATE_DB:
            raise AssertionError(f"int8 is {delta} dB from float")
        del q32
        torch.cuda.empty_cache()

        # the bf16 int8 forward against the float one, B=16 x 10 s
        forwards = {}
        for config in ("default", "A"):
            qs = server(config, quantize=True)
            evaluator().calibrate(qs)
            reset_kernel_counts()
            time_forward(qs.model, iters=1)
            counts = kernel_counts()
            expect = {name: 4 * PER_FORWARD[config].get(name, 0)
                      for name, *_ in KERNELS}  # 3 warm-up + 1 timed
            if counts != expect:
                raise AssertionError(f"int8 {config} forward launched "
                                     f"{counts}, expected {expect}")
            add(counts)
            fs = sep if config == "default" else server(config)
            runs = {"float": [], "int8": []}
            for name in ("float", "int8", "int8", "float"):
                model = fs.model if name == "float" else qs.model
                runs[name].append(time_forward(model, iters=5)[0])
            forwards[config] = {k: min(v) for k, v in runs.items()}
            log(f"forward B=16 x 10 s bf16, config {config}: float "
                f"{forwards[config]['float']:.2f} ms, int8 "
                f"{forwards[config]['int8']:.2f} ms")
            if config == "default":
                shapes = int8_conv_shapes(qs.model)
            del qs, fs
            torch.cuda.empty_cache()
        out["int8_forward_ms"] = forwards
        out["int8_route"] = rows = time_int8_route(shapes)
        out["int8_route_per_forward_ms"] = totals = {
            key: sum(r["per_forward"] * r[key] for r in rows)
            for key in ("ms", "product_ms", "cudnn_bf16_ms", "bound_ms")}
        log(f"int8 route per default forward ({sum(shapes.values())} convs): "
            f"{totals['ms']:.2f} ms (products alone {totals['product_ms']:.2f}"
            f" ms), bound {totals['bound_ms']:.3f} ms; cuDNN bf16 at the same "
            f"convs {totals['cudnn_bf16_ms']:.2f} ms")
        widest = max(shapes, key=lambda s: s[0][0] * s[0][2] * s[0][3])
        out["int8_chunk_sweep_ms"] = chunk_sweep(widest)
        torch.cuda.empty_cache()

    # a long clip in windows, on the card, against the host stitch
    rng = np.random.RandomState(11)
    length = int(CHUNK_SECONDS * 16000)
    t = np.arange(length, dtype=np.float32) / 16000
    mix = (0.2 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(length)
           ).astype(np.float32)[None, None]
    cond = f32.query_encoder.get_query_embed("text", text=["a 440 hertz tone"])
    reset_kernel_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    got = f32.separate_long(mix, cond)
    chunk_s = time.perf_counter() - start
    counts = kernel_counts()
    nl, nc, nr, window = ChunkConfig().samples()
    groups = -(-(int(np.ceil((length - window) / nc)) + 1) // 16)
    if counts["apply_complex_mask_ri"] != groups or sum(counts.values()) != \
            groups:
        raise AssertionError(f"separate_long launched {counts}")
    add(counts)
    with torch.inference_mode():
        ref = chunk_inference(lambda d: f32.model(d)["waveform"],
                              torch.from_numpy(mix).cuda(), cond,
                              ChunkConfig(), 16)
    err = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    out["chunked"] = {"seconds_of_audio": CHUNK_SECONDS, "s": chunk_s,
                      "rel_err_vs_host_stitch": err}
    log(f"separate_long, {CHUNK_SECONDS:.0f} s clip float32 on the card: "
        f"{chunk_s * 1e3:.1f} ms; against the host stitch rel err {err:.3e} "
        f"(limit 1e-5)")
    if not (got.shape == (1, length) and err <= 1e-5):
        raise AssertionError("separate_long disagrees with the host stitch")
    del f32
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - phase_start
    log(f"phase 4b: {out['phase_s']:.1f} s")
    return out, launches


def reference_clips(n=16, seconds=10.0, rate=16000, seed=12):
    """n query clips: tones from 100 Hz to 4 kHz over noise."""
    import numpy as np

    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    return np.stack([0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.randn(len(t))
                     for f in np.geomspace(100.0, 4000.0, n)]
                    ).astype(np.float32)


def audio_serving(sep):
    """Phase 4c: HTSAT-base (random, seed 0) attached at 16 kHz; 16
    reference clips of 10 s through get_query_embed('audio') in float32;
    their conditions separate 16 mixtures of 10 s in bf16, default and A,
    each forward launching exactly its configuration's kernels; 'hybird'
    on a seed that picks audio and one that picks text; times with CUDA
    events. Returns (results, launches)."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from lass_torch.audio.resample import resample
    from lass_torch.dsp.mel import log_mel_spectrogram

    phase_start = time.perf_counter()
    launches = {name: 0 for name, *_ in KERNELS}
    enc = sep.query_encoder
    torch.manual_seed(0)
    enc.attach_audio_encoder(sampling_rate=16000)
    model = enc.audio_model
    clips = reference_clips()
    torch.cuda.reset_peak_memory_stats()
    conds = enc.get_query_embed("audio", audio=clips)
    peak = torch.cuda.max_memory_allocated()
    norm_dev, gap = check_embedding(conds, 16, "audio")
    log(f"audio conditions: {tuple(conds.shape)}, norms within "
        f"{norm_dev:.2e} of 1, closest two rows {gap:.3e} apart (max abs); "
        f"peak memory {peak / 2 ** 30:.2f} GiB")

    rng = np.random.RandomState(13)
    mixtures = (0.1 * rng.randn(16, 1, 160000)).astype(np.float32)
    waves = {}
    for config in ("default", "A"):
        server = sep if config == "default" else fused_server(sep, config)
        reset_kernel_counts()
        waves[config] = out = server.separate(mixtures, conds)
        counts = kernel_counts()
        expect = {name: PER_FORWARD[config].get(name, 0)
                  for name, *_ in KERNELS}
        if counts != expect:
            raise AssertionError(f"audio-queried config {config} forward "
                                 f"launched {counts}, expected {expect}")
        if out.shape != (16, 1, 160000) or not np.isfinite(out).all():
            raise AssertionError(f"bad audio-queried output ({config})")
        for name, n in counts.items():
            launches[name] += n
        del server
    ref = waves["default"].astype(np.float64)
    fused_err = float(np.linalg.norm(waves["A"] - ref) / np.linalg.norm(ref))
    log(f"audio-queried B=16 x 10 s bf16: default and A each launched their "
        f"kernels; A vs default rel err {fused_err:.3e} (limit "
        f"{BF16_FORWARD_REL})")
    if fused_err > BF16_FORWARD_REL:
        raise AssertionError("audio-queried config A disagrees with default")

    captions = [f"reference sound {i}" for i in range(16)]
    pure = {"audio": conds, "text": enc.get_query_embed("text",
                                                        text=captions)}
    hybrid = {}
    for kind, seed in HYBRID_SEEDS.items():
        got = enc.get_query_embed("hybird", audio=clips, text=captions,
                                  use_text_ratio=0.5, seed=seed)
        hybrid[kind] = (got - pure[kind]).abs().max().item()
    log(f"'hybird' at use_text_ratio 0.5 against the pure branch its seed "
        f"picks: max abs err {hybrid} (limit 1e-6)")
    if max(hybrid.values()) > 1e-6:
        raise AssertionError("'hybird' did not give its branch's embedding")

    wave = torch.from_numpy(clips).cuda()
    with torch.inference_mode():
        wave48 = resample(wave, 16000, 48000)
        parts = {
            "resample_ms": cuda_ms(lambda: resample(wave, 16000, 48000), 10),
            "log_mel_ms": cuda_ms(lambda: log_mel_spectrogram(
                wave48, model.audio_branch.cfg.mel), 10),
            "tower_ms": cuda_ms(lambda: model(wave48), 10)}
        with FlopCounterMode(display=False) as flops:
            model(wave48)
    parts["htsat_projection_ms"] = parts["tower_ms"] - parts["log_mel_ms"]
    parts["embed_ms"] = cuda_ms(
        lambda: enc.get_query_embed("audio", audio=wave), 10)
    parts["tower_gflop"] = flops.get_total_flops() / 1e9
    parts["tower_tflop_per_s"] = (parts["tower_gflop"]
                                  / parts["htsat_projection_ms"])
    log(f"audio embed B=16 x 10 s float32: {parts['embed_ms']:.3f} ms "
        f"(resample {parts['resample_ms']:.3f}, log-mel "
        f"{parts['log_mel_ms']:.3f}, HTSAT + projection "
        f"{parts['htsat_projection_ms']:.3f} = the tower "
        f"{parts['tower_ms']:.3f} minus log-mel); the tower's matmuls and "
        f"convs {parts['tower_gflop']:.1f} GFLOP (torch FlopCounterMode), "
        f"{parts['tower_tflop_per_s']:.1f} TFLOP/s over HTSAT + projection")

    one, mix1 = clips[:1], mixtures[:1]
    reset_kernel_counts()
    request_ms = cuda_ms(lambda: sep.separate(
        mix1, enc.get_query_embed("audio", audio=one)), 10)
    counts = kernel_counts()
    if counts != {name: 13 * PER_FORWARD["default"].get(name, 0)
                  for name, *_ in KERNELS}:  # 3 warm-up + 10 timed
        raise AssertionError(f"audio requests launched {counts}")
    for name, n in counts.items():
        launches[name] += n
    log(f"audio-queried request, one 10 s clip, default bf16: "
        f"{request_ms:.3f} ms median (embed + separate, copy to the host)")
    out = {"parts": parts, "request_ms": request_ms, "embed_peak_gib":
           peak / 2 ** 30, "hybrid_max_abs_err": hybrid,
           "configA_vs_default_rel_err": fused_err,
           "closest_rows_max_abs": gap,
           "phase_s": time.perf_counter() - phase_start}
    log(f"phase 4c: {out['phase_s']:.1f} s")
    return out, launches


def audio_card_vs_cpu(enc, seed=14, limit=1e-4):
    """Phase 5 for the audio tower: CLAPAudioEncoder at HTSAT-base width
    with the phase-4c weights, float32 (TF32 off), B=2 x 10 s at 48 kHz,
    on the card and on the CPU; the embedding as rel err, the log-mel as
    max abs dB (limit 1e-3 dB, the CPU tests' bound against lass_tpu)."""
    import numpy as np
    import torch

    from lass_torch.dsp.mel import log_mel_spectrogram
    from lass_torch.models.clap.model import CLAPAudioEncoder

    state = {k: v.detach().cpu()
             for k, v in enc.audio_model.state_dict().items()}
    cfg = enc.audio_model.audio_branch.cfg
    rng = np.random.RandomState(seed)
    t = np.arange(480000) / 48000
    x = torch.from_numpy(np.stack([
        0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.randn(len(t)),
        0.1 * rng.randn(len(t))]).astype(np.float32))
    embeds, mels = [], []
    for dev in ("cuda", "cpu"):
        model = CLAPAudioEncoder(cfg)
        model.load_state_dict(state)
        model.to(dev).eval()
        with torch.inference_mode():
            mels.append(log_mel_spectrogram(x.to(dev), cfg.mel).cpu())
            embeds.append(model(x.to(dev)))
    err = rel_err(*embeds)
    mel_db = (mels[0] - mels[1]).abs().max().item()
    log(f"CLAP audio tower (HTSAT-base) float32 card vs CPU, B=2 x 10 s: "
        f"rel err {err:.3e} (limit {limit}); log-mel max abs "
        f"{mel_db:.3e} dB (limit 1e-3)")
    if not (err <= limit and mel_db <= 1e-3):
        raise AssertionError("the audio tower disagrees between card and CPU")
    return {"rel_err": err, "log_mel_max_abs_db": mel_db}


def check_embedding(emb, n, what):
    """(n, 512) finite unit rows, no two alike; returns how far the norms
    are from 1 and the gap between the closest two rows (max abs)."""
    import torch

    norm_dev = (torch.linalg.vector_norm(emb, dim=-1) - 1).abs().max()
    gaps = (emb[:, None] - emb[None]).abs().amax(-1)
    gaps += torch.eye(n, device=gaps.device)
    if emb.shape != (n, 512) or not torch.isfinite(emb).all() or \
            norm_dev > 1e-5 or gaps.min() <= 1e-6:
        raise AssertionError(f"bad {what} embeddings: {tuple(emb.shape)}")
    return norm_dev.item(), gaps.min().item()


def reference_text_checkpoint(source, path, branch):
    """Save a text encoder's weights as a reference CLAP checkpoint does:
    ``module.`` keys, a logit scale the converters skip, and for BART the
    whole BartModel's ``shared.weight`` and a decoder key."""
    import torch

    sd = {f"module.{k}": v for k, v in source.state_dict().items()}
    if branch == "bart":
        sd["module.text_branch.shared.weight"] = \
            sd["module.text_branch.encoder.embed_tokens.weight"]
        sd["module.text_branch.decoder.layers.0.fc1.weight"] = torch.randn(
            3072, 768)
    sd["module.logit_scale_t"] = torch.tensor(math.log(1 / 0.07))
    torch.save({"epoch": 15, "state_dict": sd}, path)


def caption_branch(sep, branch, tmp, captions, mixtures, seed):
    """Phase 4d for one branch (see the module docstring). Returns its
    results and its launch counts."""
    import numpy as np
    import torch

    from lass_torch.convert.checkpoint_io import load_torch_ckpt
    from lass_torch.convert.torch_to_pack import convert_clap_text_encoder
    from lass_torch.convert_checkpoint import flatten
    from lass_torch.models.clap.model import (
        CLAPBartTextEncoder, CLAPBertTextEncoder)
    from lass_torch.models.query_encoder import CLAPQueryEncoder

    torch.manual_seed(seed)
    source = (CLAPBertTextEncoder() if branch == "bert"
              else CLAPBartTextEncoder()).eval()
    layers = source.text_branch.cfg.num_hidden_layers
    ckpt = os.path.join(tmp, f"clap_{branch}.pt")
    pack = os.path.join(tmp, f"clap_{branch}.npz")
    start = time.perf_counter()
    reference_text_checkpoint(source, ckpt, branch)
    params = convert_clap_text_encoder(load_torch_ckpt(ckpt), layers,
                                       model_type=branch)
    np.savez(pack, **{f"text/params/{k}": v
                      for k, v in flatten(params).items()})
    enc = CLAPQueryEncoder.from_npz(pack, tmodel=branch, device=DEVICE)
    convert_s = time.perf_counter() - start
    os.remove(ckpt)
    os.remove(pack)

    emb = enc.get_query_embed("text", text=captions)
    _, gap = check_embedding(emb, len(captions), branch)
    tok = enc.tokenizer(captions, max_length=enc.max_length,
                        pad_to=enc.pad_to)
    ids = torch.from_numpy(tok["input_ids"]).long()
    mask = torch.from_numpy(tok["attention_mask"]).long()
    with torch.inference_mode():
        want = source.to(DEVICE)(ids.to(DEVICE), mask.to(DEVICE))
        pack_err = (emb - want).abs().max().item()
        cpu_err = rel_err(emb, source.cpu()(ids, mask))
    log(f"caption branch {branch}: checkpoint -> pack -> from_npz "
        f"{convert_s:.1f} s; {tuple(emb.shape)}, closest rows {gap:.3e} "
        f"apart; pack vs source max abs {pack_err:.3e} (limit "
        f"{CAPTION_PACK_ABS}), card vs CPU rel err {cpu_err:.3e} (limit "
        f"{CAPTION_CPU_REL}); "
        f"{'fallback' if enc.using_fallback_tokenizer else 'vocab'} "
        f"tokenizer, {ids.shape[1]} tokens")
    if not (pack_err <= CAPTION_PACK_ABS and cpu_err <= CAPTION_CPU_REL):
        raise AssertionError(f"caption branch {branch} disagrees")

    reset_kernel_counts()
    waves = sep.separate(mixtures, emb)
    counts = kernel_counts()
    expect = {name: PER_FORWARD["default"].get(name, 0)
              for name, *_ in KERNELS}
    if counts != expect:
        raise AssertionError(f"{branch}-conditioned forward launched "
                             f"{counts}, expected {expect}")
    if waves.shape != mixtures.shape or not np.isfinite(waves).all():
        raise AssertionError(f"bad {branch}-conditioned output")
    caption_ms = time_captions(enc)
    log(f"caption branch {branch}: 16 x 10 s bf16 default forward launched "
        f"{counts['apply_complex_mask_ri']} B1 and nothing else; caption "
        f"encode, 16 captions: {caption_ms:.2f} ms median")
    del enc, source
    torch.cuda.empty_cache()
    return {"caption_ms": caption_ms, "pack_vs_source_max_abs": pack_err,
            "card_vs_cpu_rel_err": cpu_err, "closest_rows_max_abs": gap,
            "tokens": ids.shape[1], "convert_s": convert_s}, counts


def clap_cli_pack(tmp, seed=18):
    """``python -m lass_torch.convert_checkpoint --kind clap`` on a
    reference RoBERTa-base + HTSAT-base checkpoint (random, seeded); the
    pack's encoder (``from_npz``) against both source towers on the card."""
    import numpy as np
    import torch

    from lass_torch.models.clap.model import (
        CLAPAudioEncoder, CLAPTextEncoder)
    from lass_torch.models.query_encoder import CLAPQueryEncoder

    torch.manual_seed(seed)
    text, audio = CLAPTextEncoder().eval(), CLAPAudioEncoder().eval()
    sd = {f"module.{k}": v for k, v in {**text.state_dict(),
                                         **audio.state_dict()}.items()}
    sd.update({"module.logit_scale_a": torch.tensor(math.log(1 / 0.07)),
               "module.logit_scale_t": torch.tensor(math.log(1 / 0.07))})
    ckpt = os.path.join(tmp, "clap_roberta_htsat.pt")
    pack = os.path.join(tmp, "clap_roberta_htsat.npz")
    torch.save({"epoch": 15, "state_dict": sd}, ckpt)
    start = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "lass_torch.convert_checkpoint", "--kind",
         "clap", "--input", ckpt, "--output", pack], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - start
    if done.returncode != 0:
        raise RuntimeError(
            f"convert_checkpoint failed:\n{done.stderr[-3000:]}")
    enc = CLAPQueryEncoder.from_npz(pack, device=DEVICE)
    os.remove(ckpt)
    os.remove(pack)
    tok = enc.tokenizer([f"a recorded sound {i}" for i in range(4)],
                        max_length=enc.max_length, pad_to=enc.pad_to)
    ids = torch.from_numpy(tok["input_ids"]).long().to(DEVICE)
    mask = torch.from_numpy(tok["attention_mask"]).long().to(DEVICE)
    wave = torch.from_numpy((0.1 * np.random.RandomState(seed).randn(
        2, 480000)).astype(np.float32)).to(DEVICE)
    with torch.inference_mode():
        errs = {"text": (enc.text_model(ids, mask)
                         - text.to(DEVICE)(ids, mask)).abs().max().item(),
                "audio": (enc.audio_model(wave)
                          - audio.to(DEVICE)(wave)).abs().max().item()}
    log(f"convert_checkpoint --kind clap (RoBERTa-base + HTSAT-base, "
        f"{done.stdout.strip()}): {cli_s:.1f} s; from_npz vs the source "
        f"towers, float32 on the card: max abs {errs} (limit "
        f"{CAPTION_PACK_ABS})")
    if max(errs.values()) > CAPTION_PACK_ABS:
        raise AssertionError("the CLI's clap pack does not reproduce its "
                             "source")
    del enc, text, audio
    torch.cuda.empty_cache()
    return {"cli_s": cli_s, "pack_vs_source_max_abs": errs}


def clip_card_vs_cpu(seed=19, iters=10):
    """The CLIP-style text transformer at open_clip's width, CLIP_BATCH x 77
    tokens, float32: card against CPU, and its ms on the card."""
    import torch

    from lass_torch.models.clap.clip_text import CLIPTextTransformer

    torch.manual_seed(seed)
    model = CLIPTextTransformer().eval()
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, 49406, (CLIP_BATCH, 77), generator=gen)
    for row in range(CLIP_BATCH):  # end-of-text at 4 + 4 row, zeros after
        eot = 4 + 4 * row
        ids[row, eot], ids[row, eot + 1:] = 49407, 0
    with torch.inference_mode():
        cpu = model(ids)
        model.to(DEVICE)
        card = model(ids.to(DEVICE))
        ms = cuda_ms(lambda: model(ids.to(DEVICE)), iters)
    err = rel_err(card, cpu)
    log(f"CLIP-style text transformer (512 wide, 12 layers, 8 heads), "
        f"{CLIP_BATCH} x 77 tokens, float32: card vs CPU rel err {err:.3e} "
        f"(limit {CAPTION_CPU_REL}); {ms:.3f} ms median on the card")
    if card.shape != (CLIP_BATCH, 512) or not err <= CAPTION_CPU_REL:
        raise AssertionError("the CLIP-style transformer disagrees")
    del model
    torch.cuda.empty_cache()
    return {"card_vs_cpu_rel_err": err, "ms": ms}


def caption_branches(sep, build_dir):
    """Phase 4d: the BERT and BART caption branches from reference
    checkpoints, the clap CLI's pack, the CLIP-style transformer. Returns
    (results, launches)."""
    import numpy as np

    start = time.perf_counter()
    launches = {name: 0 for name, *_ in KERNELS}
    captions = [f"caption {i}: {w} in a {p}" for i, (w, p) in enumerate(
        (w, p) for w in ("a dog barking", "rain falling", "a car horn",
                         "birds singing") for p in ("park", "street",
                                                    "kitchen", "hall"))]
    mixtures = (0.1 * np.random.RandomState(15).randn(16, 1, 160000)
                ).astype(np.float32)
    results = {"roberta": {"caption_ms": time_captions(sep.query_encoder)}}
    log(f"caption branch roberta: caption encode, 16 captions: "
        f"{results['roberta']['caption_ms']:.2f} ms median")
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        for branch, seed in (("bert", 16), ("bart", 17)):
            results[branch], counts = caption_branch(
                sep, branch, tmp, captions, mixtures, seed)
            for name, n in counts.items():
                launches[name] += n
        results["clap_cli"] = clap_cli_pack(tmp)
    results["clip"] = clip_card_vs_cpu()
    results["phase_s"] = time.perf_counter() - start
    log(f"phase 4d: {results['phase_s']:.1f} s")
    return results, launches


def card_vs_cpu(sep, config="default", dtype="float32", batch=2, seed=5,
                limit=1e-4):
    """Phase 5: the served weights in ``config`` and ``dtype``, B x 1 s, on
    the card and on the CPU (where the wrappers run the kernels' plain
    versions). Returns the relative error."""
    import numpy as np
    import torch

    from lass_torch.models.resunet import CONFIGS, ResUNet30

    state = {k: v.detach().cpu() for k, v in sep.model.state_dict().items()}
    rng = np.random.RandomState(seed)
    mixture = torch.from_numpy((0.1 * rng.randn(batch, 1, 16000)).astype(
        np.float32))
    cond = torch.from_numpy(rng.randn(batch, 512).astype(np.float32))
    outs = []
    for dev in ("cuda", "cpu"):
        model = ResUNet30(compute_dtype=getattr(torch, dtype),
                          **CONFIGS[config])
        model.load_state_dict(state)
        model.to(dev).eval()
        with torch.inference_mode():
            outs.append(model({"mixture": mixture.to(dev),
                               "condition": cond.to(dev)})["waveform"])
    err = rel_err(*outs)
    log(f"config {config} {dtype} card vs CPU, B={batch} x 1 s: rel err "
        f"{err:.3e} (limit {limit})")
    if not err <= limit:
        raise AssertionError(f"config {config} disagrees between card and "
                             f"CPU")
    return err


def context_call(case):
    """A call beside a fused kernel's row in phase 6, never on the path and
    not the same function (so never its library call): for B3, cuDNN's
    bare bf16 conv on the pre-activated channels_last input (the concat
    materialised); for B4, the sparse route at the same shape (two B3
    launches and the residual add, y1 rounded to bf16 between them); for
    B5, cuDNN's bare bf16 conv_transpose2d on the pre-activated
    channels_last input. Returns (label, fn) or None."""
    import torch
    import torch.nn.functional as F

    from lass_torch.ops import act_conv

    cl = torch.channels_last
    if case["kernel"] == "fused_act_conv3x3":
        srcs, w, a, b = case["args"]
        x = srcs[0] if len(srcs) == 1 else torch.cat(srcs, 1)
        h = F.leaky_relu(x.float() * a[:, :, None, None]
                         + b[:, :, None, None], 0.01).to(x.dtype)
        h, wb = h.contiguous(memory_format=cl), w.to(x.dtype)
        return ("cuDNN bare conv on the pre-activated input",
                lambda: F.conv2d(h, wb, padding=1))
    if case["kernel"] == "fused_residual_conv_block":
        x, w1, w2, a1, b1, a2, b2 = case["args"]

        def sparse():
            h = act_conv.fused_act_conv3x3([x], w1, a1, b1)
            return x + act_conv.fused_act_conv3x3([h], w2, a2, b2)
        return "sparse route (two B3 launches + the add)", sparse
    if case["kernel"] == "fused_act_convT":
        x, inv, shift, beta, w = case["args"]
        dt = x.dtype
        z = F.leaky_relu(x * inv.to(dt)[None, :, None, None]
                         + shift.to(dt)[None, :, None, None]
                         + beta.to(dt)[:, :, None, None], 0.01)
        z, wb = z.contiguous(memory_format=cl), w.to(dt)
        return ("cuDNN bare conv_transpose2d on the pre-activated input",
                lambda: F.conv_transpose2d(z, wb, stride=2))
    return None


def time_fused_kernels(iters=5, reps=10):
    """Phase 6 for the fused kernels: each serving case, kernel and plain
    version in turns (plain, kernel, kernel, plain), and beside B3, B4 and
    B5 their context call (``context_call``). B6's time is its device
    time alone (``lass_torch.mask_bench.device_time``; its through-the-
    wrapper time and host time per call beside it). Returns per-case rows
    and per-kernel totals per forward (sum over its launches)."""
    import torch

    from lass_torch import mask_bench

    rows, totals = [], {}
    for case in fused_cases("cuda"):
        args = case["args"]
        runs = {"plain": [], "kernel": []}
        with torch.inference_mode():
            for name in ("plain", "kernel", "kernel", "plain"):
                fn = case["plain"] if name == "plain" else case["fn"]
                runs[name].append(cuda_ms(lambda: fn(*args), iters, 2,
                                          reps))
            context = context_call(case)
            context_ms = (None if context is None else
                          cuda_ms(context[1], iters, 2, reps))
        bytes_ms = case["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = case["ops"] / case["rate"] * 1e3
        row = {"kernel": case["kernel"], "label": case["label"],
               "launches_per_forward": case["n"],
               "ms": min(runs["kernel"]), "plain_ms": min(runs["plain"]),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": case["bytes"], "ops": case["ops"],
               "context": context and context[0], "context_ms": context_ms}
        if case["kernel"] == "apply_head_mask":
            dev = mask_bench.device_time(lambda: case["fn"](*args),
                                         mask_bench.B6_KERNEL)
            row.update(ms=dev["device_ms"], wrapper_ms=row["ms"], **{
                k: v for k, v in dev.items() if k != "wrapper_ms"})
            log(f"{row['kernel']} device time alone "
                f"({'profiler' if dev['profiler_ms'] is not None else 'graph'}"
                f"): {row['ms'] * 1e3:.1f} us, through the wrapper "
                f"{row['wrapper_ms'] * 1e3:.1f} us, host "
                f"{dev['host_us']:.1f} us a call")
        rows.append(row)
        log(f"{row['kernel']} at {row['label']} (x{case['n']} per "
            f"forward): {row['ms'] * 1e3:.1f} us, plain "
            f"{row['plain_ms'] * 1e3:.1f} us, bound {row['bound_ms'] * 1e3:.1f}"
            f" us ({row['bound_by']}: {case['bytes'] / 1e6:.1f} MB, "
            f"{case['ops'] / 1e9:.1f} G ops)"
            + ("" if context_ms is None else
               f"; {context[0]} (context, not the same function) "
               f"{context_ms * 1e3:.1f} us"))
        tot = totals.setdefault(case["kernel"], {
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
            "ops_ms": 0.0})
        for key, val in (("ms", row["ms"]), ("plain_ms", row["plain_ms"]),
                         ("bound_ms", row["bound_ms"]),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms),
                         ("context_ms", context_ms)):
            if val is not None:
                tot[key] = tot.get(key, 0.0) + case["n"] * val
        del case, args, context
    return rows, totals


def time_forward(model, b=16, seconds=10.0, iters=10):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    mixture = 0.1 * torch.randn(b, 1, int(seconds * 16000), generator=gen,
                                device="cuda")
    cond = torch.randn(b, 512, generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = cuda_ms(lambda: model({"mixture": mixture,
                                    "condition": cond}), iters)
    return ms, torch.cuda.max_memory_allocated()


def time_captions(enc, n=16, iters=10):
    import torch

    captions = [f"sound number {i} of a busy street" for i in range(n)]
    times = []
    for k in range(iters + 2):
        torch.cuda.synchronize()
        start = time.perf_counter()
        enc.embed_text_batch(captions)
        torch.cuda.synchronize()
        if k >= 2:
            times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def time_mask_kernel(b2=False, iters=10, reps=10, args=None):
    """B1 (or B2) at the serving views (or at ``args``, B1's five inputs):
    the kernel's device time alone and the wrapper's host time per call
    (``lass_torch.mask_bench.device_time``), between two timings of the
    plain version; the bound and the share."""
    from lass_torch import mask_bench
    from lass_torch.ops import masking

    args = serving_mask_inputs("cuda") if args is None else args
    if b2:
        args = (*args[:3], *mag_cos_sin(*args[3:]))
        fn, plain_fn = masking.apply_complex_mask, masking.mask_math
    else:
        fn, plain_fn = masking.apply_complex_mask_ri, masking.mask_math_from_ri
    n, t, f = args[0].shape
    plain = lambda: plain_fn(*args)  # noqa: E731
    plain_ms = [cuda_ms(plain, iters, reps=reps)]
    dev = mask_bench.device_time(lambda: fn(*args), mask_bench.B1_B2_KERNEL)
    plain_ms.append(cuda_ms(plain, iters, reps=reps))
    bound = mask_bench.mask_bound(len(args), n * t * f)
    return {"ms": dev["device_ms"], **dev, "plain_ms": min(plain_ms),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "share": bound["bound_ms"] / dev["device_ms"],
            "shape": [n, t, f]}


def mask_time_line(name, m):
    """One log line of a ``time_mask_kernel`` reading."""
    return (f"{name} at {m['shape']}: device {m['ms'] * 1e3:.1f} us "
            f"({'profiler' if m['profiler_ms'] is not None else 'graph'}; "
            f"graph {m['graph_ms'] * 1e3:.1f} us), through the wrapper "
            f"{m['wrapper_ms'] * 1e3:.1f} us, host {m['host_us']:.1f} us a "
            f"call, plain {m['plain_ms'] * 1e3:.1f} us, bound "
            f"{m['bound_ms'] * 1e3:.1f} us ({m['bound_by']}), "
            f"{100 * m['share']:.0f}% of the bound")


def time_timetap():
    """Phase 6 for B7: the microbench (lass_torch.microbench_tridiag), its
    launches counted; the kernel's time is its best t_tile without the
    activation, against the plain version and cuDNN's (3, 1) conv, which
    compute the same function. Returns (summary, microbench rows)."""
    from lass_torch import microbench_tridiag
    from lass_torch.ops import timetap_conv as tt

    tt.LAUNCHES = 0
    rows = microbench_tridiag.run()
    launches = tt.LAUNCHES
    for row in rows:
        log(f"microbench: {json.dumps(row)}")
    by_op = {}
    for row in rows:
        if not row.get("act"):
            by_op.setdefault(row["op"], []).append(row)
    best = min(by_op["timetap_conv"], key=lambda r: r["ms"])
    b, t, g, c = microbench_tridiag.SHAPE
    m = b * t * g
    bytes_ms = (2 * 2 * m * c + 2 * 3 * c * c) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * m * 3 * c * c / BF16_FLOP_PER_S * 1e3
    return {"ms": best["ms"], "t_tile": best["t_tile"],
            "plain_ms": by_op["timetap_conv_plain"][0]["ms"],
            "library_ms": by_op["cudnn_conv_3x1"][0]["ms"],
            "cudnn_dense_3x3_ms": by_op["cudnn_dense_3x3"][0]["ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "launches": launches}, rows


def bf16_train_task(sep, batch):
    """A bf16 AudioSepTask on the served weights, a generator and an
    on-card batch of ``batch`` clips of 10 s with random conditions."""
    import torch

    from lass_torch.data.mixer import SegmentMixer
    from lass_torch.models.resunet import ResUNet30
    from lass_torch.tasks.audiosep import AudioSepTask
    from lass_torch.train.optim import build_optimizer

    model = ResUNet30(compute_dtype=torch.bfloat16).cuda()
    model.load_state_dict(sep.model.state_dict())
    optimizer, scheduler = build_optimizer(
        model.parameters(), "AdamW", 1e-3, "constant_warm_up", 10000,
        1000000)
    task = AudioSepTask(model, SegmentMixer(), optimizer, scheduler)
    gen = torch.Generator(device="cuda").manual_seed(8)
    data = {"waveform": 0.1 * torch.randn(batch, 1, 160000, generator=gen,
                                          device="cuda"),
            "condition": torch.randn(batch, 512, generator=gen,
                                     device="cuda")}
    return task, gen, data


def time_hybrid_steps(sep, batch, steps=5):
    """Phase 6: the hybrid train step as the trainer runs it (the mix, the
    'hybird' condition of the mixed segments, the premixed bf16 step) at
    the phase-7 shape, host clock around synchronised steps after 2
    warm-up steps, its audio draw and its text draw (HYBRID_SEEDS) apart;
    steps/s at use_text_ratio 0.5 is two steps over their sum."""
    import torch

    task, gen, data = bf16_train_task(sep, batch)
    enc = sep.query_encoder
    captions = [f"training clip {i}" for i in range(batch)]

    def step(seed):
        mixtures, segments = task.mix(data["waveform"], gen)
        cond = enc.get_query_embed("hybird", audio=segments[:, 0],
                                   text=captions, use_text_ratio=0.5,
                                   seed=seed)
        return task.train_step_premixed({"mixture": mixtures,
                                         "segment": segments,
                                         "condition": cond.clone()})

    out = {}
    for kind, seed in HYBRID_SEEDS.items():
        for _ in range(2):
            step(seed)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(steps):
            metrics = step(seed)
        torch.cuda.synchronize()
        out[f"{kind}_step_ms"] = (time.perf_counter() - start) / steps * 1e3
        if not torch.isfinite(metrics["train_loss"]):
            raise AssertionError(f"the timed hybrid {kind} step gave a "
                                 f"non-finite loss")
    out["steps_per_s"] = 2e3 / (out["audio_step_ms"] + out["text_step_ms"])
    return out


def time_train_steps(sep, batch, steps=5):
    """Phase 6: train steps/s and peak memory of the bf16 train step at
    the phase-7 shape (``batch`` clips of 10 s), the served weights, an
    on-card batch; host clock around synchronised steps after 2 warm-up
    steps."""
    import torch

    task, gen, data = bf16_train_task(sep, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        task.train_step(data, gen)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(steps):
        metrics = task.train_step(data, gen)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - start) / steps
    if not torch.isfinite(metrics["train_loss"]):
        raise AssertionError("the timed train step gave a non-finite loss")
    return {"steps_per_s": 1 / seconds, "step_ms": seconds * 1e3,
            "clips_per_s": batch / seconds, "batch": batch,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def run_train_cli(workspace, config, resume, counts_path, max_steps=4,
                  extra=()):
    """``python -m lass_torch.train`` in a subprocess on the card; returns
    its metrics by step (the train and eval records of a step merged), its
    checkpoint steps and its kernel launches."""
    cmd = [sys.executable, "-m", "lass_torch.train", "--workspace",
           workspace, "--config_yaml", config, "--resume_checkpoint_path",
           resume, "--max_steps", str(max_steps), "--log_every", "1",
           "--launch_counts", counts_path, *extra]
    start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise RuntimeError(f"training failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    stem = os.path.splitext(os.path.basename(config))[0]
    sub = os.path.join("train", f"{stem},devices=1")
    metrics = {}
    with open(os.path.join(workspace, "tf_logs", sub, "metrics.jsonl")) as f:
        for record in map(json.loads, f):
            metrics.setdefault(record["step"], {}).update(record)
    ckpt_dir = os.path.join(workspace, "checkpoints", sub)
    steps = sorted(int(n.split(".")[0]) for n in os.listdir(ckpt_dir)
                   if n.endswith(".ckpt"))
    with open(counts_path) as f:
        counts = json.load(f)
    return metrics, steps, counts, ckpt_dir, seconds


def train(sep, build_dir):
    """Phase 7: train full-width ResUNet30 (bf16, 10 s segments, the full
    RoBERTa-base caption encoder) for 4 steps from a synthetic corpus, with
    the DCASE eval hook on TRAIN_EVAL_ROWS synthetic rows at step 4 (7c),
    resume from step 2 to step 4, then serve one 10 s request from the
    step-4 checkpoint. Returns (results, launches)."""
    import numpy as np

    from lass_torch.config import load_config
    from lass_torch.convert.checkpoint_io import load_ss_model
    from lass_torch.data.synth import (
        make_synth_corpus, make_synth_eval_set, write_train_config)

    datafile = make_synth_corpus(os.path.join(build_dir, "train_corpus"),
                                 num_clips=4 * TRAIN_BATCH + 8,
                                 seconds_min=8.0, seconds_max=14.0, seed=0)
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        config = write_train_config(
            os.path.join(root, "config.yaml"), datafile,
            batch_size=TRAIN_BATCH, segment_seconds=10, num_workers=8,
            save_step_frequency=2, compute_dtype="bfloat16",
            evaluate_step_frequency=4)
        eval_dir = os.path.join(root, "eval")
        eval_csv = make_synth_eval_set(eval_dir, num_rows=TRAIN_EVAL_ROWS,
                                       seconds=10.0)
        first = run_train_cli(os.path.join(root, "run"), config, "",
                              os.path.join(root, "counts_run.json"),
                              extra=("--eval_indexes", eval_csv,
                                     "--eval_audio_dir", eval_dir))
        metrics, steps, counts, ckpt_dir, seconds = first
        losses = [metrics[k]["train_loss"] for k in sorted(metrics)]
        evals = {k: metrics[4].get(k) for k in ("eval_SISDR", "eval_SDRi",
                                                "eval_SDR")}
        log(f"training, {TRAIN_BATCH} x 10 s per step: steps "
            f"{sorted(metrics)}, losses {losses}, checkpoints {steps}, "
            f"launches {counts}, {seconds:.1f} s; eval hook at step 4 on "
            f"{TRAIN_EVAL_ROWS} rows: {evals}")
        if sorted(metrics) != [1, 2, 3, 4] or not np.isfinite(losses).all():
            raise AssertionError(f"training metrics are wrong: {metrics}")
        if any(k != 4 and "eval_SDR" in r for k, r in metrics.items()) or \
                not all(v is not None and math.isfinite(v)
                        for v in evals.values()):
            raise AssertionError(f"the eval hook's metrics: {metrics}")
        if steps != [1, 2, 4]:
            raise AssertionError(f"checkpoints at {steps}, not [1, 2, 4]")
        expect = {name: 0 for name, *_ in KERNELS}
        # one per step's forward, and one per eval batch of 16
        expect["apply_complex_mask_ri"] = 4 + -(-TRAIN_EVAL_ROWS // 16)
        if counts != expect:
            raise AssertionError(f"training launched {counts}, expected "
                                 f"{expect}")
        resumed = run_train_cli(os.path.join(root, "resumed"), config,
                                os.path.join(ckpt_dir, "2.ckpt"),
                                os.path.join(root, "counts_resumed.json"))
        r_metrics, r_steps, r_counts, _, r_seconds = resumed
        rel = {k: abs(r_metrics[k]["train_loss"] - metrics[k]["train_loss"])
               / abs(metrics[k]["train_loss"]) for k in sorted(r_metrics)}
        log(f"resumed from step 2: steps {sorted(r_metrics)}, loss rel err "
            f"against the uninterrupted run {rel} (limit 1e-5), "
            f"checkpoints {r_steps}, launches {r_counts}, {r_seconds:.1f} s")
        expect["apply_complex_mask_ri"] = 2
        if sorted(rel) != [3, 4] or max(rel.values()) > 1e-5:
            raise AssertionError("the resumed run left the uninterrupted one")
        if r_counts != expect:
            raise AssertionError(f"resumed training launched {r_counts}")
        cfg = load_config(config)
        trained = load_ss_model(cfg, os.path.join(ckpt_dir, "4.ckpt"),
                                query_encoder=sep.query_encoder,
                                device="cuda")
        reset_kernel_counts()
        serve(trained, [SERVE_REQUESTS[0]])
        served = kernel_counts()
    launches = {name: counts[name] + r_counts[name] + served[name]
                for name, *_ in KERNELS}
    return {"losses": losses, "eval_hook": evals,
            "resumed_losses": [r_metrics[k]["train_loss"]
                               for k in sorted(r_metrics)],
            "resume_rel_err": max(rel.values()),
            "cli_steps_per_s": [metrics[k]["steps_per_sec"]
                                for k in sorted(metrics)],
            "cli_seconds": [seconds, r_seconds]}, launches


def hybrid_train(sep, build_dir):
    """Phase 7b: an in-process ``Trainer`` (the CLI cannot hand it an
    audio tower) on phase 7's corpus: full-width ResUNet30 in bf16,
    TRAIN_BATCH clips of 10 s, the phase-4c HTSAT-base at 16 kHz,
    use_text_ratio 0.5 and random_seed HYBRID_TRAIN_SEED (coins audio,
    text, audio, text), 4 steps; then a resume from step 2. Returns
    (results, launches)."""
    import numpy as np
    import torch

    from lass_torch.data.synth import make_synth_corpus, write_train_config
    from lass_torch.train.loop import Trainer

    enc = sep.query_encoder
    datafile = make_synth_corpus(os.path.join(build_dir, "train_corpus"),
                                 num_clips=4 * TRAIN_BATCH + 8,
                                 seconds_min=8.0, seconds_max=14.0, seed=0)
    calls = []
    hook = enc.audio_model.register_forward_hook(lambda *_: calls.append(1))
    runs, launches = {}, {name: 0 for name, *_ in KERNELS}
    try:
        with tempfile.TemporaryDirectory(dir=build_dir) as root:
            config = write_train_config(
                os.path.join(root, "config.yaml"), datafile,
                batch_size=TRAIN_BATCH, segment_seconds=10, num_workers=8,
                save_step_frequency=2, compute_dtype="bfloat16",
                use_text_ratio=0.5, random_seed=HYBRID_TRAIN_SEED)
            resume = None
            for name in ("run", "resumed"):
                before = len(calls)
                reset_kernel_counts()
                trainer = Trainer(config, os.path.join(root, name),
                                  resume_checkpoint_path=resume,
                                  query_encoder=enc, device="cuda",
                                  log_every=1)
                start = time.perf_counter()
                trainer.fit(max_steps=4)
                seconds = time.perf_counter() - start
                with open(os.path.join(trainer.tf_logs_dir,
                                       "metrics.jsonl")) as f:
                    metrics = {r["step"]: r for r in map(json.loads, f)}
                runs[name] = dict(metrics=metrics, counts=kernel_counts(),
                                  audio_calls=len(calls) - before,
                                  seconds=seconds, timing=dict(trainer.timing))
                for k, n in runs[name]["counts"].items():
                    launches[k] += n
                resume = trainer.ckpt.path(2)
                del trainer
                torch.cuda.empty_cache()
    finally:
        hook.remove()
    first, again = runs["run"], runs["resumed"]
    losses = [first["metrics"][k]["train_loss"] for k in sorted(first["metrics"])]
    rel = {k: abs(again["metrics"][k]["train_loss"]
                  - first["metrics"][k]["train_loss"])
           / abs(first["metrics"][k]["train_loss"])
           for k in sorted(again["metrics"])}
    sps = [first["metrics"][k]["steps_per_sec"] for k in (2, 3, 4)]
    log(f"hybrid training, {TRAIN_BATCH} x 10 s per step, use_text_ratio "
        f"0.5: losses {losses}, audio-tower calls {first['audio_calls']} "
        f"(steps 1 and 3), launches {first['counts']}, steps/s over steps "
        f"2-4 {sps}, {first['seconds']:.1f} s; resumed from step 2: loss "
        f"rel err {rel} (limit 1e-5), audio-tower calls "
        f"{again['audio_calls']}, launches {again['counts']}")
    if sorted(first["metrics"]) != [1, 2, 3, 4] or \
            not np.isfinite(losses).all():
        raise AssertionError(f"hybrid training metrics: {first['metrics']}")
    if first["audio_calls"] != 2 or again["audio_calls"] != 1:
        raise AssertionError("the hybrid coins did not pick audio at steps "
                             "1 and 3")
    for run, steps in ((first, 4), (again, 2)):
        expect = {name: 0 for name, *_ in KERNELS}
        expect["apply_complex_mask_ri"] = steps  # one per step's forward
        if run["counts"] != expect:
            raise AssertionError(f"hybrid training launched {run['counts']}")
    if sorted(rel) != [3, 4] or max(rel.values()) > 1e-5:
        raise AssertionError("the resumed hybrid run left the first one")
    return {"losses": losses, "resume_rel_err": max(rel.values()),
            "steps_per_s": sps, "median_steps_per_s": statistics.median(sps),
            "seconds": [first["seconds"], again["seconds"]],
            "timing": first["timing"],
            "audio_calls": [first["audio_calls"], again["audio_calls"]]}, \
        launches


def train_step_card_vs_cpu(sep, batch=2, seed=7):
    """Phase 8: one float32 ``train_step_premixed`` (TF32 off) from the
    served weights and one batch on the card and on the CPU; the loss
    within 1e-5 relative, the grads and the updated BN running statistics
    (each as one vector) within 1e-4 relative."""
    import numpy as np
    import torch

    from lass_torch.data.mixer import SegmentMixer
    from lass_torch.models.resunet import ResUNet30
    from lass_torch.tasks.audiosep import AudioSepTask
    from lass_torch.train.optim import build_optimizer

    state = {k: v.detach().cpu() for k, v in sep.model.state_dict().items()}
    rng = np.random.RandomState(seed)
    seg = (0.1 * rng.randn(batch, 1, 16000)).astype(np.float32)
    data = {"segment": seg,
            "mixture": seg + (0.1 * rng.randn(batch, 1, 16000)).astype(
                np.float32),
            "condition": rng.randn(batch, 512).astype(np.float32)}
    out = {}
    for dev in ("cuda", "cpu"):
        model = ResUNet30(compute_dtype=torch.float32)
        model.load_state_dict(state)
        model.to(dev)
        optimizer, scheduler = build_optimizer(
            model.parameters(), "AdamW", 1e-3, "constant_warm_up", 10000,
            1000000)
        task = AudioSepTask(model, SegmentMixer(), optimizer, scheduler)
        metrics = task.train_step_premixed(
            {k: torch.from_numpy(v).to(dev) for k, v in data.items()})
        out[dev] = (float(metrics["train_loss"]), torch.cat(
            [p.grad.detach().double().cpu().ravel()
             for p in model.parameters()]), torch.cat(
            [b.detach().double().cpu().ravel()
             for n, b in model.named_buffers() if "running" in n]))
    (loss_c, grads_c, stats_c), (loss, grads, stats) = out["cuda"], out["cpu"]
    errs = {"loss": abs(loss_c - loss) / abs(loss),
            "grads": ((grads_c - grads).norm() / grads.norm()).item(),
            "bn_stats": ((stats_c - stats).norm() / stats.norm()).item()}
    log(f"float32 train step card vs CPU, B={batch} x 1 s: rel err {errs} "
        f"(limits loss 1e-5, grads and BN stats 1e-4)")
    if errs["loss"] > 1e-5 or errs["grads"] > 1e-4 or errs["bn_stats"] > 1e-4:
        raise AssertionError("the train step disagrees between card and CPU")
    return errs


def variant_batch(store, index, wins, device):
    """File ``index`` of a precomputed store on ``device`` (the CLI's
    ``to_device``) with its raw texts."""
    from lass_torch.train_multistft import to_device

    raw = store.batch_at(index)
    return raw, to_device(raw, wins, device)


def precompute_on_card(root, config, dataset):
    """Phase 9a: recipes in process, ``python -m lass_torch.precompute_stfts
    --mode compute_stfts`` on the card (VARIANT_FILES files), the stored
    segment STFT against a fresh one on the card, the device part (mix +
    STFT bank, CUDA events) and the host part (copy to the host + npz
    write) timed apart, and the load of one stored file."""
    import numpy as np
    import torch

    from lass_torch.data.precompute import (
        batch_payload, generate_recipes, process_batch, save_recipes)
    from lass_torch.data.precomputed import PrecomputedSTFTDataset
    from lass_torch.dsp.stft import STFTConfig, wav_to_spectrogram_phase

    recipes = generate_recipes(dataset, VARIANT_BATCH, 2, -10, 10)
    rpath = os.path.join(root, "recipes.json")
    save_recipes(recipes, rpath)
    out_dir = os.path.join(root, "stfts")
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lass_torch.precompute_stfts", "--mode",
         "compute_stfts", "--config_yaml", config, "--recipes", rpath,
         "--output_dir", out_dir, "--batch_size", str(VARIANT_BATCH)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - start
    if proc.returncode != 0:
        raise RuntimeError(f"precompute failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    files = sorted(f for f in os.listdir(out_dir) if f.endswith(".npz"))
    if files != [f"batch_{i:06d}.npz" for i in range(VARIANT_FILES)]:
        raise AssertionError(f"the precompute wrote {files}")
    store = PrecomputedSTFTDataset(out_dir)
    batch = store.batch_at(0)
    target = torch.from_numpy(batch["target_waveform"]).cuda()
    worst = 0.0
    for win in VARIANT_WINS:
        fresh = wav_to_spectrogram_phase(target, STFTConfig(n_fft=win))
        stored = [torch.from_numpy(a).cuda()
                  for a in batch["stfts"]["segment"][win]]
        scale = stored[0].abs().max().item()
        loud = stored[0] > 1e-3 * scale
        errs = [(fresh[0] - stored[0]).abs().max().item() / scale] + [
            (f - s)[loud].abs().max().item() for f, s in zip(fresh[1:],
                                                             stored[1:])]
        worst = max(worst, *errs)
    log(f"precompute CLI: {len(files)} files of {VARIANT_BATCH} x 10 s, "
        f"windows {VARIANT_WINS}, {cli_s:.1f} s; stored segment STFT vs a "
        f"fresh one on the card: {worst:.3e} (mag rel to its peak, cos and "
        f"sin abs where mag > 1e-3 of the peak; limit 1e-5)")
    if not worst <= 1e-5:
        raise AssertionError("the stored segment STFT is not the target's")

    # the device part at the stored batch's shape: random audio of the
    # same size, one partner per item
    gen = torch.Generator(device="cuda").manual_seed(20)
    n = batch["target_waveform"].shape[-1]
    seg = 0.1 * torch.randn(VARIANT_BATCH, n, generator=gen, device="cuda")
    partners = 0.1 * torch.randn(VARIANT_BATCH, 1, n, generator=gen,
                                 device="cuda")
    gains = torch.full((VARIANT_BATCH, 1), 3.0, device="cuda")
    ngains = torch.full((VARIANT_BATCH,), -2.0, device="cuda")
    masks = torch.ones(VARIANT_BATCH, 1, device="cuda")
    call = lambda: process_batch(seg, partners, gains, ngains, masks,  # noqa
                                 VARIANT_WINS)
    device_ms = cuda_ms(call, 10)
    _, out_seg, mix_stfts, seg_stfts = call()
    torch.cuda.synchronize()
    write_s = []
    for k in range(2):
        start = time.perf_counter()
        payload = batch_payload(batch["text"], batch[
            "mixture_component_texts"], out_seg, mix_stfts, seg_stfts,
            VARIANT_WINS, 160)
        copy_s = time.perf_counter() - start
        np.savez(os.path.join(root, "timed.npz"), **payload)
        write_s.append((copy_s, time.perf_counter() - start - copy_s))
    file_mb = os.path.getsize(os.path.join(out_dir, files[0])) / 1e6
    load_s = []
    for k in range(VARIANT_FILES):  # a new store: each load misses its cache
        start = time.perf_counter()
        PrecomputedSTFTDataset(out_dir).batch_at(k)
        load_s.append(time.perf_counter() - start)
    out = {"cli_s": cli_s, "device_ms": device_ms,
           "host_copy_s": statistics.median(c for c, _ in write_s),
           "npz_write_s": statistics.median(w for _, w in write_s),
           "file_mb": file_mb, "load_s": statistics.median(load_s),
           "stored_vs_fresh": worst}
    log(f"precompute per batch of {VARIANT_BATCH} x 10 s: device (mix + "
        f"STFT bank of both roles) {device_ms:.3f} ms; copy to the host "
        f"{out['host_copy_s'] * 1e3:.1f} ms, npz write "
        f"{out['npz_write_s'] * 1e3:.1f} ms ({file_mb:.1f} MB); one stored "
        f"file loaded by batch_at {out['load_s'] * 1e3:.1f} ms (median over "
        f"the {VARIANT_FILES} files, page cache warm)")
    return store, out


def variant_forward(store, encoder):
    """Phase 9b: MultiSTFTResUNet30 (VARIANT_WINS, bf16, seed 0) in eval on
    the first stored file; the forward launches exactly one B1 and no
    other kernel; B1 against its plain version at the inputs this forward
    hands it (the logits' channel views and the rebuilt 512 spectrum,
    cropped to 256 bins, rows 257 floats apart); the forward's and B1's
    times. Returns (model, results, launches)."""
    import torch

    from lass_torch.models.resunet import mask_inputs
    from lass_torch.models.resunet_multistft import (
        RECON_WIN, MultiSTFTResUNet30)
    from lass_torch.ops import masking

    torch.manual_seed(0)
    model = MultiSTFTResUNet30(win_lengths=VARIANT_WINS,
                               compute_dtype=torch.bfloat16).cuda().eval()
    raw, batch = variant_batch(store, 0, VARIANT_WINS, "cuda")
    length = raw["target_waveform"].shape[-1]
    inputs = {f"stft_mixture_{part}": {w: batch["stfts"]["mixture"][w][i]
                                       for w in VARIANT_WINS}
              for i, part in enumerate(("mag", "cos", "sin"))}
    inputs["condition"] = encoder.get_query_embed(
        "text", text=raw["text"])
    captured = {}
    hook = model.after_conv.register_forward_hook(
        lambda mod, args, out: captured.update(logits=out))
    reset_kernel_counts()
    with torch.inference_mode():
        wave = model(inputs, length)["waveform"]
    torch.cuda.synchronize()
    counts = kernel_counts()
    hook.remove()
    expect = {name: 0 for name, *_ in KERNELS}
    expect["apply_complex_mask_ri"] = 1
    log(f"multistft forward {VARIANT_BATCH} x 10 s bf16, windows "
        f"{VARIANT_WINS}: output {tuple(wave.shape)}, launches {counts}")
    if counts != expect:
        raise AssertionError(f"the multistft forward launched {counts}")
    if tuple(wave.shape) != (VARIANT_BATCH, 1, length) or not bool(
            torch.isfinite(wave).all()):
        raise AssertionError("the multistft forward's output is wrong")

    # B1 at this path's inputs
    t = inputs["stft_mixture_mag"][RECON_WIN].shape[1]
    mag = inputs["stft_mixture_mag"][RECON_WIN].permute(0, 3, 1, 2)
    real_in = mag * inputs["stft_mixture_cos"][RECON_WIN].permute(0, 3, 1, 2)
    imag_in = mag * inputs["stft_mixture_sin"][RECON_WIN].permute(0, 3, 1, 2)
    args = mask_inputs(captured["logits"][:, :, :t], real_in, imag_in, 1)
    with torch.inference_mode():
        got = masking.apply_complex_mask_ri(*args)
        torch.cuda.synchronize()
        ref = masking.mask_math_from_ri(*args)
    err = max_err(got, ref)
    scale = max(1.0, max(r.abs().max().item() for r in ref))
    log(f"mask kernel vs plain at the multistft shape "
        f"{tuple(args[0].shape)}, spectrum row stride "
        f"{args[3].stride(1)}: max abs err {err:.3e} (limit "
        f"{1e-5 * scale:.3e})")
    if not err <= 1e-5 * scale:
        raise AssertionError("the mask kernel disagrees at the multistft "
                             "shape")
    b1 = time_mask_kernel(args=args)
    b1["max_abs_err"] = err
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(inputs, length), 10)
    log(mask_time_line("apply_complex_mask_ri (multistft)", b1)
        + f"; eval forward {fwd_ms:.2f} ms median, "
        f"{VARIANT_BATCH / (fwd_ms / 1e3):.1f} clips/s")
    return model, {"b1": b1, "forward_ms": fwd_ms}, counts


def variant_card_vs_cpu(model, store, encoder, limit=1e-4):
    """Phase 9b: the forward's weights in float32 (TF32 off), the first
    VARIANT_CPU_BATCH items of the first file, on the card and on the CPU
    (where B1's plain version runs)."""
    import torch

    from lass_torch.models.resunet_multistft import MultiSTFTResUNet30

    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    raw = store.batch_at(0)
    k = VARIANT_CPU_BATCH
    length = raw["target_waveform"].shape[-1]
    cond = encoder.get_query_embed("text", text=raw["text"][:k]).cpu()
    outs = []
    for dev in ("cuda", "cpu"):
        m = MultiSTFTResUNet30(win_lengths=VARIANT_WINS)
        m.load_state_dict(state)
        m.to(dev).eval()
        inputs = {f"stft_mixture_{part}": {
            w: torch.from_numpy(raw["stfts"]["mixture"][w][i][:k]).to(dev)
            for w in VARIANT_WINS}
            for i, part in enumerate(("mag", "cos", "sin"))}
        inputs["condition"] = cond.to(dev)
        with torch.inference_mode():
            outs.append(m(inputs, length)["waveform"].cpu().double())
    err = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
    log(f"multistft float32 card vs CPU, B={k} x 10 s: rel err {err:.3e} "
        f"(limit {limit})")
    if not err <= limit:
        raise AssertionError("the multistft forward disagrees between card "
                             "and CPU")
    return err


def run_variant_cli(workspace, config, store_dir, variant, counts_path):
    """``python -m lass_torch.train_multistft`` in a subprocess on the card
    for VARIANT_STEPS steps; returns its metrics by step, checkpoint steps,
    launches, checkpoint directory and seconds."""
    cmd = [sys.executable, "-m", "lass_torch.train_multistft",
           "--workspace", workspace, "--config_yaml", config,
           "--precomputed_dir", store_dir, "--variant", variant,
           "--max_steps", str(VARIANT_STEPS), "--log_every", "1",
           "--launch_counts", counts_path]
    start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - start
    if proc.returncode != 0 or f"finished at step {VARIANT_STEPS}" not in \
            proc.stdout:
        raise RuntimeError(f"{variant} training failed ({proc.returncode})"
                           f":\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    stem = os.path.splitext(os.path.basename(config))[0]
    sub = os.path.join("train_multistft", f"{stem},devices=1")
    with open(os.path.join(workspace, "tf_logs", sub, "metrics.jsonl")) as f:
        metrics = {r["step"]: r for r in map(json.loads, f)}
    ckpt_dir = os.path.join(workspace, "checkpoints", sub)
    steps = sorted(int(n.split(".")[0]) for n in os.listdir(ckpt_dir)
                   if n.endswith(".ckpt"))
    with open(counts_path) as f:
        counts = json.load(f)
    return metrics, steps, counts, ckpt_dir, seconds


def variant_training(root, config, store, variant, encoder):
    """Phase 9c and 9d for one variant: the CLI's VARIANT_STEPS steps
    (finite losses, checkpoints 1, 2 and 4, one B1 launch per step); in
    process, the task restored from the step-2 checkpoint repeats the
    step-3 loss on the step-3 file, then one val step (``encoder``: the
    CLI's caption encoder, built as it builds it); the device train step
    timed at the stored batch. Returns (results, launches)."""
    import numpy as np
    import torch

    from lass_torch.config import load_config
    from lass_torch.train.checkpoint import restore_file
    from lass_torch.train_multistft import build_task, condition

    metrics, steps, counts, ckpt_dir, seconds = run_variant_cli(
        os.path.join(root, f"ws_{variant}"), config,
        os.path.dirname(store.paths[0]), variant,
        os.path.join(root, f"{variant}.json"))
    losses = [metrics[k]["train_loss"] for k in sorted(metrics)]
    log(f"{variant} CLI, {VARIANT_BATCH} x 10 s per step: steps "
        f"{sorted(metrics)}, losses {losses}, checkpoints {steps}, "
        f"launches {counts}, {seconds:.1f} s")
    if sorted(metrics) != list(range(1, VARIANT_STEPS + 1)) or \
            not np.isfinite(losses).all():
        raise AssertionError(f"{variant} training metrics: {metrics}")
    if steps != [1, 2, 4]:
        raise AssertionError(f"{variant} checkpoints at {steps}")
    expect = {name: 0 for name, *_ in KERNELS}
    expect["apply_complex_mask_ri"] = VARIANT_STEPS
    if counts != expect:
        raise AssertionError(f"{variant} training launched {counts}")

    # the CLI's task, rebuilt as it builds it
    cfg = load_config(config)
    wins = VARIANT_WINS if variant == "multistft" else (512,)
    task = build_task(cfg, variant, wins, "cuda")
    reset_kernel_counts()
    restore_file(os.path.join(ckpt_dir, "2.ckpt"), task)
    raw, batch = variant_batch(store, 2 % VARIANT_FILES, wins, "cuda")
    cond = condition(encoder, raw, variant)
    loss3 = float(task.train_step(batch, cond)["train_loss"])
    val = float(task.val_step(batch, cond))
    torch.cuda.synchronize()
    launches = kernel_counts()
    rel = abs(loss3 - metrics[3]["train_loss"]) / abs(
        metrics[3]["train_loss"])
    log(f"{variant} restored at step 2: step-3 loss {loss3} against the "
        f"CLI's {metrics[3]['train_loss']}, rel err {rel:.3e} (limit 0); "
        f"val loss {val}; launches {launches}")
    if rel != 0.0 or not math.isfinite(val):
        raise AssertionError(f"the restored {variant} task left the CLI's "
                             f"run")
    if launches["apply_complex_mask_ri"] != 2 or sum(launches.values()) != 2:
        raise AssertionError(f"the restored {variant} steps launched "
                             f"{launches}")
    for name, n in counts.items():
        launches[name] += n

    # the device step at the stored batch (the step-3 file), timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        task.train_step(batch, cond)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(5):
        m = task.train_step(batch, cond)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) / 5 * 1e3
    if not torch.isfinite(m["train_loss"]):
        raise AssertionError(f"the timed {variant} step is not finite")
    cli_sps = [metrics[k]["steps_per_sec"] for k in sorted(metrics)]
    load = [metrics[k]["load_s"] for k in sorted(metrics)]
    out = {"losses": losses, "resume_rel_err": rel, "val_loss": val,
           "step_ms": step_ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "cli_steps_per_s": cli_sps, "cli_load_s": load,
           "cli_seconds": seconds}
    log(f"{variant} train step bf16, {VARIANT_BATCH} x 10 s, batch on the "
        f"card: {step_ms:.1f} ms, {1e3 / step_ms:.2f} steps/s, peak "
        f"{out['peak_gib']:.2f} GiB; the CLI's own steps/s by step "
        f"{[round(x, 3) for x in cli_sps]}, its file loads "
        f"{[round(x, 3) for x in load]} s")
    del task
    torch.cuda.empty_cache()
    return out, launches


def variants(sep, build_dir):
    """Phase 9: the precomputed-STFT variants at full width (module
    docstring). Returns (results, launches)."""
    import torch

    from lass_torch.config import load_config
    from lass_torch.data.datafiles import AudioTextDataset
    from lass_torch.data.synth import make_synth_corpus, write_train_config
    from lass_torch.train_multistft import caption_encoder

    start = time.perf_counter()
    seconds = {}
    datafile = make_synth_corpus(os.path.join(build_dir, "variant_corpus"),
                                 num_clips=VARIANT_FILES * VARIANT_BATCH,
                                 seconds_min=10.0, seconds_max=12.0, seed=1)
    results, launches = {}, {name: 0 for name, *_ in KERNELS}
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        config = write_train_config(
            os.path.join(root, "config.yaml"), datafile,
            batch_size=VARIANT_BATCH, segment_seconds=10, num_workers=8,
            save_step_frequency=2, compute_dtype="bfloat16")
        dataset = AudioTextDataset([datafile], sampling_rate=16000,
                                   max_clip_len=10)
        seconds["corpus"] = time.perf_counter() - start
        store, results["precompute"] = precompute_on_card(root, config,
                                                          dataset)
        seconds["precompute"] = time.perf_counter() - start - sum(
            seconds.values())
        model, fwd, counts = variant_forward(store, sep.query_encoder)
        results.update(fwd)
        for name, n in counts.items():
            launches[name] += n
        seconds["forward"] = time.perf_counter() - start - sum(
            seconds.values())
        results["card_vs_cpu_rel_err"] = variant_card_vs_cpu(
            model, store, sep.query_encoder)
        del model
        torch.cuda.empty_cache()
        seconds["card_vs_cpu"] = time.perf_counter() - start - sum(
            seconds.values())
        encoder = caption_encoder(load_config(config), "cuda")
        for variant in ("multistft", "negquery"):
            results[variant], counts = variant_training(
                root, config, store, variant, encoder)
            for name, n in counts.items():
                launches[name] += n
            seconds[variant] = time.perf_counter() - start - sum(
                seconds.values())
    results["phase_s"] = time.perf_counter() - start
    results["seconds"] = seconds
    log(f"phase 9: {results['phase_s']:.1f} s "
        f"({', '.join(f'{k} {v:.1f}' for k, v in seconds.items())})")
    return results, launches


def clap_args(amodel="HTSAT-base", *extra):
    """``python -m lass_torch.clap_pretrain``'s arguments (its defaults,
    then ``extra``)."""
    from lass_torch.clap_pretrain import parser

    return parser().parse_args(["--workspace", "-", "--train_shards", "-",
                                "--amodel", amodel, *extra])


def clap_batch(batch, device, seed):
    """``batch`` clips of 10 s at 48 kHz and captions padded to
    CLAP_TEXT_LEN tokens (the whitespace tokenizer), on ``device``."""
    import torch

    from lass_torch.models.clap.tokenizer import WhitespaceFallbackTokenizer

    gen = torch.Generator().manual_seed(seed)
    texts = [f"a synthetic sound number {i} of a tone over filtered noise"
             for i in range(batch)]
    tok = WhitespaceFallbackTokenizer(50265)(texts, max_length=CLAP_TEXT_LEN,
                                             pad_to=CLAP_TEXT_LEN)
    return {"waveform": (0.1 * torch.randn(batch, 480000, generator=gen)
                         ).to(device),
            "input_ids": torch.from_numpy(tok["input_ids"]).long().to(device),
            "attention_mask": torch.from_numpy(
                tok["attention_mask"]).long().to(device)}


def no_launches(counts, what):
    if any(counts.values()):
        raise AssertionError(f"{what} launched a kernel: {counts}")


def time_clap_step(amodel, steps=5):
    """Phase 10: the float32 contrastive step at CLAP_BATCH x 10 s, host
    clock over ``steps`` synchronised steps after 2 warm-up, peak memory,
    its GFLOP by torch's FlopCounterMode on one more step; every loss
    finite and both scales at most 100 after every step; no kernel of
    B1-B7 launched."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from lass_torch.clap_pretrain import build_task

    task = build_task(clap_args(amodel), DEVICE)
    data = clap_batch(CLAP_BATCH, DEVICE, seed=20)
    reset_kernel_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    record = []

    def step():
        m = task.train_step(data)
        record.append(torch.stack([m["contrastive_loss"], m["logit_scale_a"],
                                   m["logit_scale_t"]]))

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - start) / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with FlopCounterMode(display=False) as flops:
        step()
    no_launches(kernel_counts(), f"the {amodel} train step")
    rows = torch.stack(record).double().cpu().numpy()
    if not np.isfinite(rows[:, 0]).all():
        raise AssertionError(f"{amodel}: non-finite loss {rows[:, 0]}")
    if rows[:, 1:].max() > 100.0 * (1 + 1e-6):
        raise AssertionError(f"{amodel}: a logit scale above 100: {rows}")
    out = {"step_ms": seconds * 1e3, "steps_per_s": 1 / seconds,
           "clips_per_s": CLAP_BATCH / seconds, "peak_gib": peak,
           "gflop": flops.get_total_flops() / 1e9,
           "tflop_per_s": flops.get_total_flops() / seconds / 1e12,
           "losses": rows[:, 0].tolist(),
           "max_logit_scale": float(rows[:, 1:].max()),
           "params_m": sum(p.numel() for p in task.parameters()) / 1e6,
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32}}
    log(f"CLAP {amodel} + RoBERTa-base train step, float32, {CLAP_BATCH} x "
        f"10 s, captions of {CLAP_TEXT_LEN} tokens: {out['step_ms']:.1f} ms "
        f"({out['steps_per_s']:.2f} steps/s, {out['clips_per_s']:.1f} "
        f"clips/s), peak {peak:.2f} GiB, {out['gflop']:.0f} GFLOP a step "
        f"({out['tflop_per_s']:.1f} TFLOP/s), {out['params_m']:.1f} M "
        f"params, TF32 {out['tf32']}; losses {out['losses']}, largest scale "
        f"{out['max_logit_scale']:.4f}")
    del task, data
    torch.cuda.empty_cache()
    return out


def clap_card_vs_cpu(seed=21, limit=1e-4):
    """Phase 10: one float32 contrastive step (TF32 off), HTSAT-base +
    RoBERTa-base, from the same weights, batch (CLAP_CPU_BATCH x 10 s) and
    spec-augment stripes (drawn on the host from the step's generator) on
    the card and on the CPU: the loss within 1e-5 relative; the grads, the
    updated parameters and the updated BN running statistics, each as one
    vector, within ``limit``. The CLI's defaults with ``--warmup 1 --wd
    10``: under the default warm-up the first update is lr / 3200 and moves
    the parameters by about 1e-6 of their norm, so a wrong AdamW step would
    pass; here the step (the CPU's, measured) must move them by at least
    10 x ``limit``, and the decay alone moves every parameter by lr x wd =
    1e-3 of itself."""
    import torch

    from lass_torch.clap_pretrain import build_task

    args = clap_args("HTSAT-base", "--warmup", "1", "--wd", "10")
    out = {}
    state = None
    for dev in ("cpu", DEVICE):
        task = build_task(args, dev)
        if state is None:
            state = {k: v.clone() for k, v in task.state_dict().items()}
        else:
            task.load_state_dict(state)
        m = task.train_step(clap_batch(CLAP_CPU_BATCH, dev, seed))
        sd = task.state_dict()
        out[dev] = (float(m["contrastive_loss"]), torch.cat(
            [p.grad.detach().double().cpu().ravel()
             for p in task.parameters()]), torch.cat(
            [sd[k].double().cpu().ravel() for k in sorted(sd)
             if "running_" not in k and "num_batches" not in k]),
            torch.cat([sd[k].double().cpu().ravel() for k in sorted(sd)
                       if "running_" in k]))
        del task
    (loss, *cpu), (loss_c, *card) = out["cpu"], out[DEVICE]
    errs = {"loss": abs(loss_c - loss) / abs(loss)}
    for name, a, b in zip(("grads", "params", "bn_stats"), card, cpu):
        errs[name] = ((a - b).norm() / b.norm()).item()
    before = torch.cat([state[k].double().ravel() for k in sorted(state)
                        if "running_" not in k and "num_batches" not in k])
    errs["step_size"] = ((cpu[1] - before).norm() / before.norm()).item()
    log(f"CLAP float32 train step card vs CPU, HTSAT-base + RoBERTa-base, "
        f"B={CLAP_CPU_BATCH} x 10 s, same stripes, lr {args.lr}, warm-up "
        f"{args.warmup}, wd {args.wd}: rel err {errs} (limits loss 1e-5, "
        f"the others {limit}; step_size, the CPU step's move of the "
        f"parameters, at least {10 * limit})")
    if errs["step_size"] < 10 * limit:
        raise AssertionError("the CLAP step moves the parameters too little "
                             "for the card-vs-CPU check to see it")
    if errs["loss"] > 1e-5 or max(errs["grads"], errs["params"],
                                  errs["bn_stats"]) > limit:
        raise AssertionError("the CLAP step disagrees between card and CPU")
    torch.cuda.empty_cache()
    return errs


def run_clap_cli(module, argv, workspace, counts_path):
    """``python -m lass_torch.<module>`` on the card in a subprocess;
    returns its metrics by step, checkpoint steps, kernel launches, stdout
    and seconds."""
    cmd = [sys.executable, "-m", f"lass_torch.{module}", "--workspace",
           workspace, *argv, "--log_every", "1", "--launch_counts",
           counts_path, "--device", DEVICE]
    start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise RuntimeError(f"{module} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    sub = os.path.join(module, f"{module},devices=1")
    metrics = {}
    with open(os.path.join(workspace, "tf_logs", sub, "metrics.jsonl")) as f:
        for record in map(json.loads, f):
            metrics.setdefault(record["step"], {}).update(record)
    ckpt_dir = os.path.join(workspace, "checkpoints", sub)
    steps = sorted(int(n.split(".")[0]) for n in os.listdir(ckpt_dir)
                   if n.endswith(".ckpt"))
    with open(counts_path) as f:
        counts = json.load(f)
    no_launches(counts, module)
    return metrics, steps, ckpt_dir, proc.stdout, seconds


def cli_rates(metrics):
    """The CLI's own steps/s and its load and decode seconds per step."""
    steps = sorted(k for k in metrics if "steps_per_sec" in metrics[k])
    return {"steps_per_s": [metrics[k]["steps_per_sec"] for k in steps],
            "load_s": [metrics[k]["load_s"] for k in steps],
            "decode_s": [metrics[k].get("decode_s", 0.0) for k in steps]}


def clap_resume_and_zero_shot(argv, ckpt_dir, metrics, val_datafile):
    """Phase 10: in process, the task restored from the CLI's step-2
    checkpoint repeats its step-3 loss exactly on the step-3 batch (one
    reader, so the shard order is the CLI's); then the step-4 state
    classifies the val clips zero-shot (their captions as the classes, one
    template), held against the same embeddings' top-k in float64."""
    import numpy as np
    import torch

    from lass_torch.clap_pretrain import (
        SAMPLE_RATE, build_task, make_tokenizer, parser, shard_batches,
        to_device)
    from lass_torch.data.datafiles import AudioTextDataset
    from lass_torch.evaluation.zero_shot import (
        zero_shot_classifier, zero_shot_run)
    from lass_torch.train.checkpoint import restore_file

    args = parser().parse_args(["--workspace", "-", *argv])
    task = build_task(args, DEVICE)
    restore_file(os.path.join(ckpt_dir, "2.ckpt"), task)
    batches = shard_batches(args, int(SAMPLE_RATE * args.clip_seconds),
                            {"decode_s": 0.0})
    for _ in range(3):
        wave, texts = next(batches)
    tokenizer = make_tokenizer()
    reset_kernel_counts()
    loss = float(task.train_step(to_device(
        wave, texts, tokenizer, args.max_text_len, DEVICE))[
        "contrastive_loss"])
    if loss != metrics[3]["contrastive_loss"]:
        raise AssertionError(f"restored step 3: loss {loss}, the CLI's "
                             f"{metrics[3]['contrastive_loss']}")

    restore_file(os.path.join(ckpt_dir, f"{CLAP_CLI_STEPS}.ckpt"), task)
    val = AudioTextDataset([val_datafile], sampling_rate=SAMPLE_RATE,
                           max_clip_len=args.clip_seconds)
    items = [val[i] for i in range(len(val))]
    captions = [it["text"] for it in items]
    waves = np.stack([it["waveform"][0] for it in items])

    def embed_texts(texts):
        data = to_device(np.zeros((len(texts), 1), np.float32), texts,
                         tokenizer, args.max_text_len, DEVICE)
        task.text_encoder.eval()
        with torch.no_grad():
            return task.text_encoder(data["input_ids"],
                                     data["attention_mask"])

    def embed_audio(x):
        task.audio_encoder.eval()
        with torch.no_grad():
            return task.audio_encoder(torch.from_numpy(x).to(DEVICE))

    classifier = zero_shot_classifier(embed_texts, captions, (lambda c: c,))
    target = np.arange(len(captions))
    batches = [(waves[i:i + CLAP_CLI_BATCH], target[i:i + CLAP_CLI_BATCH])
               for i in range(0, len(captions), CLAP_CLI_BATCH)]
    zs = zero_shot_run(embed_audio, classifier, batches)
    feats = np.concatenate([embed_audio(w).double().cpu().numpy()
                            for w, _ in batches])
    logits = feats @ classifier.double().cpu().numpy()
    order = np.argsort(-logits, axis=1)
    plain = {"zeroshot-top1": float(np.mean(order[:, 0] == target)),
             "zeroshot-top5": float(np.mean(
                 (order[:, :5] == target[:, None]).any(axis=1)))}
    no_launches(kernel_counts(), "the restored step and zero-shot")
    if zs != plain:
        raise AssertionError(f"zero-shot {zs} against the plain top-k "
                             f"{plain}")
    del task
    torch.cuda.empty_cache()
    return loss, zs


def clap_pretraining(build_dir):
    """Phase 10 (module docstring). Returns its results."""
    import numpy as np

    from lass_torch.data.synth import make_synth_corpus, make_synth_shards

    start = time.perf_counter()
    seconds = {}

    def lap(name):
        seconds[name] = time.perf_counter() - start - sum(seconds.values())

    results = {"htsat_step": time_clap_step("HTSAT-base")}
    lap("htsat_step")
    results["pann_step"] = time_clap_step("PANN-14")
    lap("pann_step")
    results["card_vs_cpu_rel_err"] = clap_card_vs_cpu()
    lap("card_vs_cpu")
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        n = CLAP_CLI_BATCH * CLAP_CLI_STEPS
        wav = make_synth_shards(os.path.join(root, "wav"), num_shards=4,
                                per_shard=n // 4, seconds=10.0,
                                num_classes=PROBE_CLASSES,
                                tags_per_clip=PROBE_CLASSES // 2, seed=1)
        # 16 clips of seed 1: every class between 2 and 14 of them
        flac = make_synth_shards(os.path.join(root, "flac"), num_shards=4,
                                 per_shard=CLAP_FLAC_BATCH * CLAP_CLI_STEPS
                                 // 4, seconds=10.0,
                                 audio_format="flac",
                                 distinct=CLAP_FLAC_DISTINCT, seed=2)
        val = make_synth_corpus(os.path.join(root, "val"),
                                num_clips=CLAP_VAL_CLIPS, sample_rate=48000,
                                seconds_min=10.0, seconds_max=10.0,
                                alt_rate_fraction=0.0, seed=3)
        lap("shards")
        common = ["--max_steps", str(CLAP_CLI_STEPS), "--num_workers", "1"]
        argv = ["--train_shards", wav, "--val_datafiles", val,
                "--save_every", "2", "--batch_size", str(CLAP_CLI_BATCH),
                *common]
        metrics, steps, ckpt_dir, stdout, cli_s = run_clap_cli(
            "clap_pretrain", argv, os.path.join(root, "ws_wav"),
            os.path.join(root, "counts_wav.json"))
        losses = [metrics[k]["contrastive_loss"] for k in sorted(metrics)]
        final = ast.literal_eval(stdout.split("final retrieval:")[1]
                                 .splitlines()[0].strip())
        wav_rates = cli_rates(metrics)
        log(f"clap_pretrain CLI, WAV shards, {CLAP_CLI_BATCH} x 10 s: steps "
            f"{sorted(metrics)}, losses {losses}, checkpoints {steps}, "
            f"steps/s {wav_rates['steps_per_s']} (load s "
            f"{wav_rates['load_s']}, decode s {wav_rates['decode_s']}), "
            f"final retrieval on {final['num_samples']:.0f} val clips: R@1 "
            f"{final['audio_to_text_R@1']} / {final['text_to_audio_R@1']}, "
            f"{cli_s:.1f} s")
        if sorted(metrics) != list(range(1, CLAP_CLI_STEPS + 1)) or \
                not np.isfinite(losses).all():
            raise AssertionError(f"clap_pretrain metrics: {metrics}")
        if steps != [1, 2, 4] or final["num_samples"] != CLAP_VAL_CLIPS or \
                not all(np.isfinite(v) for v in final.values()):
            raise AssertionError(f"checkpoints {steps}, retrieval {final}")
        lap("cli_wav")
        resumed, zero_shot = clap_resume_and_zero_shot(argv, ckpt_dir,
                                                       metrics, val)
        log(f"restored from step 2: step-3 loss {resumed} (the CLI's "
            f"{metrics[3]['contrastive_loss']}, equal); zero-shot over the "
            f"{CLAP_VAL_CLIPS} val clips at step 4: {zero_shot}")
        lap("resume_zero_shot")
        f_metrics, _, _, _, f_cli_s = run_clap_cli(
            "clap_pretrain", ["--train_shards", flac, "--save_every", "100",
                              "--batch_size", str(CLAP_FLAC_BATCH), *common],
            os.path.join(root, "ws_flac"),
            os.path.join(root, "counts_flac.json"))
        f_losses = [f_metrics[k]["contrastive_loss"]
                    for k in sorted(f_metrics)]
        flac_rates = cli_rates(f_metrics)
        log(f"clap_pretrain CLI, FLAC shards, {CLAP_FLAC_BATCH} x 10 s: "
            f"losses {f_losses}, steps/s "
            f"{flac_rates['steps_per_s']} (load s {flac_rates['load_s']}, "
            f"decode s {flac_rates['decode_s']}), {f_cli_s:.1f} s")
        if len(f_losses) != CLAP_CLI_STEPS or not np.isfinite(f_losses).all():
            raise AssertionError(f"FLAC run metrics: {f_metrics}")
        lap("cli_flac")
        p_metrics, _, _, p_stdout, p_cli_s = run_clap_cli(
            "linear_probe",
            ["--train_shards", wav, "--val_shards", wav, "--class_index",
             os.path.join(root, "wav", "classes.json"), "--save_every",
             "100", "--batch_size", str(CLAP_CLI_BATCH), *common],
            os.path.join(root, "ws_probe"),
            os.path.join(root, "counts_probe.json"))
        # the one eval, after step 4 (a nan would print as nan: None here)
        lp = ast.literal_eval(p_stdout.split("final lp metrics:")[1]
                              .splitlines()[0].strip().replace("nan",
                                                               "None"))
        lp_losses = [p_metrics[k]["lp_loss"] for k in sorted(p_metrics)]
        probe_rates = cli_rates(p_metrics)
        log(f"linear_probe CLI, frozen HTSAT-base, {PROBE_CLASSES} classes, "
            f"{CLAP_CLI_BATCH} x 10 s: losses {lp_losses}, steps/s "
            f"{probe_rates['steps_per_s']}, the eval after step "
            f"{CLAP_CLI_STEPS} on {n} clips {lp}, {p_cli_s:.1f} s")
        if len(lp_losses) != CLAP_CLI_STEPS or \
                not np.isfinite(lp_losses).all() or \
                sorted(lp) != ["acc", "map", "mauc"] or \
                not all(v is not None and math.isfinite(v)
                        for v in lp.values()):
            raise AssertionError(f"linear probe: {p_metrics}, {lp}")
        lap("cli_probe")
    results.update(
        cli_wav={"losses": losses, "checkpoints": steps, **wav_rates,
                 "final_retrieval": final, "seconds": cli_s},
        resumed_step3_loss=resumed, zero_shot=zero_shot,
        cli_flac={"losses": f_losses, **flac_rates, "seconds": f_cli_s},
        linear_probe={"losses": lp_losses, "metrics": lp, **probe_rates,
                      "seconds": p_cli_s},
        phase_s=time.perf_counter() - start, seconds=seconds)
    log(f"phase 10: {results['phase_s']:.1f} s "
        f"({', '.join(f'{k} {v:.1f}' for k, v in seconds.items())})")
    return results


def parallel_world():
    """Phase 11(a)'s (ranks, backend): one rank per card over NCCL; on one
    card two ranks over gloo."""
    import torch

    cards = torch.cuda.device_count()
    return (cards, "nccl") if cards > 1 else (2, "gloo")


def parity_separator(device):
    """A float32 full-width ResUNet30 (seed 0) in an AudioSepTask whose
    AdamW takes its full learning rate from the first update."""
    import torch

    from lass_torch.data.mixer import SegmentMixer
    from lass_torch.models.resunet import ResUNet30
    from lass_torch.tasks.audiosep import AudioSepTask
    from lass_torch.train.optim import build_optimizer

    torch.manual_seed(0)
    model = ResUNet30().to(device)
    optimizer, scheduler = build_optimizer(
        model.parameters(), "AdamW", 1e-3, "cosine_warm_up", 1, 100)
    return AudioSepTask(model, SegmentMixer(), optimizer, scheduler)


def parity_batches(seed=30):
    """The global batches of phase 11(a), on the CPU: premixed (mixture,
    segment, condition) and the mixer's waveforms, PARALLEL_SEP_BATCH clips
    of 10 s at 16 kHz."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    b = PARALLEL_SEP_BATCH
    segment = 0.1 * torch.randn(b, 1, 160000, generator=gen)
    return ({"mixture": segment + 0.1 * torch.randn(b, 1, 160000,
                                                    generator=gen),
             "segment": segment,
             "condition": torch.randn(b, 512, generator=gen)},
            0.1 * torch.randn(b, 1, 160000, generator=gen))


class CaptionStub:
    """Phase 11(a)'s caption encoder: a seeded (512,) vector a caption
    (the evaluator's sharding, not the captions, is under test)."""

    def get_query_embed(self, modality, text=None, **kwargs):
        import zlib

        import numpy as np

        return np.stack([np.random.RandomState(zlib.crc32(t.encode())).randn(
            512).astype(np.float32) for t in text])


def parity_run(device, rank, world, eval_csv, eval_dir):
    """Phase 11(a)'s paths on this rank's rows (the whole batch when world
    is 1): the train step, the mix, the CLAP step, the evaluator. Returns
    (results, loss and flat vectors) on the CPU."""
    import torch

    from lass_torch.clap_pretrain import build_task
    from lass_torch.evaluation.dcase import (
        DCASEEvaluator, SeparationInference)
    from lass_torch.models.resunet import ResUNet30

    def rows(x):
        b = x.shape[0] // world
        return x[rank * b:(rank + 1) * b].to(device)

    def flat(tensors):
        return torch.cat([t.detach().float().reshape(-1)
                          for t in tensors]).cpu()

    out = {}
    task = parity_separator(device)
    batch, waves = parity_batches()
    before = flat(p for p in task.model.parameters())
    m = task.train_step_premixed({k: rows(v) for k, v in batch.items()})
    sd = task.model.state_dict()
    out["sep"] = {"loss": float(m["train_loss"]), "params0": before,
                  "grads": flat(p.grad for p in task.model.parameters()),
                  "params": flat(p for p in task.model.parameters()),
                  "bn": flat(v for k, v in sorted(sd.items())
                             if "running_" in k)}
    gen = torch.Generator(device=device).manual_seed(31)
    mixtures, segments = task.mix(rows(waves), gen)
    out["mix"] = {"mixtures": mixtures.cpu(), "segments": segments.cpu()}
    del task, m, sd
    args = clap_args("HTSAT-base", "--warmup", "1", "--wd", "10")
    ctask = build_task(args, device)
    cbatch = clap_batch(PARALLEL_CLAP_BATCH, "cpu", seed=32)
    before = flat(p for p in ctask.parameters())
    m = ctask.train_step({k: rows(v) for k, v in cbatch.items()})
    sd = ctask.state_dict()
    out["clap"] = {"loss": float(m["contrastive_loss"]), "params0": before,
                   "grads": flat(p.grad for p in ctask.parameters()),
                   "params": flat(p for p in ctask.parameters()),
                   "bn": flat(v for k, v in sorted(sd.items())
                              if "running_" in k)}
    del ctask, m, sd
    torch.cuda.empty_cache()
    torch.manual_seed(0)
    evaluator = DCASEEvaluator(16000, eval_csv, eval_dir,
                               batch_size=PARALLEL_EVAL_BATCH,
                               data_parallel=world > 1)
    out["eval"] = evaluator(SeparationInference(
        ResUNet30(), CaptionStub(), device=str(device)))
    torch.cuda.empty_cache()
    return out


def parallel_rank(rank, world, ref_path, eval_csv, eval_dir):
    """One rank of phase 11(a) (``run_local_ranks``): its run against the
    one-process reference at ``ref_path``; returns the errors, a checksum
    of its updated parameters and its kernel launches."""
    import torch

    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_kernel_counts()
    got = parity_run(device, rank, world, eval_csv, eval_dir)
    ref = torch.load(ref_path, weights_only=True)
    errs = {}
    for path in ("sep", "clap"):
        g, r = got[path], ref[path]
        errs[path] = {"loss": abs(g["loss"] - r["loss"]) / abs(r["loss"])}
        for key in ("grads", "params", "bn"):
            a, b = g[key].to(device).double(), r[key].to(device).double()
            errs[path][key] = float((a - b).norm() / b.norm())
        errs[path]["params_checksum"] = float(g["params"].double().sum())
    b = PARALLEL_SEP_BATCH // world
    errs["mix"] = max(float((got["mix"][k] - ref["mix"][k][
        rank * b:(rank + 1) * b]).abs().max()) for k in ("mixtures",
                                                          "segments"))
    errs["eval_db"] = max(abs(x - y) for x, y in zip(got["eval"],
                                                      ref["eval"]))
    errs["eval"] = got["eval"]
    errs["launches"] = kernel_counts()
    return errs


def parity_on_ranks(build_dir):
    """Phase 11(a) (module docstring). Returns its results and the ranks'
    launches summed."""
    import torch

    from lass_torch.data.synth import make_synth_eval_set
    from lass_torch.parallel.host import run_local_ranks

    world, backend = parallel_world()
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        eval_dir = os.path.join(root, "eval")
        eval_csv = make_synth_eval_set(eval_dir, num_rows=PARALLEL_EVAL_ROWS,
                                       seconds=10.0, seed=33)
        start = time.perf_counter()
        ref = parity_run(torch.device("cuda"), 0, 1, eval_csv, eval_dir)
        # how far one process's step moves the parameters: a wrong update
        # on the ranks shows only where this is well above the limit
        steps = {path: float((ref[path]["params"] - ref[path].pop("params0")
                              ).double().norm()
                             / ref[path]["params"].double().norm())
                 for path in ("sep", "clap")}
        ref_path = os.path.join(root, "reference.pt")
        torch.save(ref, ref_path)
        ref_s = time.perf_counter() - start
        del ref
        torch.cuda.empty_cache()
        start = time.perf_counter()
        ranks = run_local_ranks(parallel_rank, world,
                                (ref_path, eval_csv, eval_dir),
                                backend=backend, timeout_s=900)
        ranks_s = time.perf_counter() - start
    worst = {path: {key: max(r[path][key] for r in ranks)
                    for key in ("loss", "grads", "params", "bn")}
             for path in ("sep", "clap")}
    res = {"world": world, "backend": backend, "rel_err": worst,
           "step_size": steps,
           "mix_abs": max(r["mix"] for r in ranks),
           "eval_db": max(r["eval_db"] for r in ranks),
           "eval": ranks[0]["eval"],
           "b1_launches_per_rank": [r["launches"]["apply_complex_mask_ri"]
                                    for r in ranks],
           "seconds": {"one_rank": ref_s, "ranks": ranks_s}}
    log(f"phase 11a: {world} ranks over {backend} on "
        f"{torch.cuda.device_count()} card(s) against one process, float32,"
        f" TF32 off: ResUNet30 premixed step of {PARALLEL_SEP_BATCH} x 10 s "
        f"rel err {worst['sep']}; global mix max abs {res['mix_abs']:.2e}; "
        f"CLAP HTSAT-base + RoBERTa-base step of {PARALLEL_CLAP_BATCH} x 10 s"
        f" rel err {worst['clap']}; evaluator over {PARALLEL_EVAL_ROWS} clips "
        f"{res['eval']}, max |dB| difference {res['eval_db']:.2e}; B1 "
        f"launches per rank {res['b1_launches_per_rank']}; the one-process "
        f"steps move the parameters by {steps} of their norm (at least "
        f"{10 * PARALLEL_REL}); {ref_s:.1f} s one process, {ranks_s:.1f} s "
        f"the ranks")
    if min(steps.values()) < 10 * PARALLEL_REL:
        raise AssertionError("a step moves the parameters too little for "
                             "the parameter comparison to see it")
    for path in ("sep", "clap"):
        sums = {r[path]["params_checksum"] for r in ranks}
        if len(sums) != 1:
            raise AssertionError(f"{path}: the ranks' parameters differ")
        e = worst[path]
        loss_limit = PARALLEL_LOSS_REL if path == "clap" else PARALLEL_REL
        if e["loss"] > loss_limit or max(
                e["grads"], e["params"], e["bn"]) > PARALLEL_REL:
            raise AssertionError(f"{path}: {world} ranks differ from one "
                                 f"process: {e}")
    if res["mix_abs"] > PARALLEL_MIX_ABS or res["eval_db"] > PARALLEL_EVAL_DB:
        raise AssertionError("the global mix or the sharded evaluator "
                             "differs from one process")
    batches = -(-PARALLEL_EVAL_ROWS // PARALLEL_EVAL_BATCH)
    expect = [1 + len(range(batches)[r::world]) for r in range(world)]
    if res["b1_launches_per_rank"] != expect:
        raise AssertionError(f"B1 launches per rank "
                             f"{res['b1_launches_per_rank']}, expected "
                             f"{expect}")
    launches = {name: sum(r["launches"][name] for r in ranks)
                for name, *_ in KERNELS}
    return res, launches


def run_torchrun_train(workspace, config, cards, counts_path, profile_path):
    """``python -m torch.distributed.run --nproc_per_node <cards> -m
    lass_torch.train``; returns its metrics by step, checkpoint steps and
    directory, rank 0's kernel launches, the profile and seconds."""
    from lass_torch.parallel.host import free_port

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(cards), "--master_addr", "localhost",
           "--master_port", str(free_port()), "-m", "lass_torch.train",
           "--workspace", workspace, "--config_yaml", config,
           "--resume_checkpoint_path", "", "--max_steps",
           str(PARALLEL_CLI_STEPS), "--log_every", "1", "--launch_counts",
           counts_path, "--profile", profile_path]
    start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun training failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    stem = os.path.splitext(os.path.basename(config))[0]
    sub = os.path.join("train", f"{stem},devices={cards}")
    metrics = {}
    with open(os.path.join(workspace, "tf_logs", sub, "metrics.jsonl")) as f:
        for record in map(json.loads, f):
            metrics.setdefault(record["step"], {}).update(record)
    ckpt_dir = os.path.join(workspace, "checkpoints", sub)
    steps = sorted(int(n.split(".")[0]) for n in os.listdir(ckpt_dir)
                   if n.endswith(".ckpt"))
    with open(counts_path) as f:
        counts = json.load(f)
    with open(profile_path) as f:
        profile = json.load(f)
    return metrics, steps, ckpt_dir, counts, profile, seconds


def torchrun_training(build_dir):
    """Phase 11(b) (module docstring). Returns its results and launches."""
    import numpy as np
    import torch

    from lass_torch.config import load_config
    from lass_torch.convert.checkpoint_io import load_ss_model
    from lass_torch.data.synth import make_synth_corpus, write_train_config
    from lass_torch.train.loop import Trainer

    cards = torch.cuda.device_count()
    datafile = make_synth_corpus(os.path.join(build_dir, "train_corpus"),
                                 num_clips=4 * TRAIN_BATCH + 8,
                                 seconds_min=8.0, seconds_max=14.0, seed=0)
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        config = write_train_config(
            os.path.join(root, "config.yaml"), datafile,
            batch_size=TRAIN_BATCH, segment_seconds=10, num_workers=8,
            save_step_frequency=2, compute_dtype="bfloat16")
        metrics, steps, ckpt_dir, counts, profile, seconds = \
            run_torchrun_train(os.path.join(root, "run"), config, cards,
                               os.path.join(root, "counts.json"),
                               os.path.join(root, "profile.json"))
        losses = [metrics[k]["train_loss"] for k in sorted(metrics)]
        rates = [metrics[k]["steps_per_sec"] for k in sorted(metrics)]
        log(f"phase 11b: torch.distributed.run, {cards} card(s) x "
            f"{TRAIN_BATCH} x 10 s bf16: steps {sorted(metrics)}, losses "
            f"{losses}, steps/s per card {rates}; profiled steps "
            f"{profile['steps']} in {profile['wall_s']:.3f} s: collectives "
            f"{profile['collective_share']:.2%} of it, BatchNorm's "
            f"collectives {profile['bn_collective_share']:.2%} "
            f"({profile['bn_collective_calls']} calls); directory "
            f"{os.path.basename(os.path.dirname(ckpt_dir + '/'))}, rank 0's "
            f"checkpoints {steps}; rank 0's launches {counts}; "
            f"{seconds:.1f} s")
        if sorted(metrics) != list(range(1, PARALLEL_CLI_STEPS + 1)) or \
                not np.isfinite(losses).all():
            raise AssertionError(f"torchrun training metrics: {metrics}")
        if steps != [1, 2, 4] or not ckpt_dir.endswith(f",devices={cards}"):
            raise AssertionError(f"checkpoints {steps} in {ckpt_dir}")
        expect = {name: 0 for name, *_ in KERNELS}
        expect["apply_complex_mask_ri"] = PARALLEL_CLI_STEPS
        if counts != expect:
            raise AssertionError(f"rank 0 launched {counts}, expected "
                                 f"{expect}")
        reset_kernel_counts()
        trainer = Trainer(config, os.path.join(root, "resumed"),
                          resume_checkpoint_path=os.path.join(ckpt_dir,
                                                              "2.ckpt"),
                          device="cuda", log_every=1)
        if trainer.task.step != 2:
            raise AssertionError(f"resumed at step {trainer.task.step}")
        trainer.fit(max_steps=PARALLEL_CLI_STEPS)
        with open(os.path.join(trainer.tf_logs_dir, "metrics.jsonl")) as f:
            resumed = {r["step"]: r["train_loss"] for r in map(json.loads, f)}
        rel = {k: abs(v - metrics[k]["train_loss"])
               / abs(metrics[k]["train_loss"]) for k, v in resumed.items()}
        cfg = load_config(config)
        served = load_ss_model(cfg, os.path.join(ckpt_dir, "4.ckpt"),
                               query_encoder=trainer.query_encoder,
                               device="cuda")
        serve(served, [SERVE_REQUESTS[0]])
        launches = kernel_counts()
        log(f"its step-2 checkpoint in a single-process Trainer: steps "
            f"{sorted(resumed)}, losses {list(resumed.values())} (rel err "
            f"against the {cards}-card run's {rel}); the step-4 checkpoint "
            f"served one request; launches {launches}")
        if sorted(resumed) != [3, 4] or \
                not np.isfinite(list(resumed.values())).all():
            raise AssertionError(f"the resumed Trainer's losses: {resumed}")
        del trainer, served
        torch.cuda.empty_cache()
    for name in launches:
        launches[name] += counts[name]
    return {"cards": cards, "losses": losses, "steps_per_s_per_card": rates,
            "profile": profile, "checkpoints": steps,
            "directory": os.path.basename(ckpt_dir),
            "resumed_losses": resumed, "resumed_rel_err": rel,
            "seconds": seconds}, launches


def codec_times(reps=10, plain_reps=3):
    """Phase 11(c): ms to decode a CODEC_SECONDS mono 48 kHz clip, WAV
    (PCM16) and FLAC, through the native decoders (median of ``reps``,
    after the first call, which builds them) and the numpy ones (median
    of ``plain_reps``); the outputs bitwise equal."""
    import numpy as np

    from lass_torch.audio import flac, io
    from lass_torch.native import library_path

    rng = np.random.default_rng(34)
    n = int(CODEC_SECONDS * 48000)
    t = np.arange(n) / 48000.0
    clip = (0.3 * np.sin(2 * np.pi * 440.0 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)[None]
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "clip.wav")
        io.write_wav(path, clip, 48000)
        with open(path, "rb") as f:
            payloads = {"wav": f.read(),
                        "flac": flac.encode_flac(clip, 48000)}
    plain = {"wav": io.read_wav_bytes_plain, "flac": flac.decode_flac_bytes}
    start = time.perf_counter()
    io.read_audio_bytes(payloads["wav"])
    build_s = time.perf_counter() - start
    out = {"build_s": build_s, "library": os.path.basename(library_path())}

    def median_ms(fn, payload, n_reps):
        times, result = [], None
        for _ in range(n_reps):
            start = time.perf_counter()
            result = fn(payload)
            times.append(time.perf_counter() - start)
        return statistics.median(times) * 1e3, result

    for fmt, payload in payloads.items():
        ms, (got, sr) = median_ms(io.read_audio_bytes, payload, reps)
        plain_ms, (ref, sr_ref) = median_ms(plain[fmt], payload, plain_reps)
        if sr != sr_ref or not np.array_equal(got, ref):
            raise AssertionError(f"{fmt}: the native decoder differs from "
                                 f"numpy")
        out[fmt] = {"native_ms": ms, "numpy_ms": plain_ms,
                    "bytes": len(payload)}
    log(f"phase 11c: decode one {CODEC_SECONDS:.0f} s mono 48 kHz clip: WAV "
        f"native {out['wav']['native_ms']:.3f} ms, numpy "
        f"{out['wav']['numpy_ms']:.3f} ms; FLAC native "
        f"{out['flac']['native_ms']:.3f} ms, numpy "
        f"{out['flac']['numpy_ms']:.1f} ms (bitwise equal; first call with "
        f"the g++ build {build_s:.2f} s)")
    return out


def data_parallel(build_dir):
    """Phase 11 (module docstring). Returns (results, launches)."""
    start = time.perf_counter()
    seconds = {}

    def lap(name):
        seconds[name] = time.perf_counter() - start - sum(seconds.values())

    cli, launches = torchrun_training(build_dir)
    lap("torchrun")
    codec = codec_times()
    flac_cli = RESULTS.get("clap", {}).get("cli_flac")
    if flac_cli:
        log(f"phase 10's clap_pretrain CLI over FLAC shards (native "
            f"decoder), {CLAP_FLAC_BATCH} x 10 s: steps/s "
            f"{flac_cli['steps_per_s']}, decode s {flac_cli['decode_s']}, "
            f"load s {flac_cli['load_s']}")
    lap("codec")
    parity, parity_launches = parity_on_ranks(build_dir)
    lap("parity")
    for name in launches:
        launches[name] += parity_launches[name]
    results = {"parity": parity, "torchrun": cli, "codec": codec,
               "phase_s": time.perf_counter() - start, "seconds": seconds}
    log(f"phase 11: {results['phase_s']:.1f} s "
        f"({', '.join(f'{k} {v:.1f}' for k, v in seconds.items())})")
    return results, launches


def grid_world(data, model):
    """Phase 12(a)'s backend for a (data x model) grid: NCCL with one rank
    a card where there are enough cards, else gloo on one card."""
    import torch

    world = data * model
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def grid_separator(device, grid):
    """``parity_separator``'s model (seed 0, float32, full width) sharded
    over ``grid``, in an AudioSepTask over it (the optimizer built after
    the sharding)."""
    import torch

    from lass_torch.data.mixer import SegmentMixer
    from lass_torch.models.resunet import ResUNet30
    from lass_torch.parallel.tensor import shard_model
    from lass_torch.tasks.audiosep import AudioSepTask
    from lass_torch.train.optim import build_optimizer

    torch.manual_seed(0)
    model = shard_model(ResUNet30().to(device), grid)
    optimizer, scheduler = build_optimizer(
        model.parameters(), "AdamW", 1e-3, "cosine_warm_up", 1, 100)
    return AudioSepTask(model, SegmentMixer(), optimizer, scheduler,
                        grid=grid)


def grid_rank(rank, world, model_parallel, ref_path, ckpt_path):
    """One rank of phase 12(a) (``run_local_ranks``): two premixed steps of
    its data rank's rows on the grid, against the one-process run at
    ``ref_path``; the checkpoint after the first step is written to
    ``ckpt_path`` by rank 0. Returns the errors, a checksum of the
    replicated parameters, the whole parameters' sum at the checkpoint,
    the moment bytes and its launches."""
    import zlib

    import torch

    from lass_torch.parallel.mesh import make_grid
    from lass_torch.parallel.tensor import gather_full, sharded_dims
    from lass_torch.train.checkpoint import snapshot

    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = make_grid(model_parallel)
    task = grid_separator(device, grid)
    model = task.model
    batch, _ = parity_batches()
    per = PARALLEL_SEP_BATCH // grid.data_size
    rows = {k: v[grid.data_rank * per:(grid.data_rank + 1) * per].to(device)
            for k, v in batch.items()}
    dims = sharded_dims(model)

    def whole(name, t):
        return gather_full(t, dims[name], grid) if name in dims else t

    def flat(pairs):
        return torch.cat([whole(n, t).detach().double().reshape(-1)
                          for n, t in pairs])

    ref = torch.load(ref_path, weights_only=True)

    def rel(got, key):
        r = ref[key].to(device).double()
        return float((got - r).norm() / r.norm())

    reset_kernel_counts()
    m = task.train_step_premixed(rows)
    errs = {"loss": abs(float(m["train_loss"]) - ref["loss"])
            / abs(ref["loss"]),
            "grads": rel(flat((n, p.grad) for n, p in
                              model.named_parameters()), "grads"),
            "params": rel(flat(model.named_parameters()), "params"),
            "bn": rel(flat((k, v) for k, v in sorted(
                model.state_dict().items()) if "running_" in k), "bn")}
    replicated = b"".join(p.detach().cpu().numpy().tobytes()
                          for n, p in model.named_parameters()
                          if n not in dims) + b"".join(
        v.cpu().numpy().tobytes() for k, v in sorted(
            model.state_dict().items()) if "running_" in k)
    moment_bytes = sum(v.nbytes for p in model.parameters()
                       for v in task.optimizer.state[p].values()
                       if v.dim() > 0)
    whole_bytes = 3 * 4 * sum(whole(n, p).numel()
                              for n, p in model.named_parameters())
    params_sum = float(flat(model.named_parameters()).sum())
    state = snapshot(task)
    if rank == 0:
        torch.save(state, ckpt_path)
    del state
    m = task.train_step_premixed(rows)
    errs["loss2"] = abs(float(m["train_loss"]) - ref["loss2"]) \
        / abs(ref["loss2"])
    return {"errs": errs, "params_sum": params_sum,
            "data_rank": grid.data_rank,
            "model_rank": grid.model_rank,
            "replicated_crc": zlib.crc32(replicated),
            "moment_bytes": moment_bytes, "whole_moment_bytes": whole_bytes,
            "sharded": len(dims), "launches": kernel_counts()}


def grid_reference(device):
    """Phase 12(a)'s one-process run: two premixed steps of the whole
    batch; the first's loss, grads, parameters and BN statistics (flat,
    float32, on the CPU) and the second's loss."""
    import torch

    def flat(tensors):
        return torch.cat([t.detach().float().reshape(-1)
                          for t in tensors]).cpu()

    task = parity_separator(device)
    batch, _ = parity_batches()
    batch = {k: v.to(device) for k, v in batch.items()}
    m = task.train_step_premixed(batch)
    model = task.model
    ref = {"loss": float(m["train_loss"]),
           "grads": flat(p.grad for p in model.parameters()),
           "params": flat(model.parameters()),
           "bn": flat(v for k, v in sorted(model.state_dict().items())
                      if "running_" in k)}
    m = task.train_step_premixed(batch)
    ref["loss2"] = float(m["train_loss"])
    return ref, batch


def grid_parity(build_dir):
    """Phase 12(a) (module docstring). Returns its results and launches."""
    import torch

    from lass_torch.parallel.host import run_local_ranks

    launches = {name: 0 for name, *_ in KERNELS}
    out = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        ref_path = os.path.join(root, "reference.pt")
        ref, batch = grid_reference(torch.device("cuda"))
        torch.save(ref, ref_path)
        del ref
        torch.cuda.empty_cache()
        for data, model in GRID_LAYOUTS:
            world, backend = data * model, grid_world(data, model)
            ckpt_path = os.path.join(root, f"grid_{data}x{model}.ckpt")
            start = time.perf_counter()
            ranks = run_local_ranks(grid_rank, world,
                                    (model, ref_path, ckpt_path),
                                    backend=backend, timeout_s=600)
            seconds = time.perf_counter() - start
            worst = {k: max(r["errs"][k] for r in ranks)
                     for k in ranks[0]["errs"]}
            groups = {}
            for r in ranks:
                groups.setdefault(r["data_rank"], set()).add(
                    r["replicated_crc"])
            res = {"backend": backend, "rel_err": worst,
                   "replicated_bitwise_equal": all(
                       len(c) == 1 for c in groups.values()),
                   "moment_bytes_per_rank": [r["moment_bytes"]
                                             for r in ranks],
                   "whole_moment_bytes": ranks[0]["whole_moment_bytes"],
                   "sharded_weights": ranks[0]["sharded"],
                   "b1_launches_per_rank": [
                       r["launches"]["apply_complex_mask_ri"]
                       for r in ranks], "seconds": seconds}
            out[f"{data}x{model}"] = res
            for name in launches:
                launches[name] += sum(r["launches"][name] for r in ranks)
            log(f"phase 12a: grid (data {data} x model {model}), {world} "
                f"ranks over {backend} on {torch.cuda.device_count()} "
                f"card(s), float32, TF32 off, the premixed step of "
                f"{PARALLEL_SEP_BATCH} x 10 s against one process: rel err "
                f"{worst}; {res['sharded_weights']} weights sharded; "
                f"replicated parameters and BN running statistics bitwise "
                f"equal in every model group "
                f"{res['replicated_bitwise_equal']}; optimizer moments per "
                f"rank {[b / 2**20 for b in res['moment_bytes_per_rank']]} "
                f"MiB of {res['whole_moment_bytes'] / 2**20:.1f} MiB whole; "
                f"B1 launches per rank {res['b1_launches_per_rank']}; "
                f"{seconds:.1f} s")
            if not res["replicated_bitwise_equal"]:
                raise AssertionError("replicated parameters or BN running "
                                     "statistics differ inside a model "
                                     "group")
            if worst["loss"] > PARALLEL_LOSS_REL or worst["loss2"] > \
                    PARALLEL_LOSS_REL or max(
                        worst[k] for k in ("grads", "params", "bn")) > \
                    PARALLEL_REL:
                raise AssertionError(f"the {data} x {model} grid differs "
                                     f"from one process: {worst}")
            if max(res["moment_bytes_per_rank"]) >= \
                    res["whole_moment_bytes"]:
                raise AssertionError("the optimizer moments do not shard")
            if res["b1_launches_per_rank"] != [2] * world:
                raise AssertionError(f"B1 launches per rank "
                                     f"{res['b1_launches_per_rank']}")
        # the checkpoint written at the last layout, resumed in one process
        data, model = GRID_LAYOUTS[-1]
        ckpt = torch.load(os.path.join(root, f"grid_{data}x{model}.ckpt"),
                          map_location="cpu", weights_only=True)
        ref = torch.load(ref_path, weights_only=True)
        task = parity_separator(torch.device("cuda"))
        task.load_checkpoint_state(ckpt)
        params_sum = float(torch.cat([p.detach().double().reshape(-1)
                                      for p in task.model.parameters()]
                                     ).sum())
        reset_kernel_counts()
        m = task.train_step_premixed(batch)
        for name, n in kernel_counts().items():
            launches[name] += n
        resumed = {"step": task.step,
                   "params_equal": params_sum == ranks[0]["params_sum"],
                   "loss2": abs(float(m["train_loss"]) - ref["loss2"])
                   / abs(ref["loss2"])}
        out["resumed_in_one_process"] = resumed
        log(f"phase 12a: the {data} x {model} grid's step-1 checkpoint in "
            f"one process: its parameters the grid's exactly "
            f"{resumed['params_equal']}; its step {resumed['step']} against "
            f"the one-process run's, loss rel err {resumed['loss2']:.2e}")
        if resumed["step"] != 2 or not resumed["params_equal"] or \
                resumed["loss2"] > PARALLEL_LOSS_REL:
            raise AssertionError("the grid's checkpoint did not resume in "
                                 "one process")
        del task, ckpt, ref, batch
        torch.cuda.empty_cache()
    return out, launches


def fit_seconds(log_dir):
    """The ``Trainer.timing`` a run logged ("fit seconds: {...}")."""
    for name in sorted(os.listdir(log_dir), reverse=True):
        with open(os.path.join(log_dir, name)) as f:
            for line in f:
                if "fit seconds: " in line:
                    return ast.literal_eval(line.split("fit seconds: ")[1])
    raise AssertionError(f"no fit seconds in {log_dir}")


def prefetch_cli(build_dir, model_parallel):
    """Phase 12(b): the train CLI through the prefetcher on phase 7's
    corpus, bf16, TRAIN_BATCH x 10 s a step (global), in one process or on
    a (1 x ``model_parallel``) grid under ``torch.distributed.run``;
    returns its results and rank 0's launches."""
    import numpy as np
    import torch

    from lass_torch.data.synth import make_synth_corpus, write_train_config
    from lass_torch.parallel.host import free_port

    ranks = model_parallel
    # the launcher's backend (lass_torch.parallel.host): NCCL with a card
    # a rank, gloo where the ranks outnumber the cards
    shared = torch.cuda.device_count() < ranks
    steps, log_every = ((SHARED_CLI_STEPS, SHARED_LOG_EVERY) if shared
                        else (PREFETCH_CLI_STEPS, PREFETCH_LOG_EVERY))
    datafile = make_synth_corpus(os.path.join(build_dir, "train_corpus"),
                                 num_clips=4 * TRAIN_BATCH + 8,
                                 seconds_min=8.0, seconds_max=14.0, seed=0)
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        config = write_train_config(
            os.path.join(root, "prefetch.yaml"), datafile,
            batch_size=TRAIN_BATCH // ranks, segment_seconds=10,
            num_workers=8, save_step_frequency=1000,
            compute_dtype="bfloat16")
        workspace = os.path.join(root, "run")
        counts_path = os.path.join(root, "counts.json")
        cmd = [sys.executable, "-m", "lass_torch.train"]
        if ranks > 1:
            cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes",
                   "1", "--nproc_per_node", str(ranks), "--master_addr",
                   "localhost", "--master_port", str(free_port()), "-m",
                   "lass_torch.train", "--model_parallel",
                   str(model_parallel)]
        cmd += ["--workspace", workspace, "--config_yaml", config,
                "--resume_checkpoint_path", "", "--max_steps", str(steps),
                "--log_every", str(log_every), "--launch_counts",
                counts_path]
        start = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=900)
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            raise RuntimeError(f"the prefetching CLI failed "
                               f"({proc.returncode}):\n{proc.stdout[-3000:]}"
                               f"\n{proc.stderr[-3000:]}")
        sub = os.path.join("train", f"prefetch,devices={ranks}")
        with open(os.path.join(workspace, "tf_logs", sub,
                               "metrics.jsonl")) as f:
            metrics = {r["step"]: r for r in map(json.loads, f)}
        timing = fit_seconds(os.path.join(workspace, "logs", sub))
        with open(counts_path) as f:
            counts = json.load(f)
    expect_steps = [1] + list(range(log_every, steps + 1, log_every))
    losses = [metrics[k]["train_loss"] for k in sorted(metrics)]
    res = {"ranks": ranks, "steps": steps,
           "steps_per_s": {k: metrics[k]["steps_per_sec"]
                           for k in sorted(metrics)},
           "last_window_steps_per_s": metrics[steps]["steps_per_sec"],
           "losses": losses, "timing": timing, "launches": counts,
           "seconds": seconds}
    what = ("one process" if ranks == 1 else
            f"--model_parallel {model_parallel}, {ranks} ranks over "
            f"{'gloo on one card' if shared else 'NCCL, a card each'}, "
            f"{TRAIN_BATCH // ranks} rows each")
    log(f"phase 12b: train CLI through the prefetcher, {what}, "
        f"{TRAIN_BATCH} x 10 s bf16 a step: steps/s by window "
        f"{res['steps_per_s']}, the last window (steps "
        f"{steps - log_every + 1}-{steps}) "
        f"{res['last_window_steps_per_s']:.3f} steps/s; rank 0's "
        f"Trainer.timing (s) {timing}; launches {counts}; {seconds:.1f} s")
    if sorted(metrics) != expect_steps or not np.isfinite(losses).all():
        raise AssertionError(f"the prefetching CLI's metrics: {metrics}")
    expect = {name: 0 for name, *_ in KERNELS}
    expect["apply_complex_mask_ri"] = steps
    if counts != expect:
        raise AssertionError(f"the prefetching CLI launched {counts}, "
                             f"expected {expect}")
    if not (timing["prefetch_h2d"] > 0 and timing["prefetch_embed"] > 0):
        raise AssertionError(f"the prefetch thread's timing: {timing}")
    return res, counts


def soak_run(build_dir):
    """Phase 12(c): ``python -m lass_torch.soak`` at full width; returns
    its report."""
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        report = os.path.join(root, "soak.json")
        cmd = [sys.executable, "-m", "lass_torch.soak", *SOAK_ARGS,
               "--batch", str(TRAIN_BATCH), "--workspace",
               os.path.join(root, "ws"), "--report", report]
        start = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=900)
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            raise RuntimeError(f"the soak failed ({proc.returncode}):\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(report) as f:
            out = json.load(f)
    out["seconds"] = seconds
    log(f"phase 12c: python -m lass_torch.soak {' '.join(SOAK_ARGS)} "
        f"--batch {TRAIN_BATCH}, bf16 x 10 s: killed after step "
        f"{out['killed_at_step']}, resumed from step "
        f"{out['resumed_from_step']}, overlapping steps "
        f"{out['overlap_steps_compared']} byte-exact "
        f"{out['resume_byte_exact']}; loss first / last quintile "
        f"{out['loss_first_quintile']:.5f} / {out['loss_last_quintile']:.5f}"
        f"; steps/s after the resume {out['steps_per_sec_post_resume']} "
        f"(stable {out['steps_per_sec_stable']}); eval "
        f"{[{k: r[k] for k in ('step', 'eval_SDR')} for r in out['eval_records']]}"
        f"; {seconds:.1f} s")
    if not out["resume_byte_exact"]:
        raise AssertionError("the soak's resumed losses are not byte-exact")
    return out


def tensor_parallel(build_dir, across_cards=False):
    """Phase 12 (module docstring; (a) and (b) only with
    ``across_cards``). Returns (results, launches)."""
    start = time.perf_counter()
    seconds = {}

    def lap(name):
        seconds[name] = time.perf_counter() - start - sum(seconds.values())

    grid, launches = grid_parity(build_dir)
    lap("grid")
    cli = {}
    for model_parallel in (1, 2):
        cli[model_parallel], counts = prefetch_cli(build_dir, model_parallel)
        for name in launches:
            launches[name] += counts[name]
    lap("cli")
    results = {"grid": grid, "cli": cli}
    if not across_cards:
        results["soak"] = soak_run(build_dir)
        lap("soak")
    results.update(phase_s=time.perf_counter() - start, seconds=seconds)
    log(f"phase 12: {results['phase_s']:.1f} s "
        f"({', '.join(f'{k} {v:.1f}' for k, v in seconds.items())})")
    return results, launches


def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Drive and check the "
                                     "PyTorch port on the card(s).")
    parser.add_argument("--phase", type=int, choices=[11, 12], default=None,
                        help="run phases 1, 2 and this one only")
    parser.add_argument("--across_cards", action="store_true",
                        help="with --phase 12: its parts that span cards "
                             "only, (a) and (b) (the four-card call)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from lass_torch.ops import _build

    # 1. card
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"compute capability {cap[0]}.{cap[1]}")
    if cap[0] != 9:
        raise RuntimeError(f"kernels are built for sm_90a; this card is "
                           f"sm_{cap[0]}{cap[1]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    start = time.perf_counter()
    _build.load_library(verbose=True)
    log(f"kernel build + load: {time.perf_counter() - start:.1f} s "
        f"(nvcc {_build.last_build_seconds:.1f} s)")

    build_dir = os.path.join(REPO, "lass_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    if args.phase == 11:
        RESULTS["parallel"], RESULTS["launches_phase11"] = data_parallel(
            build_dir)
        return finish(torch, details="chip_smoke_phase11.json")
    if args.phase == 12:
        RESULTS["tensor_parallel"], RESULTS["launches_phase12"] = \
            tensor_parallel(build_dir, args.across_cards)
        return finish(torch, details="chip_smoke_phase12.json")

    # 3. kernels vs plain; B2 has no caller in either package, so this
    # phase is its path: its launches are counted here
    mask_err = check_mask_kernel("cuda")
    reset_kernel_counts()
    b2_err = check_mask_kernel("cuda", b2=True)
    b2_launches = kernel_counts()["apply_complex_mask"]
    fused_err = check_fused_kernels("cuda")
    timetap_err = check_timetap("cuda")
    torch.cuda.empty_cache()

    # 4. serve: the default configuration, then A and B
    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt_dir:
        cfg, sep = build_server("cuda", ckpt_dir)
    log(f"server: ResUNet30 {cfg.model.compute_dtype}, "
        f"{sum(p.numel() for p in sep.model.parameters()) / 1e6:.1f} M "
        f"params; caption encoder RoBERTa-base, random weights, "
        f"{'fallback hash' if sep.query_encoder.using_fallback_tokenizer else 'BPE'}"
        f" tokenizer")
    reset_kernel_counts()
    request_s, default_waves = serve(sep, SERVE_REQUESTS)
    launches = kernel_counts()
    log(f"launches during default serving: {launches}")
    if sep.query_encoder.embed_cache_hits < 1:
        raise AssertionError("the repeated caption missed the caption cache")
    fused = serve_fused(sep, default_waves)
    for config, (counts, _) in fused.items():
        for name, n in counts.items():
            launches[name] += n
    RESULTS.update(request_ms=[x * 1e3 for x in request_s],
                   fused_vs_default_rel_err={c: e for c, (_, e) in
                                             fused.items()},
                   launches_phase4=dict(launches))

    # 4b. evaluation, int8 and chunked serving
    evaluation, eval_launches = eval_int8_chunked(sep, cfg, build_dir)
    for name, n in eval_launches.items():
        launches[name] += n
    RESULTS.update(evaluation=evaluation, launches_phase4b=eval_launches)

    # 4c. audio-queried serving (the CLAP audio tower)
    audio, audio_launches = audio_serving(sep)
    for name, n in audio_launches.items():
        launches[name] += n
    RESULTS.update(audio=audio, launches_phase4c=audio_launches)
    torch.cuda.empty_cache()

    # 4d. caption branches (BERT, BART, the clap CLI's pack, CLIP-style)
    captions, caption_launches = caption_branches(sep, build_dir)
    for name, n in caption_launches.items():
        launches[name] += n
    RESULTS.update(caption_branches=captions,
                   launches_phase4d=caption_launches)

    # 5. card vs CPU
    RESULTS["f32_card_vs_cpu_rel_err"] = card_vs_cpu(sep)
    RESULTS["audio_tower_card_vs_cpu"] = audio_card_vs_cpu(sep.query_encoder)
    RESULTS["configA_bf16_card_vs_cpu_rel_err"] = card_vs_cpu(
        sep, "A", "bfloat16", batch=1, seed=6, limit=BF16_FORWARD_REL)

    # 6. times
    forward = {}
    for config in ("default", "A", "B"):
        model = sep.model if config == "default" else fused_server(
            sep, config).model
        fwd_ms, peak = time_forward(model)
        forward[config] = {"ms": fwd_ms, "clips_per_s": 16 / (fwd_ms / 1e3),
                           "peak_gib": peak / 2 ** 30}
        log(f"forward B=16 x 10 s bf16, config {config}: {fwd_ms:.2f} ms "
            f"median, {16 / (fwd_ms / 1e3):.1f} clips/s, peak memory "
            f"{peak / 2**30:.2f} GiB")
        del model
        torch.cuda.empty_cache()
    cap_ms = time_captions(sep.query_encoder)
    log(f"caption encoding, 16 captions: {cap_ms:.2f} ms median")
    masks = {}
    for name, b2 in (("apply_complex_mask_ri", False),
                     ("apply_complex_mask", True)):
        masks[name] = time_mask_kernel(b2)
        log(mask_time_line(name, masks[name]))
    rows, totals = time_fused_kernels()
    for name, what in (("fused_act_conv3x3", "config-A forward (8 launches)"),
                       ("fused_residual_conv_block",
                        "config-B forward (1 launch)"),
                       ("fused_act_convT", "A or B forward (2 launches)")):
        tot = totals[name]
        log(f"{name} per {what}: {tot['ms']:.3f} ms, bound "
            f"{tot['bound_ms']:.3f} ms, context at the same shapes "
            f"{tot['context_ms']:.3f} ms")
    timetap, timetap_rows = time_timetap()
    log(f"timetap_conv at its best t_tile {timetap['t_tile']}: "
        f"{timetap['ms']:.3f} ms, plain {timetap['plain_ms']:.3f} ms, "
        f"cuDNN (3, 1) conv {timetap['library_ms']:.3f} ms, bound "
        f"{timetap['bound_ms']:.3f} ms ({timetap['bound_by']}); "
        f"{timetap['launches']} launches")
    torch.cuda.empty_cache()
    train_time = time_train_steps(sep, TRAIN_BATCH)
    log(f"train step bf16, {TRAIN_BATCH} x 10 s: {train_time['step_ms']:.1f}"
        f" ms, {train_time['steps_per_s']:.2f} steps/s, "
        f"{train_time['clips_per_s']:.1f} clips/s, peak memory "
        f"{train_time['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()
    hybrid_time = time_hybrid_steps(sep, TRAIN_BATCH)
    log(f"hybrid train step bf16, {TRAIN_BATCH} x 10 s (mix, 'hybird' "
        f"condition, premixed step): audio draw "
        f"{hybrid_time['audio_step_ms']:.1f} ms, text draw "
        f"{hybrid_time['text_step_ms']:.1f} ms, "
        f"{hybrid_time['steps_per_s']:.2f} steps/s at use_text_ratio 0.5")
    torch.cuda.empty_cache()
    RESULTS.update(forward=forward, caption_ms=cap_ms, mask_kernels=masks,
                   fused_kernel_rows=rows, fused_kernel_totals=totals,
                   timetap=timetap, microbench_rows=timetap_rows,
                   train_step=train_time, hybrid_train_step=hybrid_time)

    # 7. training through the CLI, resume, and serving its checkpoint
    training, train_launches = train(sep, build_dir)
    for name, n in train_launches.items():
        launches[name] += n
    RESULTS.update(training=training, launches_phase7=train_launches)

    # 7b. hybrid training (text and audio conditioning) and its resume
    hybrid, hybrid_launches = hybrid_train(sep, build_dir)
    for name, n in hybrid_launches.items():
        launches[name] += n
    RESULTS.update(hybrid_training=hybrid, launches_phase7b=hybrid_launches)

    # 8. the float32 train step, card vs CPU
    RESULTS["train_step_card_vs_cpu_rel_err"] = train_step_card_vs_cpu(sep)

    # 9. the precomputed-STFT variants: precompute, forward, training
    variant, variant_launches = variants(sep, build_dir)
    for name, n in variant_launches.items():
        launches[name] += n
    RESULTS.update(variants=variant, launches_phase9=variant_launches)
    del sep
    torch.cuda.empty_cache()

    # 10. CLAP pretraining and probing (no kernel of B1-B7 on these paths)
    RESULTS["clap"] = clap_pretraining(build_dir)

    # 11. data parallelism: ranks against one process, torchrun, the codec
    parallel, parallel_launches = data_parallel(build_dir)
    for name, n in parallel_launches.items():
        launches[name] += n
    RESULTS.update(parallel=parallel, launches_phase11=parallel_launches)

    # 12. tensor parallelism, the prefetching CLI, the soak
    tp, tp_launches = tensor_parallel(build_dir)
    for name, n in tp_launches.items():
        launches[name] += n
    RESULTS.update(tensor_parallel=tp, launches_phase12=tp_launches)

    kernels = []
    for name, _, _, source, replaces in KERNELS:
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces}
        if name in masks:
            m = masks[name]
            row.update(launches=b2_launches if name == "apply_complex_mask"
                       else launches[name],
                       max_abs_err=b2_err if name == "apply_complex_mask"
                       else mask_err, ms=m["ms"], plain_ms=m["plain_ms"],
                       bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                       library_ms=None)
        elif name == "timetap_conv":
            row.update(launches=timetap["launches"], max_abs_err=timetap_err,
                       ms=timetap["ms"], plain_ms=timetap["plain_ms"],
                       bound_ms=timetap["bound_ms"],
                       bound_by=timetap["bound_by"],
                       library_ms=timetap["library_ms"])
        else:  # the fused kernels: times summed over their launches in
            # one forward
            tot = totals[name]
            row.update(launches=launches[name], max_abs_err=fused_err[name],
                       ms=tot["ms"], plain_ms=tot["plain_ms"],
                       bound_ms=tot["bound_ms"],
                       bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                                 else "operations"),
                       library_ms=None)
        kernels.append(row)
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError(f"a kernel was not launched: " + ", ".join(
            f"{k['name']} {k['launches']}" for k in kernels))
    RESULTS["kernels"] = kernels
    print(json.dumps({"kernels": kernels}))
    return finish(torch)


def finish(torch, details="chip_smoke.json"):
    """Write every result to chiprun_out/``details``; print the card's
    line and the last line."""
    RESULTS["card"] = card_line()
    path = os.path.join(REPO, "chiprun_out", details)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(RESULTS, f, indent=1, default=str)
    print(RESULTS["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
