"""Training soak with a mid-run kill and resume (counterpart of
scripts/soak.py):

1. a child process trains (``Trainer.fit``, the train CLI's loop: the
   synthetic corpus through the host pipeline, the prefetcher and the
   step) with periodic checkpoints and a DCASE eval hook;
2. once a checkpoint at or after ``--kill_after`` is on disk and one more
   logging window has landed, it is killed with SIGKILL (a crash, not a
   clean exit);
3. a fresh child resumes from the latest checkpoint and runs to
   ``--steps``; the resumed loop skips the batches already trained on, so
   it replays the batch sequence of the killed run;
4. the checks: the logged steps both runs share match byte for byte
   (train_loss and grad_norm), the last quintile's mean loss against the
   first quintile's, and the steps/s windows after the resume (stable:
   each within a factor of 2 of their median);
5. a JSON report (loss curve, steps/s, eval records, verdicts) goes to
   ``--report``; the run fails unless the overlap is byte-exact.

Both children set deterministic cuDNN, so a card's losses repeat to the
bit. On the card (the default device):

    python -m lass_torch.soak --steps 3000

CPU smoke (1 s segments, float32, a small random caption encoder):

    python -m lass_torch.soak --steps 7 --kill_after 4 --save_every 4 \\
        --eval_every 7 --log_every 1 --batch 1 --tiny --device cpu
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_trainer.py's small caption encoder (--tiny)
TINY_ROBERTA = dict(vocab_size=200, hidden_size=32, num_hidden_layers=1,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=80)


def segment_seconds(args) -> float:
    return 1.0 if args.tiny else 10.0


def build_workspace(args) -> str:
    """The synthetic corpus and the train config; returns its path."""
    from lass_torch.data.synth import make_synth_corpus, write_train_config

    os.makedirs(args.workspace, exist_ok=True)
    datafile = make_synth_corpus(os.path.join(args.workspace, "corpus"),
                                 num_clips=64 if args.tiny else 256)
    return write_train_config(
        os.path.join(args.workspace, "soak.yaml"), datafile,
        batch_size=args.batch, segment_seconds=segment_seconds(args),
        save_step_frequency=args.save_every,
        compute_dtype="float32" if args.tiny else "bfloat16",
        wire_dtype=args.wire, evaluate_step_frequency=args.eval_every)


def make_eval_hook(args):
    """A small DCASE eval over pairs of corpus clips (the eval path during
    training; random weights, so the SDRs only need to be finite)."""
    import numpy as np

    from lass_torch.audio.io import read_audio, write_wav
    from lass_torch.evaluation.dcase import (
        DCASEEvaluator, SeparationInference)

    wav_dir = os.path.join(args.workspace, "corpus", "wavs")
    eval_dir = os.path.join(args.workspace, "eval")
    os.makedirs(eval_dir, exist_ok=True)
    sr = 16000
    seg = int(segment_seconds(args) * sr)
    names = sorted(os.listdir(wav_dir))[:8]
    csv_path = os.path.join(eval_dir, "eval.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["source", "noise", "snr", "caption"])
        for i in range(0, len(names) - 1, 2):
            for kind, name in (("src", names[i]), ("noise", names[i + 1])):
                wav, _ = read_audio(os.path.join(wav_dir, name))
                out = np.zeros((1, seg), np.float32)
                out[0, :min(seg, wav.shape[-1])] = wav[0, :seg]
                write_wav(os.path.join(eval_dir, f"{kind}{i}.wav"), out, sr)
            w.writerow([f"src{i}", f"noise{i}", "0", f"synthetic pair {i}"])
    evaluator = DCASEEvaluator(sr, csv_path, eval_dir, batch_size=4,
                               pad_seconds=segment_seconds(args))

    def hook(trainer, step):
        model = SeparationInference(trainer.task.model,
                                    trainer.query_encoder,
                                    device=str(trainer.device))
        sisdr, sdri, sdr = evaluator(model)
        return {"eval_SISDR": sisdr, "eval_SDRi": sdri, "eval_SDR": sdr}

    return hook


def tiny_encoder(device: str):
    """A small random caption encoder, the same weights in every run."""
    import torch

    from lass_torch.models.clap.roberta import RobertaConfig
    from lass_torch.models.clap.tokenizer import WhitespaceFallbackTokenizer
    from lass_torch.models.query_encoder import CLAPQueryEncoder

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return CLAPQueryEncoder(roberta_cfg=RobertaConfig(**TINY_ROBERTA),
                                tokenizer=WhitespaceFallbackTokenizer(200),
                                device=device)


def phase_train(args) -> None:
    """Child process: train (or resume) to ``args.steps``."""
    import torch

    from lass_torch.train.loop import Trainer

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    config = build_workspace(args)
    resume = None
    if args.resume:
        dirs = glob.glob(os.path.join(args.workspace, "checkpoints", "train",
                                      "*"))
        if not dirs:
            raise SystemExit("resume asked for, but there is no checkpoint "
                             "directory")
        resume = dirs[0]
    trainer = Trainer(config, args.workspace, resume_checkpoint_path=resume,
                      device=args.device, log_every=args.log_every,
                      query_encoder=(tiny_encoder(args.device) if args.tiny
                                     else None))
    trainer.fit(max_steps=args.steps, eval_hook=make_eval_hook(args))
    print("phase_train done", json.dumps(trainer.timing), flush=True)


def read_metrics(workspace: str) -> list:
    records = []
    for path in glob.glob(os.path.join(workspace, "tf_logs", "**",
                                       "metrics.jsonl"), recursive=True):
        with open(path) as f:
            for line in f:
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    pass  # a line torn by the kill
    return records


def checkpoint_steps(workspace: str) -> list:
    """Steps of the checkpoints on disk (a file exists only once whole)."""
    return sorted(int(os.path.basename(p)[:-len(".ckpt")]) for p in glob.glob(
        os.path.join(workspace, "checkpoints", "train", "*", "*.ckpt")))


def split_runs(records: list) -> list:
    """The train_loss records appended by several runs, by run: a step that
    does not pass the last one starts a run (an eval record shares its
    step with a train record, so it is left out)."""
    runs, cur, last = [], [], None
    for r in records:
        if "train_loss" not in r:
            continue
        if last is not None and r["step"] <= last:
            runs.append(cur)
            cur = []
        cur.append(r)
        last = r["step"]
    runs.append(cur)
    return runs


def child_command(args) -> list:
    cmd = [sys.executable, "-m", "lass_torch.soak", "--phase", "train",
           "--steps", str(args.steps), "--workspace", args.workspace,
           "--batch", str(args.batch), "--save_every", str(args.save_every),
           "--eval_every", str(args.eval_every), "--wire", args.wire,
           "--log_every", str(args.log_every), "--device", args.device]
    return cmd + (["--tiny"] if args.tiny else [])


def orchestrate(args) -> dict:
    start = time.time()
    os.makedirs(args.workspace, exist_ok=True)
    cmd = child_command(args)

    # run A: train until a checkpoint at or after kill_after is on disk and
    # a later logging window has landed, then SIGKILL it
    with open(os.path.join(args.workspace, "runA.log"), "w") as log_a:
        proc = subprocess.Popen(cmd, stdout=log_a, stderr=log_a, cwd=REPO)
        killed_at = None
        try:
            while proc.poll() is None:
                time.sleep(0.2)
                ckpts = [s for s in checkpoint_steps(args.workspace)
                         if s >= args.kill_after]
                if not ckpts:
                    continue
                recs = [r for r in read_metrics(args.workspace)
                        if "train_loss" in r]
                if recs and recs[-1]["step"] >= ckpts[0] + args.log_every:
                    os.kill(proc.pid, signal.SIGKILL)
                    proc.wait()
                    killed_at = recs[-1]["step"]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if killed_at is None:
        raise SystemExit(f"run A ended before the kill (rc={proc.returncode})"
                         f"; see {args.workspace}/runA.log")
    resume_step = checkpoint_steps(args.workspace)[-1]
    print(f"run A killed after step {killed_at}; latest checkpoint "
          f"{resume_step}", flush=True)

    # run B: resume to the end
    with open(os.path.join(args.workspace, "runB.log"), "w") as log_b:
        rc = subprocess.run(cmd + ["--resume"], stdout=log_b, stderr=log_b,
                            cwd=REPO).returncode
    if rc != 0:
        raise SystemExit(f"the resumed run failed (rc={rc}); see "
                         f"{args.workspace}/runB.log")

    records = read_metrics(args.workspace)
    runs = split_runs(records)
    if len(runs) < 2:
        raise SystemExit(f"expected two runs in the metrics, got {len(runs)}")
    run_a = {r["step"]: r for r in runs[0]}
    run_b = {r["step"]: r for r in runs[-1]}
    overlap = sorted(set(run_a) & set(run_b))
    exact = bool(overlap) and all(
        run_a[s]["train_loss"] == run_b[s]["train_loss"]
        and run_a[s]["grad_norm"] == run_b[s]["grad_norm"] for s in overlap)
    losses = sorted([(s, r["train_loss"]) for s, r in run_a.items()]
                    + [(s, r["train_loss"]) for s, r in run_b.items()
                       if s not in run_a])
    vals = [v for _, v in losses]
    q = max(len(vals) // 5, 1)
    first_q, last_q = sum(vals[:q]) / q, sum(vals[-q:]) / q
    # the resumed run's windows after its first (which holds the start-up)
    sps = [r["steps_per_sec"] for r in runs[-1]][1:]
    stable = bool(sps) and all(
        0.5 <= s / statistics.median(sps) <= 2.0 for s in sps)
    report = {
        "steps": args.steps, "batch": args.batch, "device": args.device,
        "killed_at_step": killed_at, "resumed_from_step": resume_step,
        "overlap_steps_compared": overlap, "resume_byte_exact": exact,
        "loss_first_quintile": first_q, "loss_last_quintile": last_q,
        "loss_decreasing": last_q < first_q,
        "steps_per_sec_post_resume": sps, "steps_per_sec_stable": stable,
        "eval_records": [r for r in records if "eval_SDR" in r],
        "loss_curve": losses, "wall_seconds": time.time() - start,
    }
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items()
                      if k != "loss_curve"}), flush=True)
    if not exact:
        raise SystemExit("the resumed run's overlapping metrics are not "
                         "byte-exact")
    print(f"SOAK OK -> {args.report}", flush=True)
    return report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m lass_torch.soak")
    ap.add_argument("--phase", choices=["orchestrate", "train"],
                    default="orchestrate")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--kill_after", type=int, default=None,
                    help="kill run A once a checkpoint at or after this "
                         "step and one more logging window are in "
                         "(default: steps // 2)")
    ap.add_argument("--workspace", default=os.path.join(
        tempfile.gettempdir(), "lass_torch_soak"))
    ap.add_argument("--report", default=None,
                    help="the JSON report (default: <workspace>/soak.json)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--save_every", type=int, default=500)
    ap.add_argument("--eval_every", type=int, default=1000)
    ap.add_argument("--log_every", type=int, default=50,
                    help="steps between logged losses")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="1 s segments, float32 and a small caption encoder "
                         "(the CPU smoke)")
    ap.add_argument("--wire", default="float32", choices=["float32", "int16"],
                    help="train.wire_dtype (int16 halves the upload)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if args.kill_after is None:
        args.kill_after = args.steps // 2
    if args.report is None:
        args.report = os.path.join(args.workspace, "soak.json")
    if args.phase == "train":
        phase_train(args)
        return
    first_ckpt = -(-args.kill_after // args.save_every) * args.save_every
    if first_ckpt + args.log_every >= args.steps:
        raise SystemExit(
            f"no room to kill run A: the first checkpoint it waits for is "
            f"at step {first_ckpt} (save_every={args.save_every}, "
            f"kill_after={args.kill_after}), then one more logging window "
            f"of {args.log_every} steps, but --steps is {args.steps}")
    orchestrate(args)


if __name__ == "__main__":
    main()
