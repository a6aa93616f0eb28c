"""Linear-probe training (counterpart of scripts/linear_probe.py): a probe
head on a frozen CLAP audio trunk, trained on tagged audio shards.

    python -m lass_torch.linear_probe --workspace WS \\
        --train_shards 'shards/train-{000000..000009}.tar' \\
        --class_index classes.json [--val_shards ...] \\
        [--amodel HTSAT-tiny|HTSAT-base|PANN-14] [--mlp] \\
        [--loss bce|ce|mse] [--init_npz clap_pack.npz] [--device cuda]

The JAX CLI's flags and defaults. Shards hold key.wav or key.flac +
key.json with a ``tag`` list (``lass_torch.data.shards``);
``--class_index`` maps tag -> column. Only ``lp_layer`` trains: Adam
(0.9, 0.999, 1e-8) with decoupled weight decay ``--wd`` under the cosine
warm-up schedule, on ``lp_loss(--loss)``; the MLP head's dropout draws
from a generator seeded from (seed + 1, step). ``--init_npz`` loads the
trunk from a CLAP pack (scripts/convert_checkpoint.py ``--kind clap``)
the way ``CLAPQueryEncoder.from_npz`` reads one; without it the trunk is
random and the metrics mean nothing. LPMetrics (mAP, acc, mAUC) on
``--val_shards`` every ``--eval_every`` steps and at the end ("final lp
metrics: {...}"). Checkpoints (step 1 and every ``--save_every`` steps)
under ``WS/checkpoints/linear_probe/linear_probe,devices=1/``; metrics
(lp_loss, steps_per_sec, load_s, decode_s) in ``metrics.jsonl`` at step 1
and every ``--log_every`` steps. Runs on the GPU unless ``--device cpu``
is given.
"""
import argparse
import json
import logging

SAMPLE_RATE = 48000


def parser():
    p = argparse.ArgumentParser(prog="python -m lass_torch.linear_probe")
    p.add_argument("--workspace", required=True)
    p.add_argument("--train_shards", nargs="+", required=True)
    p.add_argument("--val_shards", nargs="+", default=None)
    p.add_argument("--class_index", required=True,
                   help="JSON file: {tag: column}")
    p.add_argument("--amodel", default="HTSAT-base",
                   choices=["HTSAT-tiny", "HTSAT-base", "PANN-14"])
    p.add_argument("--mlp", action="store_true", help="MLP probe head")
    p.add_argument("--loss", default="bce", choices=["bce", "ce", "mse"])
    p.add_argument("--act", default=None,
                   choices=[None, "None", "relu", "elu", "sigmoid",
                            "softmax"])
    p.add_argument("--init_npz", default=None,
                   help="converted CLAP pack to initialize the frozen trunk")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--clip_seconds", type=float, default=10.0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--warmup", type=int, default=3200)
    p.add_argument("--total_steps", type=int, default=100000)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--eval_every", type=int, default=5000)
    p.add_argument("--save_every", type=int, default=10000)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    p.add_argument("--log_every", type=int, default=50,
                   help="Steps between metric records (step 1 is always "
                        "recorded).")
    p.add_argument("--launch_counts", default=None,
                   help="Write the kernels' launch counts here (JSON) at "
                        "exit.")
    return p


def build_task(args, n_classes: int, device):
    """The run's ``ProbeTask`` on ``device``: the probe ``--amodel`` names
    (``build_probe``), ``--loss``, ``--lr``, ``--wd`` under the cosine
    warm-up schedule, dropout draws seeded from ``--seed`` + 1."""
    from lass_torch.tasks.linear_probe import ProbeTask
    from lass_torch.train.optim import cosine_warm_up

    return ProbeTask(build_probe(args, n_classes).to(device), loss=args.loss,
                     lr=args.lr, weight_decay=args.wd,
                     schedule=cosine_warm_up(args.warmup, args.total_steps),
                     seed=args.seed + 1)


def build_probe(args, n_classes: int):
    """The probe ``--amodel`` names (random weights seeded by ``--seed``),
    its trunk from ``--init_npz`` when given."""
    import torch

    from lass_torch.models.clap.htsat import (
        htsat_base_config, htsat_tiny_config)
    from lass_torch.models.clap.linear_probe import LinearProbe

    torch.manual_seed(args.seed)
    if args.amodel == "PANN-14":
        probe = LinearProbe(n_classes, mlp=args.mlp, act=args.act,
                            audio_model="PANN")
    else:
        cfg = (htsat_tiny_config() if args.amodel == "HTSAT-tiny"
               else htsat_base_config())
        probe = LinearProbe(n_classes, mlp=args.mlp, act=args.act,
                            audio_model="HTSAT", audio_cfg=cfg)
    if args.init_npz:
        from lass_torch.convert.checkpoint_io import load_npz_variables
        from lass_torch.convert.from_jax import (
            clap_audio_state_dict_from_jax,
            clap_pann_audio_state_dict_from_jax)

        pack = load_npz_variables(args.init_npz)
        if "audio" not in pack:
            raise SystemExit(f"{args.init_npz}: no audio branch in pack")
        audio = pack["audio"]
        audio.setdefault("batch_stats", {})
        sd = (clap_pann_audio_state_dict_from_jax(audio)
              if args.amodel == "PANN-14" else clap_audio_state_dict_from_jax(
                  audio, probe.clap_model.audio_branch.cfg.depths))
        probe.clap_model.load_state_dict(sd)
        logging.info("trunk initialized from %s", args.init_npz)
    else:
        logging.warning(
            "linear probe trunk is RANDOM-INIT (no --init_npz): probe "
            "metrics will be meaningless; convert a CLAP checkpoint with "
            "scripts/convert_checkpoint.py --kind clap")
    return probe


def main(argv=None):
    args = parser().parse_args(argv)

    import numpy as np
    import torch

    from lass_torch.data.shards import TarShardDataset, shard_epochs
    from lass_torch.evaluation.linear_probe import LPMetrics
    from lass_torch.train.checkpoint import CheckpointManager
    from lass_torch.train.cli_loop import run_steps
    from lass_torch.train.loop import get_dirs
    from lass_torch.utils.logging import MetricsLogger, create_logging

    device = torch.device(args.device)
    ckpt_dir, logs_dir, tf_logs_dir, _ = get_dirs(
        args.workspace, "linear_probe", "linear_probe.yaml", 1)
    create_logging(logs_dir)
    with open(args.class_index) as f:
        class_index = json.load(f)
    clip_samples = int(SAMPLE_RATE * args.clip_seconds)
    task = build_task(args, len(class_index), device)

    def dataset(shards, train, epoch=0):
        return TarShardDataset(
            shards=shards, batch_size=args.batch_size, max_len=clip_samples,
            class_index_dict=class_index, num_workers=args.num_workers,
            seed=args.seed, train=train, epoch=epoch)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    @torch.no_grad()
    def evaluate():
        task.probe.eval()
        preds, targets = [], []
        for batch in dataset(args.val_shards, train=False):
            preds.append(task.probe(up(batch["waveform"])).double()
                         .cpu().numpy())
            targets.append(batch["class_label"])
        if not preds:
            return {}
        return LPMetrics().evaluate_metrics(np.concatenate(preds),
                                            np.concatenate(targets))

    stats = {"decode_s": 0.0}
    batches = ({"waveform": up(b["waveform"]),
                "class_label": up(b["class_label"])}
               for b in shard_epochs(
                   lambda epoch: dataset(args.train_shards, True, epoch),
                   stats))
    logging.info("linear_probe: %s, %d classes, loss=%s, mlp=%s, %s",
                 args.amodel, len(class_index), args.loss, args.mlp, device)
    run_steps(task, batches, CheckpointManager(ckpt_dir, args.save_every),
              MetricsLogger(tf_logs_dir), log_every=args.log_every,
              max_steps=args.max_steps, eval_every=args.eval_every,
              evaluate=evaluate if args.val_shards else None, stats=stats,
              launch_counts_path=args.launch_counts)
    if args.val_shards:
        final = evaluate()
        if final:
            print("final lp metrics:", final)
    print(f"finished at step {task.step}")


if __name__ == "__main__":
    main()
