"""Train the precomputed-STFT variants (counterpart of
scripts/train_multistft.py): the multi-resolution ResUNet30 or the
negative-query model, over ``batch_*.npz`` files of
``python -m lass_torch.precompute_stfts``:

    python -m lass_torch.train_multistft --workspace WS \\
        --config_yaml config/audiosep_base.yaml --precomputed_dir DIR \\
        [--variant multistft|negquery] [--max_steps N] [--device cuda] \\
        [--log_every 50] [--launch_counts PATH]

``multistft`` trains on every window the files hold, ``negquery`` on the
512 window with the fusion of each item's caption and its negative (the
second caption of its mixture). Each step is one stored file, loaded
whole; the files repeat in order. Checkpoints (step 1 and every
``train.save_step_frequency`` steps) go under
``WS/checkpoints/train_multistft/<config>,devices=1/<step>.ckpt`` and hold
the model, the negative-query fusion, optimizer, scheduler and step; as in
the JAX package's CLI there is no resume flag (restore from Python with
``lass_torch.train.checkpoint.restore_file`` on ``build_task``'s task).
Metrics (train_loss, grad_norm, steps_per_sec over the steps since the
last record, and load_s, the seconds spent loading the files) go to
``WS/tf_logs/.../metrics.jsonl`` at step 1 and every ``--log_every``
steps. Runs on the GPU unless ``--device cpu`` is given.
"""
import argparse


def build_task(cfg, variant: str, win_lengths, device):
    """The variant's task on ``device``: the model (seeded by
    train.random_seed), the fusion for ``negquery``, AMSGrad and its LR
    schedule over everything it trains."""
    import torch

    from lass_torch.models.resunet_multistft import build_multistft_model
    from lass_torch.tasks.audiosep_variants import (
        MultiSTFTAudioSepTask, NegQueryAudioSepTask, NegQueryFusion)
    from lass_torch.train.optim import build_optimizer

    torch.manual_seed(cfg.train.random_seed)
    model = build_multistft_model(cfg, win_lengths).to(device)
    modules = [model]
    if variant == "negquery":
        fusion = NegQueryFusion(cfg.model.condition_size).to(device)
        modules.append(fusion)
    opt = cfg.train.optimizer
    optimizer, scheduler = build_optimizer(
        [p for m in modules for p in m.parameters()], opt.optimizer_type,
        opt.learning_rate, opt.lr_lambda_type, opt.warm_up_steps,
        opt.reduce_lr_steps)
    if variant == "negquery":
        return NegQueryAudioSepTask(model, fusion, optimizer, scheduler)
    return MultiSTFTAudioSepTask(model, optimizer, scheduler)


def caption_encoder(cfg, device):
    """The frozen CLAP caption encoder (random weights unless a CLAP pack
    is loaded), seeded by train.random_seed on its own, so that every
    variant's run gets the same one."""
    import torch

    from lass_torch.models.query_encoder import CLAPQueryEncoder

    torch.manual_seed(cfg.train.random_seed)
    return CLAPQueryEncoder(device=str(device))


def to_device(raw, win_lengths, device):
    """The arrays a step reads (the mixture role of ``win_lengths`` and
    the target waveform) as tensors on ``device``."""
    import torch

    def up(a):
        return torch.from_numpy(a).to(device, non_blocking=True)

    mix = raw["stfts"]["mixture"]
    return {"stfts": {"mixture": {w: tuple(up(a) for a in mix[w])
                                  for w in win_lengths}},
            "target_waveform": up(raw["target_waveform"])}


def condition(query_encoder, raw, variant: str):
    """The frozen caption embedding, or for ``negquery`` the (pos, neg)
    pair of the captions and their negatives (copies of the encoder's
    inference-mode outputs, which autograd may not save)."""
    from lass_torch.tasks.audiosep_variants import negative_captions

    if variant == "negquery":
        negs = negative_captions(raw["text"], raw["mixture_component_texts"])
        pos, neg = query_encoder.get_query_embed("text", text=raw["text"],
                                                 text_neg=negs)
        return pos.clone(), neg.clone()
    return query_encoder.get_query_embed("text", text=raw["text"]).clone()


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m lass_torch.train_multistft")
    parser.add_argument("--workspace", required=True)
    parser.add_argument("--config_yaml", required=True)
    parser.add_argument("--precomputed_dir", required=True)
    parser.add_argument("--variant", default="multistft",
                        choices=["multistft", "negquery"])
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu.")
    parser.add_argument("--log_every", type=int, default=50,
                        help="Steps between metric records (step 1 is "
                             "always recorded).")
    parser.add_argument("--launch_counts", default=None,
                        help="Write the kernels' launch counts here (JSON) "
                             "at exit.")
    args = parser.parse_args(argv)

    import torch

    from lass_torch.config import load_config
    from lass_torch.data.precomputed import PrecomputedSTFTDataset
    from lass_torch.train.checkpoint import CheckpointManager
    from lass_torch.train.cli_loop import run_steps
    from lass_torch.train.loop import get_dirs
    from lass_torch.utils.logging import MetricsLogger, create_logging

    device = torch.device(args.device)
    cfg = load_config(args.config_yaml)
    dataset = PrecomputedSTFTDataset(args.precomputed_dir)
    if len(dataset) == 0:
        raise SystemExit(f"no precomputed batches in {args.precomputed_dir}")
    wins = tuple(dataset.win_lengths()) if args.variant == "multistft" \
        else (512,)
    ckpt_dir, logs_dir, tf_logs_dir, _ = get_dirs(
        args.workspace, "train_multistft", args.config_yaml, 1)
    create_logging(logs_dir)

    query_encoder = caption_encoder(cfg, device)
    task = build_task(cfg, args.variant, wins, device)
    run_steps(task, dataset.iterate_batches(loop=True),
              CheckpointManager(ckpt_dir, cfg.train.save_step_frequency),
              MetricsLogger(tf_logs_dir), log_every=args.log_every,
              max_steps=args.max_steps or cfg.train.early_stop_steps,
              train_step=lambda raw: task.train_step(
                  to_device(raw, wins, device),
                  condition(query_encoder, raw, args.variant)),
              launch_counts_path=args.launch_counts)
    print(f"finished at step {task.step}")


if __name__ == "__main__":
    main()
