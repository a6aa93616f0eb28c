"""CLAP contrastive pretraining (counterpart of scripts/clap_pretrain.py):

    python -m lass_torch.clap_pretrain --workspace WS \\
        (--datafiles D.json ... | --train_shards 'train-{000000..000009}.tar')
        [--val_datafiles V.json] [--amodel HTSAT-tiny|HTSAT-base|PANN-14]
        [--batch_size 32] [--max_steps N] [--device cuda]

The JAX CLI's flags and defaults: datafile JSONs of (wav, caption) pairs
through ``AudioTextDataset`` + ``DataModule`` at 48 kHz, or tar shards
(key.wav or key.flac + key.json per sample) through ``TarShardDataset``;
the random-init RoBERTa-base text tower and an HTSAT or PANN-14 audio
tower; ``CLAPPretrainTask`` (ClipLoss with two clamped scales, AdamW
(beta1, beta2, eps, wd) under the cosine warm-up schedule); retrieval on
``--val_datafiles`` every ``--eval_every`` steps and at the end ("final
retrieval: {...}"). Captions go through the RoBERTa BPE tokenizer when its
vocab is installed, else the whitespace hash tokenizer, padded to the
longest in the batch up to ``--max_text_len``.

Float32. On several cards (``python -m torch.distributed.run
--nproc_per_node N -m lass_torch.clap_pretrain ...``), as the JAX CLI over
its mesh: ``--batch_size`` is the global batch, each rank loading
``batch_size / N`` rows of its own shards (or its strided share of the
datafiles) and tokenizing its own captions; the step is the global
batch's (``lass_torch.tasks.clap_pretrain``); retrieval embeds each
rank's share of the val clips and gathers the embeddings; rank 0 alone
logs, writes metrics and checkpoints and prints. Checkpoints (step 1 and
every ``--save_every`` steps) go under
``WS/checkpoints/clap_pretrain/clap_pretrain,devices=N/``;
as in the JAX CLI there is no resume flag (restore from Python with
``lass_torch.train.checkpoint.restore_file`` on ``build_task``'s task).
Metrics go to ``WS/tf_logs/.../metrics.jsonl`` at step 1 and every
``--log_every`` steps: contrastive_loss, both logit scales, steps_per_sec
over the steps since the last record, load_s (seconds waiting for
batches) and, over shards, decode_s (the part of it spent decoding
audio). Runs on the GPU unless ``--device cpu`` is given.
"""
import argparse
import logging

SAMPLE_RATE = 48000


def parser():
    p = argparse.ArgumentParser(prog="python -m lass_torch.clap_pretrain")
    p.add_argument("--workspace", required=True)
    p.add_argument("--datafiles", nargs="+", default=None)
    p.add_argument("--train_shards", nargs="+", default=None,
                   help="tar shards (key.wav or key.flac + key.json per "
                        "sample; brace patterns OK)")
    p.add_argument("--data_filling", default="repeatpad",
                   choices=["repeatpad", "pad", "repeat"])
    p.add_argument("--data_truncating", default="rand_trunc",
                   choices=["rand_trunc", "fusion"])
    p.add_argument("--text_augment_selection", default=None,
                   choices=[None, "none", "all", "augment_only"])
    p.add_argument("--val_datafiles", nargs="+", default=None)
    p.add_argument("--amodel", default="HTSAT-base",
                   choices=["HTSAT-tiny", "HTSAT-base", "PANN-14"])
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--clip_seconds", type=float, default=10.0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.99)
    p.add_argument("--eps", type=float, default=1e-8)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--warmup", type=int, default=3200)
    p.add_argument("--total_steps", type=int, default=1000000)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--eval_every", type=int, default=10000)
    p.add_argument("--save_every", type=int, default=20000)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_text_len", type=int, default=77)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    p.add_argument("--log_every", type=int, default=50,
                   help="Steps between metric records (step 1 is always "
                        "recorded).")
    p.add_argument("--launch_counts", default=None,
                   help="Write the kernels' launch counts here (JSON) at "
                        "exit.")
    return p


def audio_encoder(amodel: str):
    """The CLAP audio tower ``--amodel`` names, random weights."""
    from lass_torch.models.clap.htsat import (
        htsat_base_config, htsat_tiny_config)
    from lass_torch.models.clap.model import (
        CLAPAudioEncoder, CLAPPANNAudioEncoder)

    if amodel == "PANN-14":
        return CLAPPANNAudioEncoder()
    return CLAPAudioEncoder(htsat_tiny_config() if amodel == "HTSAT-tiny"
                            else htsat_base_config())


def build_task(args, device):
    """The run's task on ``device``: both towers (seeded by ``--seed``),
    the logit scales, AdamW and its schedule."""
    import torch

    from lass_torch.models.clap.model import CLAPTextEncoder
    from lass_torch.tasks.clap_pretrain import CLAPPretrainTask
    from lass_torch.train.optim import cosine_warm_up

    torch.manual_seed(args.seed)
    audio = audio_encoder(args.amodel).to(device)
    text = CLAPTextEncoder().to(device)
    return CLAPPretrainTask(
        audio, text, lr=args.lr, betas=(args.beta1, args.beta2),
        eps=args.eps, weight_decay=args.wd,
        schedule=cosine_warm_up(args.warmup, args.total_steps),
        seed=args.seed)


def make_tokenizer():
    from lass_torch.models.clap.tokenizer import (
        RobertaBPETokenizer, WhitespaceFallbackTokenizer)

    try:
        return RobertaBPETokenizer()
    except FileNotFoundError:
        logging.warning("RoBERTa BPE assets not found: the whitespace hash "
                        "tokenizer (smoke runs only)")
        return WhitespaceFallbackTokenizer(50265)


def to_device(waveform, texts, tokenizer, max_text_len, device):
    """A batch as the task takes it: the waveform and the tokenized
    captions on ``device``."""
    import numpy as np
    import torch

    tok = tokenizer(list(texts), max_length=max_text_len, pad_to=None)
    return {"waveform": torch.from_numpy(
                np.ascontiguousarray(waveform, np.float32)).to(device),
            "input_ids": torch.from_numpy(
                np.asarray(tok["input_ids"], np.int64)).to(device),
            "attention_mask": torch.from_numpy(
                np.asarray(tok["attention_mask"], np.int64)).to(device)}


def rank_batch(args) -> int:
    """This rank's rows of the global ``--batch_size``."""
    from lass_torch.parallel.host import host_info

    _, world = host_info()
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} is not divisible "
                         f"by the {world} ranks")
    return args.batch_size // world


def shard_batches(args, clip_samples, stats):
    """Epoch-looped tar-shard batches (waveform, captions) of this rank's
    shards; ``stats`` accumulates the decode seconds."""
    from lass_torch.data.shards import TarShardDataset, shard_epochs
    from lass_torch.parallel.host import host_info

    rank, world = host_info()

    def dataset(epoch):
        return TarShardDataset(
            shards=args.train_shards, batch_size=rank_batch(args),
            max_len=clip_samples, data_filling=args.data_filling,
            data_truncating=args.data_truncating,
            text_augment_selection=args.text_augment_selection,
            num_workers=args.num_workers, seed=args.seed, epoch=epoch,
            process_index=rank, process_count=world)

    return ((b["waveform"], b["raw_text"])
            for b in shard_epochs(dataset, stats))


def datafile_batches(loader):
    for batch in loader:
        at = batch["audio_text"]
        yield at["waveform"][:, 0], at["text"]


def evaluate(args, task, tokenizer, device):
    """Retrieval metrics over ``--val_datafiles`` (whole batches of
    ``--batch_size``, as the JAX CLI); {} without them. On several ranks
    each embeds whole batches of its strided share and the embeddings are
    gathered (every rank gets the metrics)."""
    import numpy as np
    import torch

    from lass_torch.data.datafiles import AudioTextDataset
    from lass_torch.data.datamodule import DataModule
    from lass_torch.evaluation.retrieval import retrieval_metrics
    from lass_torch.parallel.host import gather_rows, host_info

    if not args.val_datafiles:
        return {}
    rank, world = host_info()
    val = AudioTextDataset(datafiles=args.val_datafiles,
                           sampling_rate=SAMPLE_RATE,
                           max_clip_len=args.clip_seconds)
    batch = rank_batch(args)
    share = len(val) // world
    a_all, t_all, seen = [], [], 0
    with DataModule(val, batch_size=batch, num_workers=args.num_workers,
                    seed=1, process_index=rank,
                    process_count=world).train_dataloader() as loader:
        for b in loader:
            at = b["audio_text"]
            data = to_device(at["waveform"][:, 0], at["text"], tokenizer,
                             args.max_text_len, device)
            a, t = task.embed(data["waveform"], data["input_ids"],
                              data["attention_mask"])
            a_all.append(a)
            t_all.append(t)
            seen += len(at["text"])
            if seen + batch > share:
                break
    a, t = (gather_rows(torch.cat(x)).double().cpu().numpy()
            for x in (a_all, t_all))
    return retrieval_metrics(a, t)


def main(argv=None):
    args = parser().parse_args(argv)
    if bool(args.datafiles) == bool(args.train_shards):
        parser().error("exactly one of --datafiles / --train_shards")

    import torch

    from lass_torch.parallel.host import host_info, initialize_distributed
    from lass_torch.train.checkpoint import CheckpointManager
    from lass_torch.train.cli_loop import run_steps
    from lass_torch.train.loop import get_dirs
    from lass_torch.utils.logging import MetricsLogger, create_logging

    device = initialize_distributed(device=args.device)
    rank, world = host_info()
    ckpt_dir, logs_dir, tf_logs_dir, _ = get_dirs(
        args.workspace, "clap_pretrain", "clap_pretrain.yaml", world)
    create_logging(logs_dir, main_process=rank == 0)
    clip_samples = int(SAMPLE_RATE * args.clip_seconds)
    tokenizer = make_tokenizer()
    task = build_task(args, device)
    stats = loader = None
    if args.train_shards:
        from lass_torch.data.shards import TarShardDataset

        stats = {"decode_s": 0.0}
        raw = shard_batches(args, clip_samples, stats)
        n_train = TarShardDataset(shards=args.train_shards, batch_size=1,
                                  max_len=clip_samples).num_samples or -1
    else:
        from lass_torch.data.datafiles import AudioTextDataset
        from lass_torch.data.datamodule import DataModule

        dataset = AudioTextDataset(datafiles=args.datafiles,
                                   sampling_rate=SAMPLE_RATE,
                                   max_clip_len=args.clip_seconds)
        loader = DataModule(dataset, batch_size=rank_batch(args),
                            num_workers=args.num_workers, seed=args.seed,
                            process_index=rank,
                            process_count=world).train_dataloader()
        raw = datafile_batches(loader)
        n_train = len(dataset)
    logging.info("clap_pretrain: %s, %d train items, batch %d, %s",
                 args.amodel, n_train, args.batch_size, device)
    batches = (to_device(waveform, texts, tokenizer, args.max_text_len,
                         device) for waveform, texts in raw)
    try:
        run_steps(task, batches, CheckpointManager(ckpt_dir, args.save_every),
                  MetricsLogger(tf_logs_dir, enabled=rank == 0),
                  log_every=args.log_every,
                  max_steps=args.max_steps, eval_every=args.eval_every,
                  evaluate=(lambda: evaluate(args, task, tokenizer, device))
                  if args.val_datafiles else None, stats=stats,
                  launch_counts_path=args.launch_counts)
    finally:
        if loader is not None:
            loader.close()
    if args.val_datafiles:
        final = evaluate(args, task, tokenizer, device)
        if rank == 0:
            print("final retrieval:", final)
    if rank == 0:
        print(f"finished at step {task.step}")


if __name__ == "__main__":
    main()
