"""Offline STFT precompute CLI (counterpart of scripts/precompute_stfts.py),
the two modes of the reference's pipeline:

    python -m lass_torch.precompute_stfts --mode generate_recipes \\
        --config_yaml config/audiosep_base.yaml --output_file recipes.json
    python -m lass_torch.precompute_stfts --mode compute_stfts \\
        --config_yaml config/audiosep_base.yaml --recipes recipes.json \\
        --output_dir precomputed/ [--device cuda]

``compute_stfts`` mixes and runs the STFT bank (``data.stft_win_lengths``
at ``data.stft_hop_length``) on the GPU unless ``--device cpu`` is given.
The recipes and files are the JAX package's: either package reads what
the other wrote.
"""
import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m lass_torch.precompute_stfts")
    parser.add_argument("--mode", required=True,
                        choices=["generate_recipes", "compute_stfts"])
    parser.add_argument("--config_yaml", required=True)
    parser.add_argument("--output_file", default="recipes.json")
    parser.add_argument("--recipes", default="recipes.json")
    parser.add_argument("--output_dir", default="precomputed")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu.")
    args = parser.parse_args(argv)

    from lass_torch.config import load_config
    from lass_torch.data.datafiles import AudioTextDataset
    from lass_torch.data.precompute import (
        compute_stfts, generate_recipes, load_recipes, save_recipes)

    cfg = load_config(args.config_yaml)
    dataset = AudioTextDataset(
        datafiles=cfg.data.datafiles,
        sampling_rate=cfg.data.sampling_rate,
        max_clip_len=cfg.data.segment_seconds,
    )

    if args.mode == "generate_recipes":
        recipes = generate_recipes(
            dataset, batch_size=args.batch_size,
            max_mix_num=cfg.data.max_mix_num,
            lower_db=cfg.data.loudness_norm.lower_db,
            higher_db=cfg.data.loudness_norm.higher_db,
            seed=args.seed)
        save_recipes(recipes, args.output_file)
        print(f"wrote {len(recipes['recipes'])} recipes to "
              f"{args.output_file}")
        return

    recipes = load_recipes(args.recipes)
    n = compute_stfts(
        dataset, recipes, args.output_dir,
        win_lengths=tuple(cfg.data.stft_win_lengths),
        hop_length=cfg.data.stft_hop_length,
        batch_size=args.batch_size,
        max_batches=args.max_batches, device=args.device)
    print(f"wrote {n} batch files to {args.output_dir}")


if __name__ == "__main__":
    main()
