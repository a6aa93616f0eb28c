"""Print the schema, shapes and dtypes of a precomputed batch file
(counterpart of scripts/inspect_batch.py; files of either package):

    python -m lass_torch.inspect_batch precomputed/batch_000000.npz [--item 0]
"""
import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m lass_torch.inspect_batch")
    parser.add_argument("path")
    parser.add_argument("--item", type=int, default=0,
                        help="item index to summarize")
    args = parser.parse_args(argv)

    with np.load(args.path, allow_pickle=False) as z:
        keys = sorted(z.files)
        n = z["target_waveform"].shape[0]
        print(f"{args.path}: {n} items, {len(keys)} arrays")
        for k in keys:
            a = z[k]
            print(f"  {k:34s} shape={tuple(a.shape)} dtype={a.dtype}")
        i = args.item
        print(f"\nitem {i}:")
        print(f"  text: {z['text'][i]!r}")
        print(f"  mixture_component_texts: "
              f"{[t for t in z['mixture_component_texts'][i] if t]!r}")
        tw = z["target_waveform"][i]
        print(f"  target_waveform: shape={tw.shape} "
              f"rms={np.sqrt(np.mean(tw**2)):.5f} "
              f"peak={np.abs(tw).max():.5f}")


if __name__ == "__main__":
    main()
