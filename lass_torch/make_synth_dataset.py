"""Write a synthetic wav corpus and its datafile JSON
(``lass_torch.data.synth.make_synth_corpus``; counterpart of
scripts/make_synth_dataset.py), for training runs where no audio dataset
is at hand; prints the datafile's path.

    python -m lass_torch.make_synth_dataset --out DIR --num 256
"""
import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m lass_torch.make_synth_dataset",
                                description=__doc__)
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--num", type=int, default=256)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--seconds_min", type=float, default=6.0)
    p.add_argument("--seconds_max", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from lass_torch.data.synth import make_synth_corpus

    print(make_synth_corpus(
        args.out, num_clips=args.num, sample_rate=args.sample_rate,
        seconds_min=args.seconds_min, seconds_max=args.seconds_max,
        seed=args.seed))


if __name__ == "__main__":
    main()
