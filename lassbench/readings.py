"""The readings that the limits of ``correct`` are set from.

    python3 -m lassbench.readings --workload <name> --seeds 1,2,3 \
        --mode program|int8|tf32|fp8|half [--seconds 1]

``program``: whole runs of the cell (its runner, set-up, a window of
``--seconds``, the check), one after another in this process, one line
of numbers a seed: the lower readings. The others put a control or a
fault in the program's place and read the same numbers against the
float32 reference: the program's int8 path (``int8``), the towers in
TF32 (``tf32``), the separator through float8 (``fp8``), half of each
training batch (``half``): the upper readings. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from lassbench.run import _environment

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--mode", default="program")
    parser.add_argument("--seconds", type=float, default=1.0)
    args = parser.parse_args(argv)
    _environment()
    import torch

    from lassbench import runners
    from lassbench.harness import Bench, Run

    if not torch.cuda.is_available():
        print("lassbench.readings needs a CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        bench = Bench.load(args.workload)
        t0 = time.perf_counter()
        if args.mode == "program":
            run = Run(bench, seed, args.seconds, False)
            run.t_start = t0
            bench.runner().run(run, device="cuda")
            found = {k: v for k, (v, _) in run.checks.items()}
        else:
            found = bench.runner().control(bench, seed, "cuda", args.mode)
        runners.free("cuda")
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, **found,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
