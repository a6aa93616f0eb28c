"""Run one cell of the benchmark and print its result line.

    python3 -m lassbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (inputs and weights from the seed, the program built and warmed up
on the cell's shapes), a measured window of ``--seconds``, then the check
of what the window produced against the plain reference. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
also the last lines of standard error. Without a card, with fewer cards
than the cell asks for, or with JAX or the JAX package loaded once the
window has closed, it prints no result and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from lassbench.harness import (  # noqa: E402
    CACHE, Bench, Run, forbidden_loaded, print_checks, result)


def _environment() -> None:
    """Every compiler cache inside the checkout, at fixed paths, and no
    JAX behind a library's back."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    bench = Bench.load(args.workload)

    import torch

    chips = int(bench.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"lassbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    run = Run(bench, args.seed, args.seconds, bool(args.trace))
    run.t_start = T_START
    bench.runner().run(run, device="cuda")
    bad = forbidden_loaded()
    if bad:
        print(f"lassbench: loaded once the window closed: {bad}",
              file=sys.stderr)
        return 4
    line = result(run)
    print_checks(run)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
