"""Whole step: the least time the window's work needs at the H100's
data-sheet peaks (each precision's operations, counted on the plain
reference by ``lassbench.flops``, over that precision's peak), over the
window's time, in %. The card's power limit is in the result's
``device``."""

from lassbench.yardstick import PEAK_FLOPS


def read(run, name):
    if not run.flops or not run.units or not run.window_s or \
            run.trace is None or run.device.get("platform") != "gpu":
        return None
    least = sum(n / PEAK_FLOPS[p] for p, n in run.flops.items())
    return 100.0 * least * run.units / run.window_s
