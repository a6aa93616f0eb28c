"""Mask kernel B1 (``ops/masking.py``, ``csrc/masking.cu``): the frozen
bound (``yardstick.mask_bound``: 5 float32 inputs and 2 outputs over the
call's B * T * 512 elements, at 3.35 TB/s) over the profiler's mean device
time per launch in the window, in %."""

from lassbench.yardstick import B1_KERNEL, mask_bound


def read(run, name):
    tr = run.trace
    elements = run.info.get("mask_elements")
    if tr is None or not elements:
        return None
    times = tr.named(B1_KERNEL)
    if not times:
        return None
    mean = sum(times) / len(times)
    return 100.0 * mask_bound(5, elements)["bound_s"] / mean
