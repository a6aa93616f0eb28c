"""Separator, as ``unet_elementwise_ms``: device ms per batch of the conv
kernel family (cuDNN's convolutions and its layout transposes) launched
inside the benchmark's range around ``SeparationInference.separate``."""

LABEL = "lassbench::separate"


def read(run, name):
    tr = run.trace
    if tr is None or not tr.range_kernels.get(LABEL) or not run.units:
        return None
    return 1e3 * tr.family_s("conv", LABEL) / run.units
