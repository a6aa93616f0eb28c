"""Separator (``models/resunet.py``, ``nn/blocks.py``, ``nn/layers.py``,
``models/film.py``, ``dsp/stft.py``): device ms per batch of the
elementwise/reduce kernel family, counting only kernels launched inside
the benchmark's range around ``SeparationInference.separate``."""

LABEL = "lassbench::separate"


def read(run, name):
    tr = run.trace
    if tr is None or not tr.range_kernels.get(LABEL) or not run.units:
        return None
    return 1e3 * tr.family_s("elementwise/reduce", LABEL) / run.units
