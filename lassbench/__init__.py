"""Benchmark of ``lass_torch``, the PyTorch and CUDA port of LASS.

    python3 -m lassbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name: a cell (``workloads`` in ``BENCHMARK.json``)
names its configuration (``configs/<name>.json``) and its traffic mix
(``traffic/<name>.json``, whose ``runner`` names one of ``runners/``); its
limits for ``correct`` are ``limits/<cell>.json``; each per-layer metric
is read by ``metrics/<name before the first dot>.py``. A new cell, mix or
metric is new files and new entries, with no edit of a file here.

The yardstick stays here, apart from the program: the traffic and its
signals (``signals.py``), the peaks, kernel families and the mask's byte
bound (``yardstick.py``), the FLOP count on the plain reference
(``flops.py``), the seeded weights (``weights.py``) and the plain float32
reference (``reference/``), which imports nothing of the program.
"""
