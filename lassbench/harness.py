"""Cells by name, the run record, and the result line.

``Bench.load(workload)`` reads ``BENCHMARK.json`` beside the package and
resolves the cell's configuration (``configs/<config>.json``), traffic
(``traffic/<traffic>.json``, whose ``runner`` is a module of
``lassbench.runners``), limits (``limits/<workload>.json``), its
end-to-end metrics and its per-layer metrics, each read by
``metrics/<name before the first dot>.py``'s ``read(run, name)``.

A cell left out of ``BENCHMARK.json`` while the program fails it keeps its
entries in ``pending/<workload>.json`` (``workload``, ``end_to_end``,
``per_layer``): a run can still name it, and a later change adds those
entries to ``BENCHMARK.json`` once the program is cured.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
CACHE = os.path.join(ROOT, ".lassbench_cache")  # caches, in the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "lass_tpu")


def _json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Bench:
    """One cell of ``BENCHMARK.json`` and everything it names."""

    def __init__(self, spec: Dict, workload: str):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.cell = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.cell["config"]]
        self.config = _json(ROOT, self.config_entry["file"])
        self.traffic = _json(PKG, "traffic", self.cell["traffic"] + ".json")
        limits = os.path.join(PKG, "limits", workload + ".json")
        self.limits = _json(limits) if os.path.exists(limits) else {}

        def mine(metric: Dict) -> bool:
            return workload in metric.get("workloads", [workload])

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"] if mine(m)
                          and (m.get("workloads") or m["moves"] in names)]

    @classmethod
    def load(cls, workload: str, path: Optional[str] = None) -> "Bench":
        spec = _json(path or os.path.join(ROOT, "BENCHMARK.json"))
        pending = os.path.join(PKG, "pending", workload + ".json")
        if workload not in {w["name"] for w in spec["workloads"]} and \
                os.path.exists(pending):
            extra = _json(pending)
            spec["workloads"].append(extra["workload"])
            spec["end_to_end"] += extra["end_to_end"]
            spec["per_layer"] += extra["per_layer"]
        return cls(spec, workload)

    def runner(self):
        return importlib.import_module(
            f"lassbench.runners.{self.traffic['runner']}")


def reader(metric: str):
    """The module that reads per-layer metric ``metric``:
    ``metrics/<name before the first dot>.py``."""
    base = metric.split(".")[0]
    path = os.path.join(PKG, "metrics", base + ".py")
    spec = importlib.util.spec_from_file_location(
        f"lassbench.metrics.{base}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Run:
    """What one run measured; the runners fill it in, the metric readers
    read it. ``e2e``: the end-to-end metrics by name; ``trace``: a
    ``lassbench.trace.Trace`` of the window (``--trace 1``); ``spans``:
    host seconds by name; ``timing``: the trainer's own spans over the
    window; ``units``: batches or steps in the window; ``flops``: a
    unit's operations by precision; ``checks``: {name: (value, limit)};
    ``cache``: where data made once a checkout (the corpus) is kept."""

    def __init__(self, bench: Bench, seed: int, seconds: float, trace: bool):
        self.bench, self.seed, self.seconds, self.traced = (
            bench, seed, seconds, trace)
        self.e2e: Dict[str, float] = {}
        self.trace = None
        self.spans: Dict[str, List[float]] = {}
        self.timing: Dict[str, float] = {}
        self.units = 0
        self.window_s = 0.0
        self.flops: Dict[str, int] = {}
        self.info: Dict[str, float] = {}
        self.checks: Dict[str, tuple] = {}
        self.attempted = 0
        self.failed = 0
        self.device: Dict = {}
        self.cache = CACHE


def forbidden_loaded() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def correct(run: Run) -> bool:
    return bool(run.checks) and all(
        limit is not None and value is not None and value <= limit
        for value, limit in run.checks.values())


def result(run: Run) -> Dict:
    """The result line: the cell's end-to-end metrics, or with --trace 1
    its per-layer ones, and the numbers compared, last."""
    bench = run.bench
    metrics = {}
    if run.traced:
        for m in bench.per_layer:
            value = reader(m["name"]).read(run, m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench.end_to_end:
            metrics[m["name"]] = {"value": run.e2e[m["name"]],
                                  "unit": m["unit"]}
    out = {"correct": correct(run), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": run.device}
    if run.traced and run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def print_checks(run: Run) -> None:
    for name, (value, limit) in run.checks.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(f"correct {correct(run)}", file=sys.stderr)
