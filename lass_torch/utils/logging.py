"""Logging and metrics (counterpart of lass_tpu/utils/logging.py):
numbered file logs plus the console, and step metrics to
``metrics.jsonl``. (The JAX package also logs to W&B when that package is
installed; the port writes only local files.)"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict


def create_logging(log_dir: str, filemode: str = "w") -> logging.Logger:
    os.makedirs(log_dir, exist_ok=True)
    i = 0
    while os.path.isfile(os.path.join(log_dir, f"{i:04d}.log")):
        i += 1
    path = os.path.join(log_dir, f"{i:04d}.log")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(filename)s[line:%(lineno)d] %(levelname)s "
               "%(message)s",
        datefmt="%a, %d %b %Y %H:%M:%S",
        filename=path,
        filemode=filemode,
        force=True,
    )
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(logging.Formatter(
        "%(name)-12s: %(levelname)-8s %(message)s"))
    logging.getLogger("").addHandler(console)
    return logging.getLogger("")


class MetricsLogger:
    """Step metrics -> ``<log_dir>/metrics.jsonl``, one JSON object a line."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        record = {"step": int(step), "time": time.time(),
                  **{k: float(v) for k, v in metrics.items()}}
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def finish(self) -> None:
        self._fh.close()
