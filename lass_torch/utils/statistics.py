"""Pickled history of evaluation statistics (counterpart of
lass_tpu/utils/statistics.py)."""
from __future__ import annotations

import datetime
import logging
import os
import pickle
from typing import Dict, List, Optional


class StatisticsContainer:
    def __init__(self, statistics_path: str):
        self.statistics_path = statistics_path
        base, _ = os.path.splitext(statistics_path)
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        self.backup_statistics_path = f"{base}_{stamp}.pkl"
        self.statistics_dict: Dict[str, List] = {"balanced_train": [],
                                                 "test": []}

    def append(self, steps: int, statistics: Dict, split: str,
               flush: bool = True) -> None:
        statistics = dict(statistics)
        statistics["steps"] = steps
        self.statistics_dict.setdefault(split, []).append(statistics)
        if flush:
            self.flush()

    def flush(self) -> None:
        os.makedirs(os.path.dirname(self.statistics_path) or ".",
                    exist_ok=True)
        for path in (self.statistics_path, self.backup_statistics_path):
            with open(path, "wb") as f:
                pickle.dump(self.statistics_dict, f)
        logging.info("Dumped statistics to %s", self.statistics_path)

    def load(self, resume_steps: Optional[int] = None) -> None:
        with open(self.statistics_path, "rb") as f:
            self.statistics_dict = pickle.load(f)
        if resume_steps is not None:
            for split in self.statistics_dict:
                self.statistics_dict[split] = [
                    s for s in self.statistics_dict[split]
                    if s["steps"] <= resume_steps]
