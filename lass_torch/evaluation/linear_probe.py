"""Linear-probe losses and metrics (counterpart of
lass_tpu/evaluation/linear_probe.py).

The reference's open_clip/loss.py:338-398 (get_map / get_acc / get_mauc /
LPMetrics / LPLoss / calc_celoss). The losses are torch on the logits'
device; the metrics are the JAX package's numpy code (no sklearn).
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def lp_loss(name: str
            ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """bce | ce | mse on (B, C) logits against (B, C) multi-hot / one-hot
    targets (loss.py:384-398; ce takes the argmax of the target,
    :381-383)."""
    if name == "bce":
        return F.binary_cross_entropy_with_logits
    if name == "ce":
        return lambda pred, target: F.cross_entropy(pred,
                                                    target.argmax(dim=1))
    if name == "mse":
        return F.mse_loss
    raise ValueError("the loss func should be at least one of [bce, ce, mse]")


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _average_precision(score: np.ndarray, truth: np.ndarray) -> float:
    """AP for one class, sklearn average_precision_score semantics
    (step-wise interpolation, ties grouped by threshold)."""
    order = np.argsort(-score, kind="mergesort")
    score, truth = score[order], truth[order]
    distinct = np.where(np.diff(score))[0]
    idx = np.r_[distinct, truth.size - 1]
    tp = np.cumsum(truth)[idx]
    fp = 1 + idx - tp
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / tp[-1] if tp[-1] > 0 else np.zeros_like(tp, np.float64)
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def _roc_auc(score: np.ndarray, truth: np.ndarray) -> float:
    """Mann-Whitney AUC with tie correction (== sklearn roc_auc_score)."""
    n_pos = int(truth.sum())
    n_neg = truth.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(score, kind="mergesort")
    ranks = np.empty(truth.size, np.float64)
    s = score[order]
    i = 0
    while i < s.size:
        j = i
        while j + 1 < s.size and s[j + 1] == s[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return float((ranks[truth > 0].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def get_map(pred: np.ndarray, target: np.ndarray) -> float:
    """Mean over classes of AP(sigmoid(pred)) (loss.py:338-341)."""
    p = _sigmoid(np.asarray(pred, np.float64))
    t = np.asarray(target)
    return float(np.mean([_average_precision(p[:, c], t[:, c])
                          for c in range(t.shape[1])]))


def get_acc(pred: np.ndarray, target: np.ndarray) -> float:
    """Argmax accuracy (loss.py:344-347)."""
    return float(np.mean(np.argmax(pred, 1) == np.argmax(target, 1)))


def get_mauc(pred: np.ndarray, target: np.ndarray) -> float:
    """Mean over classes of ROC-AUC(sigmoid(pred)) (loss.py:350-353)."""
    p = _sigmoid(np.asarray(pred, np.float64))
    t = np.asarray(target)
    return float(np.mean([_roc_auc(p[:, c], t[:, c])
                          for c in range(t.shape[1])]))


class LPMetrics:
    """Named-metric bundle (loss.py:355-376)."""

    _REGISTRY = {"map": get_map, "acc": get_acc, "mauc": get_mauc}

    def __init__(self, metric_names: Sequence[str] = ("map", "acc", "mauc")):
        for name in metric_names:
            if name not in self._REGISTRY:
                raise ValueError(
                    "the metric should be at least one of [map, acc, mauc]")
        self.metric_names = list(metric_names)

    def evaluate_metrics(self, pred, target) -> Dict[str, float]:
        pred = np.asarray(pred)
        target = np.asarray(target)
        return {name: self._REGISTRY[name](pred, target)
                for name in self.metric_names}
