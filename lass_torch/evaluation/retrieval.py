"""Cross-modal retrieval metrics for CLAP evaluation (counterpart of
lass_tpu/evaluation/retrieval.py, the same numpy code).

The reference pretraining harness's get_metrics
(models/CLAP/training/train.py:519-591): rank the true pair in the
scaled similarity matrix both directions and report mean/median rank,
R@{1,5,10}, and mAP@10 (reciprocal rank clipped at 10).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def retrieval_metrics(audio_embeds: np.ndarray, text_embeds: np.ndarray,
                      ks=(1, 5, 10)) -> Dict[str, float]:
    """audio_embeds/text_embeds: (N, D) L2-normalized, row i of each is a
    true pair. Logit scales drop out of rankings and are omitted."""
    a = np.asarray(audio_embeds, np.float64)
    t = np.asarray(text_embeds, np.float64)
    n = a.shape[0]
    sims = {"audio_to_text": a @ t.T, "text_to_audio": t @ a.T}
    out: Dict[str, float] = {"num_samples": float(n)}
    truth = np.arange(n)[:, None]
    for name, s in sims.items():
        ranking = np.argsort(-s, axis=1, kind="stable")
        preds = np.where(ranking == truth)[1]  # 0-based rank of true pair
        out[f"{name}_mean_rank"] = float(preds.mean() + 1)
        out[f"{name}_median_rank"] = float(np.floor(np.median(preds)) + 1)
        for k in ks:
            out[f"{name}_R@{k}"] = float(np.mean(preds < k))
        out[f"{name}_mAP@10"] = float(
            np.mean(np.where(preds < 10, 1.0 / (preds + 1), 0.0)))
    return out
