"""Zero-shot classification over CLAP joint embeddings (counterpart of
lass_tpu/evaluation/zero_shot.py).

The reference's training/zero_shot.py:13-64: prompt-templated class
embeddings, each normalized, averaged and renormalized; 100 x cosine
logits; top-k accuracy. The reference targets CLIP's image branch; this
takes any embedding callables, so audio tagging works as it is. The
embeddings stay on the callables' device; the top-k counts are numpy.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence, Tuple

import numpy as np
import torch


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def zero_shot_classifier(
    embed_texts: Callable[[Sequence[str]], torch.Tensor],
    classnames: Sequence[str],
    templates: Sequence[Callable[[str], str]] = (
        lambda c: f"This is a sound of {c}.",),
) -> torch.Tensor:
    """(embed_dim, n_classes) prompt-ensemble weights (zero_shot.py:13-27):
    per class, embed every template, L2-normalize, average, renormalize."""
    weights = []
    for classname in classnames:
        emb = _normalize(torch.as_tensor(embed_texts(
            [t(classname) for t in templates])))
        weights.append(_normalize(emb.mean(dim=0)))
    return torch.stack(weights, dim=1)


def topk_accuracy(logits, target, topk: Tuple[int, ...] = (1, 5)):
    """Counts of correct top-k predictions (zero_shot.py:30-36)."""
    logits = np.asarray(logits)
    target = np.asarray(target)
    kmax = min(max(topk), logits.shape[1])
    pred = np.argsort(-logits, axis=1)[:, :kmax]  # (B, kmax)
    correct = pred == target[:, None]
    return [float(correct[:, :min(k, kmax)].sum()) for k in topk]


@torch.no_grad()
def zero_shot_run(
    embed_audio: Callable[..., torch.Tensor],
    classifier: torch.Tensor,
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    logit_scale: float = 100.0,
) -> Dict[str, float]:
    """Stream (audio_batch, int_target) pairs -> top-1/top-5 accuracy
    (zero_shot.py:39-64)."""
    top1 = top5 = n = 0.0
    for audio, target in batches:
        feats = _normalize(torch.as_tensor(embed_audio(audio)))
        logits = logit_scale * feats @ classifier.to(feats.device)
        acc1, acc5 = topk_accuracy(logits.double().cpu().numpy(), target,
                                   (1, 5))
        top1 += acc1
        top5 += acc5
        n += feats.shape[0]
    return {"zeroshot-top1": top1 / max(n, 1),
            "zeroshot-top5": top5 / max(n, 1)}
