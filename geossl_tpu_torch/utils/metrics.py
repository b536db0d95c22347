"""Evaluation metrics of the fine-tunes in NumPy (the port's own copy of
``geossl_tpu/utils/metrics.py``; reference ``examples/util.py:128-165``,
``finetune_lep.py:96-99``, which calls sklearn, and
``finetune_qm9.py:20-21``, the MAE). Host side, on eval outputs."""

from __future__ import annotations

import numpy as np


def mae(y: np.ndarray, f: np.ndarray) -> float:
    return float(np.mean(np.abs(y - f)))


def mse(y: np.ndarray, f: np.ndarray) -> float:
    return float(np.mean((y - f) ** 2))


def rmse(y: np.ndarray, f: np.ndarray) -> float:
    return float(np.sqrt(mse(y, f)))


def pearson(y: np.ndarray, f: np.ndarray) -> float:
    return float(np.corrcoef(y, f)[0, 1])


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties share the mean rank), 1-based."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), float)
    ranks[order] = np.arange(1, len(x) + 1)
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = ranks[order[i:j + 1]].mean()
        i = j + 1
    return ranks


def spearman(y: np.ndarray, f: np.ndarray) -> float:
    return pearson(_rankdata(y), _rankdata(f))


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC-AUC by the rank statistic (sklearn's value for binary labels,
    ties by average ranks); NaN when one class is missing."""
    labels = np.asarray(labels).astype(bool)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = _rankdata(np.asarray(scores, float))
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def pr_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Average precision (sklearn's ``average_precision_score``). Tied
    scores form one threshold block, so the result does not depend on the
    input order."""
    labels = np.asarray(labels).astype(bool)
    n_pos = int(labels.sum())
    if n_pos == 0:
        return float("nan")
    scores = np.asarray(scores, float)
    order = np.argsort(-scores, kind="stable")
    scores, labels = scores[order], labels[order]
    # the last index of each tie block is a threshold point
    distinct = np.r_[scores[1:] != scores[:-1], True]
    tp = np.cumsum(labels)[distinct]
    n_at = np.arange(1, len(labels) + 1)[distinct]
    precision = tp / n_at
    recall = tp / n_pos
    return float(np.sum(precision * np.diff(np.r_[0.0, recall])))


def concordance_index(y: np.ndarray, f: np.ndarray) -> float:
    """The concordance index (``util.py:144-165``): over the pairs with
    y_i > y_j, the share ordered alike by f (a tie counts 1/2); NaN without
    such a pair. O(n²)."""
    y, f = np.asarray(y, float), np.asarray(f, float)
    gt = y[:, None] > y[None, :]
    u = f[:, None] - f[None, :]
    s = np.where(u > 0, 1.0, np.where(u == 0, 0.5, 0.0))
    z = gt.sum()
    return float((s * gt).sum() / z) if z > 0 else float("nan")


# -- OC20-style energy and force metrics (``util.py:187-223``) ----------------
# ``fixed_masks`` is 1.0 for the FREE atoms, [B, N]; forces are [B, N, 3].


def energy_mae(pred_e: np.ndarray, e: np.ndarray) -> float:
    """Sum-reduced L1 on energies (``util.py:189-190``)."""
    return float(np.abs(np.asarray(pred_e) - np.asarray(e)).sum())


def force_mae(pred_f: np.ndarray, f: np.ndarray,
              fixed_masks: np.ndarray) -> float:
    """Per-structure normalized, free-atom masked L1 force sum
    (``util.py:192-196``): each atom's |df| summed over xyz, divided by its
    structure's free-atom count, summed over the free atoms."""
    m = np.asarray(fixed_masks, float)
    n_free = m.sum(axis=-1, keepdims=True)
    per_atom = np.abs(np.asarray(pred_f) - np.asarray(f)).sum(axis=-1)
    return float((per_atom / n_free)[m.astype(bool)].sum())


def force_cosine(pred_f: np.ndarray, f: np.ndarray,
                 fixed_masks: np.ndarray, eps: float = 1e-8) -> float:
    """Free-atom masked, per-structure normalized sum of force cosines
    (``util.py:198-202``; torch ``cosine_similarity``: each norm clamped at
    ``eps``)."""
    pred_f, f = np.asarray(pred_f, float), np.asarray(f, float)
    m = np.asarray(fixed_masks, float)
    na = np.maximum(np.linalg.norm(pred_f, axis=-1), eps)
    nb = np.maximum(np.linalg.norm(f, axis=-1), eps)
    cos = (pred_f * f).sum(axis=-1) / (na * nb)
    n_free = m.sum(axis=-1, keepdims=True)
    return float((cos / n_free)[m.astype(bool)].sum())


def energy_within_threshold(pred_e: np.ndarray, e: np.ndarray,
                            epsilon: float = 0.02) -> float:
    """EwT (``util.py:204-210``): the share of structures with |dE| < eps."""
    return float(np.mean(np.abs(np.asarray(pred_e) - np.asarray(e))
                         < epsilon))


def energy_force_within_threshold(pred_e, e, pred_f, f,
                                  epsilon: float = 0.02,
                                  alpha: float = 0.03) -> float:
    """EFwT (``util.py:212-223``): the share of structures with |dE| < eps
    whose largest per-atom |dF| (summed over xyz when forces are [B, N, 3];
    [B, N] is taken as summed already) is below ``alpha``. As the JAX
    package, the max runs over each structure's atoms (the OC20
    definition), not over the batch as the reference's code does after it
    has summed the atoms away."""
    pred_f, f = np.asarray(pred_f, float), np.asarray(f, float)
    e_ok = np.abs(np.asarray(pred_e) - np.asarray(e)) < epsilon
    d = np.abs(pred_f - f)
    if d.ndim == 3:
        d = d.sum(axis=-1)
    return float(np.mean(e_ok & (d.max(axis=-1) < alpha)))
