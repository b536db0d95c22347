"""Contrastive GeoSSL objectives: the perturbed view, InfoNCE and EBM-NCE
(counterpart of ``geossl_tpu/objectives/contrastive.py``; reference
``examples/pretrain_GeoSSL.py:68-176`` and ``examples/util.py:19-64``).

View 2 is the same atoms at positions + N(mu, sigma); negatives come from
cyclic shifts of the batch. A padded graph slot (``graph_mask`` False) is
kept out of every term: out of InfoNCE's logit columns (logit -1e9, the
diagonal kept), out of every EBM negative pair and out of every accuracy
denominator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def perturb_positions(generator: Optional[torch.Generator],
                      positions: torch.Tensor, mu: float,
                      sigma: float) -> torch.Tensor:
    """positions + N(mu, sigma) elementwise (``pretrain_GeoSSL.py:68-74``);
    padded rows get noise too and are masked downstream."""
    noise = torch.randn(positions.shape, generator=generator,
                        dtype=positions.dtype, device=positions.device)
    return positions + (mu + sigma * noise)


def cycle_shift(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """``cycle_index(B, shift)`` (``util.py:19-22``): element i takes
    element i + shift, wrapping around."""
    return torch.roll(x, -shift, dims=0)


def _bce_logits(logits: torch.Tensor, labels: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    loss = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    if weights is None:
        return loss.mean()
    w = weights.to(loss.dtype)
    return torch.sum(loss * w) / torch.clamp(w.sum(), min=1.0)


def _masked_frac(pred_ok: torch.Tensor, weights: Optional[torch.Tensor]):
    """(fraction, count) without weights; (weighted hits, weight) with."""
    if weights is None:
        return pred_ok.float().mean(), torch.full(
            (), float(pred_ok.shape[0]), device=pred_ok.device)
    w = weights.float()
    return torch.sum(pred_ok * w), w.sum()


def _ebm_terms(x: torch.Tensor, y: torch.Tensor, num_neg: int,
               temperature: float, graph_mask: Optional[torch.Tensor]):
    """(positive BCE, negative BCE, accuracy): positives dot(x_i, y_i) / T,
    negatives dot(x_i, y_{i+k}) / T for k = 1..num_neg, a negative kept only
    where both of its graphs are real."""
    if num_neg < 1:
        raise ValueError(
            f"num_neg must be >= 1, got {num_neg}: an EBM loss with no "
            "negatives is all-positive and collapses trivially")
    pred_pos = torch.sum(x * y, dim=1) / temperature
    negs, masks = [], []
    for k in range(num_neg):
        negs.append(torch.sum(x * cycle_shift(y, k + 1), dim=1) / temperature)
        if graph_mask is not None:
            masks.append(graph_mask & cycle_shift(graph_mask, k + 1))
    pred_neg = torch.cat(negs)
    neg_mask = torch.cat(masks) if masks else None
    loss_pos = _bce_logits(pred_pos, torch.ones_like(pred_pos), graph_mask)
    loss_neg = _bce_logits(pred_neg, torch.zeros_like(pred_neg), neg_mask)
    ok_pos, n_pos = _masked_frac(pred_pos > 0, graph_mask)
    ok_neg, n_neg = _masked_frac(pred_neg < 0, neg_mask)
    if graph_mask is None:
        acc = (ok_pos * n_pos + ok_neg * n_neg) / (n_pos + n_neg)
    else:
        acc = (ok_pos + ok_neg) / torch.clamp(n_pos + n_neg, min=1.0)
    return loss_pos, loss_neg, acc


def ebm_nce_loss(x: torch.Tensor, y: torch.Tensor,
                 graph_mask: Optional[torch.Tensor] = None,
                 num_neg: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """EBM-NCE (``pretrain_GeoSSL.py:103-138``): BCE on the positive and the
    cyclic-shift negative dot products, combined as
    (pos + num_neg·neg) / (1 + num_neg). Returns (loss, accuracy)."""
    loss_pos, loss_neg, acc = _ebm_terms(x, y, num_neg, 1.0, graph_mask)
    return (loss_pos + num_neg * loss_neg) / (1 + num_neg), acc


def infonce_loss(x: torch.Tensor, y: torch.Tensor, temperature: float = 0.1,
                 graph_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction of InfoNCE (``pretrain_GeoSSL.py:159-168``): cross
    entropy over the B×B dot-product logits / T with diagonal labels; padded
    columns leave the softmax (logit -1e9), the diagonal stays."""
    b = x.shape[0]
    logits = (x @ y.T) / temperature
    labels = torch.arange(b, device=x.device)
    if graph_mask is not None:
        eye = torch.eye(b, dtype=torch.bool, device=x.device)
        col_ok = graph_mask[None, :] | eye
        logits = torch.where(col_ok, logits, torch.full_like(logits, -1e9))
    loss_per = F.cross_entropy(logits, labels, reduction="none")
    hit = (logits.argmax(dim=1) == labels).to(loss_per.dtype)
    if graph_mask is None:
        return loss_per.mean(), hit.mean()
    gm = graph_mask.to(loss_per.dtype)
    denom = torch.clamp(gm.sum(), min=1.0)
    return torch.sum(loss_per * gm) / denom, torch.sum(hit * gm) / denom


def dual_infonce_loss(x, y, temperature: float = 0.1, graph_mask=None):
    """Symmetric InfoNCE (``pretrain_GeoSSL.py:170-176``)."""
    l1, a1 = infonce_loss(x, y, temperature, graph_mask)
    l2, a2 = infonce_loss(y, x, temperature, graph_mask)
    return (l1 + l2) / 2, (a1 + a2) / 2


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize`` as ``x · rsqrt(max(Σx², eps²))``: the same value, and
    a finite gradient at the all-zero rows of empty graph slots."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def do_cl(x: torch.Tensor, y: torch.Tensor,
          similarity_metric: str = "InfoNCE_dot_prod",
          temperature: float = 0.1, num_neg: int = 1,
          graph_mask: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's contrastive dispatch (``util.py:25-58``):
    'InfoNCE_dot_prod' is :func:`infonce_loss`; 'EBM_dot_prod' is BCE on
    the dot products / T, combined as pos + num_neg·neg with no averaging
    (``util.py:48``)."""
    if similarity_metric == "InfoNCE_dot_prod":
        return infonce_loss(x, y, temperature, graph_mask)
    if similarity_metric == "EBM_dot_prod":
        loss_pos, loss_neg, acc = _ebm_terms(x, y, num_neg, temperature,
                                             graph_mask)
        return loss_pos + num_neg * loss_neg, acc
    raise ValueError(f"unknown similarity metric {similarity_metric!r}")


def dual_cl(x, y, similarity_metric: str = "InfoNCE_dot_prod",
            temperature: float = 0.1, num_neg: int = 1, graph_mask=None):
    """Symmetric contrastive loss (``util.py:61-64``)."""
    l1, a1 = do_cl(x, y, similarity_metric, temperature, num_neg, graph_mask)
    l2, a2 = do_cl(y, x, similarity_metric, temperature, num_neg, graph_mask)
    return (l1 + l2) / 2, (a1 + a2) / 2
