"""3D InfoGraph: node-vs-graph mutual-information discrimination
(counterpart of ``geossl_tpu/objectives/infograph.py``; reference
``examples/pretrain_3DInfoGraph.py:19-76``).

A bilinear discriminator scores each node representation against a sigmoid
graph summary: positives use the node's own graph, negatives the next
graph's summary (a cyclic shift by one); BCE with logits on both.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from geossl_tpu_torch.objectives.contrastive import cycle_shift


class InfoGraphDiscriminator(nn.Module):
    """Bilinear score ``sum(x · (summary @ weight))``
    (``pretrain_3DInfoGraph.py:19-31``); ``weight`` [H, H] drawn from PyG's
    ``uniform(size)``: U(-1/sqrt(H), 1/sqrt(H))."""

    def __init__(self, hidden_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(hidden_dim, hidden_dim))
        bound = 1.0 / math.sqrt(hidden_dim)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, summary: torch.Tensor) -> torch.Tensor:
        return torch.sum(x * (summary @ self.weight), dim=-1)


def infograph_loss(discriminator: InfoGraphDiscriminator,
                   node_repr: torch.Tensor, graph_repr: torch.Tensor,
                   node_mask: torch.Tensor,
                   graph_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``do_InfoGraph`` (``pretrain_3DInfoGraph.py:56-76``) on dense batches:
    every real node against its own graph's summary (positive) and the next
    graph's (negative), mean BCE over the real nodes for each, summed. A
    padded graph's summary is never a negative. Returns (loss, accuracy)."""
    summary = torch.sigmoid(graph_repr)
    # the summary's product with the weight once per graph, not per node
    pos = discriminator(node_repr, summary[:, None, :])  # [B, N]
    neg = discriminator(node_repr, cycle_shift(summary, 1)[:, None, :])
    w = node_mask.to(node_repr.dtype)
    w_neg = w
    if graph_mask is not None:
        gm = graph_mask.to(node_repr.dtype)
        w = w * gm[:, None]
        w_neg = w * cycle_shift(gm, 1)[:, None]
    denom = torch.clamp(w.sum(), min=1.0)
    denom_neg = torch.clamp(w_neg.sum(), min=1.0)
    bce = F.binary_cross_entropy_with_logits
    loss_pos = torch.sum(bce(pos, torch.ones_like(pos), reduction="none")
                         * w) / denom
    loss_neg = torch.sum(bce(neg, torch.zeros_like(neg), reduction="none")
                         * w_neg) / denom_neg
    acc = (torch.sum((pos > 0) * w) + torch.sum((neg < 0) * w_neg)) / (
        denom + denom_neg)
    return loss_pos + loss_neg, acc
