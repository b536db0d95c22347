"""ContextPred: substructure-vs-context contrastive pretraining
(counterpart of ``geossl_tpu/objectives/contextpred.py``, the JAX
package's reconstruction of the reference's ``do_ContextPred``,
``examples/util.py:79-119``, which no reference script calls).

Whether a centre atom's substructure representation and a context-ring
representation come from the same molecule, with cycle-shifted in-batch
negatives. Hop distances from the centre come from ``max_hops`` rounds of
batched masked matrix products over a bond-scale radius graph; the
substructure and the context are the same padded geometry under two node
masks (a ball and a ring: holes in the middle of a graph, not a prefix of
its atoms), encoded by two backbones.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def sample_centers(generator: Optional[torch.Generator],
                   node_mask: torch.Tensor,
                   index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-hot [B, N] float32 centre per graph, uniform over its real atoms
    (the reference's ``random.sample(range(num_atoms), 1)``). A padded slot
    gets an arbitrary centre that the caller gates with ``graph_mask``.
    ``index`` [B] replaces the draw from ``generator``.

    The draw is ``jax.random.categorical``'s: the argmax of Gumbel noise
    over logits 0 on real atoms and -inf elsewhere (a graph with no real
    atom gets a uniform row), from uniforms [B, N] of ``generator`` on the
    mask's device. Nothing is read back to the host, so a CUDA graph
    captures the draw with its step."""
    if index is None:
        u = torch.rand(node_mask.shape, generator=generator,
                       device=node_mask.device)
        # jax.random.gumbel's open interval: u = 0 would give -inf noise
        u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
        gumbel = -torch.log(-torch.log(u))
        real = node_mask | ~node_mask.any(dim=-1, keepdim=True)
        index = torch.where(real, gumbel,
                            torch.full_like(gumbel, float("-inf"))).argmax(-1)
    return F.one_hot(index.long(), node_mask.shape[-1]).float()


def hop_distances(adj: torch.Tensor, center_onehot: torch.Tensor,
                  max_hops: int) -> torch.Tensor:
    """BFS hop count [B, N] from each graph's centre over ``adj`` [B, N, N];
    nodes not reached within ``max_hops`` get ``max_hops + 1``. Each round
    is one batched [B,1,N] x [B,N,N] product."""
    adj_f = adj.float()
    reach = center_onehot > 0
    hops = torch.where(reach, 0, max_hops + 1)
    for t in range(1, max_hops + 1):
        new = torch.bmm(reach.float()[:, None, :], adj_f)[:, 0] > 0
        hops = torch.where(new & ~reach, t, hops)
        reach = reach | new
    return hops


def context_masks(hops: torch.Tensor, node_mask: torch.Tensor, k: int,
                  l1: int, l2: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(substruct, context, overlap) node masks: the ball ``hop <= k``, the
    ring ``l1 <= hop <= l2`` and their intersection (the reference's
    ``overlap_context_substruct_idx``; needs ``l1 <= k < l2``)."""
    sub = (hops <= k) & node_mask
    ctx = (hops >= l1) & (hops <= l2) & node_mask
    return sub, ctx, sub & ctx


def contextpred_loss(substruct_repr: torch.Tensor,
                     context_repr: torch.Tensor, valid: torch.Tensor,
                     neg_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """BCE on the substruct·context dot products (``util.py:102-119``):
    each graph against its own context, negative i against the context
    cycle-shifted by i + 1. ``valid`` [B] gates padded slots and graphs
    with an empty overlap; a negative needs both ends valid. Returns
    (mean BCE(pos) + neg_samples · mean BCE(all negatives), accuracy)."""
    if neg_samples < 1:
        raise ValueError(
            f"neg_samples must be >= 1, got {neg_samples}: with no negatives "
            "the BCE objective is all-positive and collapses trivially")
    bce = F.binary_cross_entropy_with_logits
    valid = valid.to(substruct_repr.dtype)
    pos = torch.sum(substruct_repr * context_repr, dim=-1)

    def wmean(x, w):
        return torch.sum(x * w) / torch.clamp(w.sum(), min=1.0)

    loss_pos = wmean(bce(pos, torch.ones_like(pos), reduction="none"), valid)
    correct = torch.sum(valid * (pos > 0))
    total = valid.sum()
    negs, weights = [], []
    for i in range(neg_samples):
        neg_c = torch.roll(context_repr, -(i + 1), dims=0)
        w = valid * torch.roll(valid, -(i + 1), dims=0)
        neg = torch.sum(substruct_repr * neg_c, dim=-1)
        negs.append(bce(neg, torch.zeros_like(neg), reduction="none"))
        weights.append(w)
        correct = correct + torch.sum(w * (neg < 0))
        total = total + w.sum()
    loss = loss_pos + neg_samples * wmean(torch.cat(negs), torch.cat(weights))
    return loss, correct / torch.clamp(total, min=1.0)
