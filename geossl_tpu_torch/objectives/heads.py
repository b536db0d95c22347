"""The baseline SSL prediction heads: charge, distance, torsion angle
(counterpart of ``geossl_tpu/objectives/heads.py``; reference
``examples/pretrain_{ChargePrediction,DistancePrediction,
TorsionAnglePrediction}.py``). Each head is one ``nn.Linear`` (Xavier-uniform
weight, zero bias); random draws take a ``torch.Generator`` or an injected
tensor of uniforms.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from geossl_tpu_torch.models.common import init_linear_
from geossl_tpu_torch.objectives.pairs import exact_count_subsample


class ChargePredictor(nn.Linear):
    """Linear(emb -> node_class) on each node (``pretrain_ChargePrediction.py:15-25``)."""

    def __init__(self, emb_dim: int, node_class: int = 9,
                 generator: Optional[torch.Generator] = None):
        super().__init__(emb_dim, node_class)
        init_linear_(self, generator)


def charge_masking(generator: Optional[torch.Generator],
                   atom_type: torch.Tensor, node_mask: torch.Tensor,
                   ratio: float, node_class: int = 9,
                   u: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask exactly ``int(M·ratio)`` of the batch's M real atoms, drawn
    without replacement over the whole batch, to the unknown token
    ``node_class - 1`` (``pretrain_ChargePrediction.py:64-69``). ``u``: the
    uniforms [B, N] of :func:`exact_count_subsample`. Returns
    (masked atom types, loss mask [B, N])."""
    sel = exact_count_subsample(generator, node_mask, ratio, per_graph=False,
                                u=u)
    masked = torch.where(sel, torch.full_like(atom_type, node_class - 1),
                         atom_type)
    return masked, sel


def charge_loss(logits: torch.Tensor, target: torch.Tensor,
                loss_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy over the masked atoms only, and their accuracy
    (``pretrain_ChargePrediction.py:81``); logits [B, N, C], target and
    loss_mask [B, N]."""
    per = F.cross_entropy(logits.flatten(0, 1), target.flatten(),
                          reduction="none").reshape(target.shape)
    w = loss_mask.to(per.dtype)
    denom = torch.clamp(w.sum(), min=1.0)
    hit = (logits.argmax(dim=-1) == target).to(per.dtype)
    return torch.sum(per * w) / denom, torch.sum(hit * w) / denom


class DistancePredictor(nn.Linear):
    """Linear(2·emb -> 1) on [h_i, h_j] (``pretrain_DistancePrediction.py:15-26``)
    over the whole pair grid, in factored form: the weight's two halves
    applied per node and broadcast, never a [B, N, N, 2F] concat."""

    def __init__(self, emb_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(2 * emb_dim, 1)
        init_linear_(self, generator)

    def forward(self, node_repr: torch.Tensor) -> torch.Tensor:
        f = node_repr.shape[-1]
        left = node_repr @ self.weight[0, :f]  # [B, N]
        right = node_repr @ self.weight[0, f:]
        return left[:, :, None] + right[:, None, :] + self.bias[0]


def distance_loss(pred: torch.Tensor, dist: torch.Tensor,
                  sel_mask: torch.Tensor) -> torch.Tensor:
    """L1 over the selected pairs (the reference's ``nn.L1Loss()``)."""
    w = sel_mask.to(pred.dtype)
    return torch.sum(torch.abs(pred - dist) * w) / torch.clamp(w.sum(), min=1.0)


class TorsionAnglePredictor(nn.Linear):
    """Linear(3·emb -> 1) on the concatenated node representations of an
    atom triple (``pretrain_TorsionAnglePrediction.py:16-27``)."""

    def __init__(self, emb_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(3 * emb_dim, 1)
        init_linear_(self, generator)

    def forward(self, node_repr: torch.Tensor,
                triple_index: torch.Tensor) -> torch.Tensor:
        """node_repr [B, N, F], triple_index [B, T, 3] -> pred [B, T]."""
        f = node_repr.shape[-1]
        feat = torch.cat([
            torch.gather(node_repr, 1,
                         triple_index[..., k, None].expand(-1, -1, f))
            for k in range(3)], dim=-1)
        return super().forward(feat)[..., 0]


def torsion_triples(generator: Optional[torch.Generator],
                    positions: torch.Tensor, node_mask: torch.Tensor,
                    num_triples: int, r: Optional[torch.Tensor] = None):
    """``num_triples`` random ordered atom triples (u, v, w) per graph and
    the bond angle at v, the reconstruction of the reference's
    AtomTripleExtractor (``dataloaders_AtomTriple.py:8-31``). ``r``: the
    uniforms [B, T, 3] that pick the atoms (drawn from ``generator`` when
    None). Returns (triple_index [B, T, 3], angle [B, T], triple_mask
    [B, T]): a triple counts when its atoms differ and its graph has at
    least 3 atoms."""
    b, n = node_mask.shape
    counts = node_mask.sum(dim=1)
    if r is None:
        r = torch.rand((b, num_triples, 3), generator=generator,
                       device=positions.device)
    idx = torch.floor(r * counts[:, None, None].to(r.dtype)).long()
    idx = torch.clamp(idx, 0, n - 1)
    u, v, w = idx[..., 0], idx[..., 1], idx[..., 2]
    valid = (u != v) & (v != w) & (u != w) & (counts[:, None] >= 3)

    def gather(i):
        return torch.gather(positions, 1, i[..., None].expand(-1, -1, 3))

    pu, pv, pw = gather(u), gather(v), gather(w)
    a, c = pu - pv, pw - pv
    na = torch.clamp(torch.linalg.norm(a, dim=-1), min=1e-8)
    nc = torch.clamp(torch.linalg.norm(c, dim=-1), min=1e-8)
    cosang = torch.clamp(torch.sum(a * c, dim=-1) / (na * nc), -1.0, 1.0)
    return idx, torch.arccos(cosang), valid


def torsion_loss(pred: torch.Tensor, angle: torch.Tensor,
                 triple_mask: torch.Tensor) -> torch.Tensor:
    """MSE over the valid triples."""
    w = triple_mask.to(pred.dtype)
    return torch.sum((pred - angle) ** 2 * w) / torch.clamp(w.sum(), min=1.0)
