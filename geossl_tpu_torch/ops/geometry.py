"""Dense pairwise geometry (counterpart of ``geossl_tpu/ops/geometry.py``):
distances over the ``[B, N, N]`` pair grid, the radius adjacency that stands
in for ``torch_cluster.radius_graph``, and the graph readout. Masked entries
are computed from a safe input, so nothing non-finite appears."""

from __future__ import annotations

from typing import Optional

import torch


def pair_mask_from_nodes(node_mask: torch.Tensor) -> torch.Tensor:
    """[B, N] bool -> [B, N, N] bool, True for (real i, real j, i != j)."""
    n = node_mask.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=node_mask.device)
    return node_mask[:, :, None] & node_mask[:, None, :] & ~eye


def pairwise_distances(positions: torch.Tensor, node_mask: torch.Tensor):
    """``(dist [B,N,N], pair_mask [B,N,N])``; padding and the diagonal hold
    0.0."""
    mask = pair_mask_from_nodes(node_mask)
    diff = positions[:, :, None, :] - positions[:, None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2_safe = torch.where(mask, d2, torch.ones_like(d2))
    dist = torch.where(mask, torch.sqrt(d2_safe), torch.zeros_like(d2))
    return dist, mask


def pairwise_directions(positions: torch.Tensor, node_mask: torch.Tensor):
    """``(dist [B,N,N], dir [B,N,N,3], pair_mask)`` with
    ``dir[i, j] = (pos_i - pos_j) / d_ij`` (PaiNN's message from j into i).
    Masked directions are 0 with zero gradient: the inverse distance is taken
    of a safe input there."""
    mask = pair_mask_from_nodes(node_mask)
    diff = positions[:, :, None, :] - positions[:, None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2_safe = torch.where(mask, d2, torch.ones_like(d2))
    root = torch.sqrt(d2_safe)
    zero = torch.zeros_like(d2)
    dist = torch.where(mask, root, zero)
    inv = torch.where(mask, 1.0 / root, zero)
    return dist, diff * inv[..., None], mask


def radius_adjacency(dist: torch.Tensor, pair_mask: torch.Tensor,
                     cutoff: float,
                     max_neighbors: Optional[int] = None) -> torch.Tensor:
    """Neighbor mask equivalent to ``radius_graph(pos, r, loop=False)``.
    With ``max_neighbors=k`` each receiving atom i keeps its k nearest
    in-cutoff neighbors j, ties broken by lower index (stable argsort, as the
    JAX package); the result is then generally asymmetric."""
    adj = pair_mask & (dist < cutoff)
    if max_neighbors is None or max_neighbors >= adj.shape[-1]:
        return adj
    if max_neighbors <= 0:
        raise ValueError(
            f"max_neighbors must be positive or None, got {max_neighbors}")
    inf = torch.full_like(dist, float("inf"))
    masked = torch.where(adj, dist, inf)
    order = torch.argsort(masked, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return adj & (ranks < max_neighbors)


def readout(x: torch.Tensor, node_mask: torch.Tensor, kind: str) -> torch.Tensor:
    """Graph readout over real atoms, [B,N,F] -> [B,F]. 'mean' divides by the
    true atom count floored at 1, so an empty graph slot reads 0."""
    m = node_mask.to(x.dtype)[..., None]
    total = torch.sum(x * m, dim=1)
    if kind in ("add", "sum"):
        return total
    if kind == "mean":
        return total / torch.clamp(torch.sum(m, dim=1), min=1.0)
    raise ValueError(f"unknown readout {kind!r}")
