"""Pair selection masks over the dense ``[B, N, N]`` pair grid (counterpart
of ``geossl_tpu/objectives/pairs.py``; reference
``dataloaders_AtomTuple.py:9-37``). Random draws take an explicit
``torch.Generator`` in place of a JAX key."""

from __future__ import annotations

from typing import Optional

import torch

from geossl_tpu_torch.ops.geometry import pair_mask_from_nodes


def exact_count_subsample(generator: Optional[torch.Generator],
                          mask: torch.Tensor, ratio: float,
                          per_graph: bool = True,
                          u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keep exactly ``floor(M·ratio)`` of the True entries of ``mask``, as
    ``np.random.choice(M, int(M·ratio), replace=False)`` in distribution:
    i.i.d. uniforms on the selected entries, kept at or below the k-th order
    statistic. ``per_graph`` counts M and k per graph (leading axis);
    otherwise over the whole batch, charge masking's semantics. ``u``
    (float32, ``mask``'s shape) replaces the uniforms drawn from
    ``generator``."""
    if u is None:
        u = torch.rand(mask.shape, generator=generator, device=mask.device)
    u = torch.where(mask, u, torch.full_like(u, float("inf")))
    lead = mask.shape[0] if per_graph else 1
    flat = u.reshape(lead, -1)
    m = mask.reshape(lead, -1).sum(dim=1)
    k = torch.floor(m * ratio).long()
    order = torch.sort(flat, dim=1).values
    thr = torch.gather(order, 1, torch.clamp(k - 1, min=0)[:, None])
    keep = (flat <= thr) & (k[:, None] > 0)
    return keep.reshape(mask.shape) & mask


def pair_selection(node_mask: torch.Tensor, option: str = "permutation",
                   ratio: float = 1.0,
                   generator: Optional[torch.Generator] = None,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, N] node mask -> [B, N, N] pair-selection mask: 'permutation' is
    every ordered pair (i != j), 'combination' each unordered pair once
    (i < j); ``ratio < 1`` keeps exactly ``int(M·ratio)`` pairs per graph,
    drawn from ``generator`` or from the uniforms ``u`` [B, N, N]."""
    mask = pair_mask_from_nodes(node_mask)
    if option == "combination":
        n = node_mask.shape[-1]
        mask = mask & torch.ones(n, n, dtype=torch.bool,
                                 device=mask.device).triu(1)
    elif option != "permutation":
        raise ValueError(f"unknown pair option {option!r}")
    if ratio < 1.0:
        if generator is None and u is None:
            raise ValueError("ratio < 1 requires a generator")
        mask = exact_count_subsample(generator, mask, ratio, u=u)
    return mask


def graph_pair_counts(sel_mask: torch.Tensor) -> torch.Tensor:
    """Number of selected pairs per graph, [B]."""
    return sel_mask.sum(dim=(1, 2))
