"""Pair selection masks over the dense ``[B, N, N]`` pair grid (counterpart
of ``geossl_tpu/objectives/pairs.py``; reference
``dataloaders_AtomTuple.py:9-37``). Random draws take an explicit
``torch.Generator`` in place of a JAX key."""

from __future__ import annotations

from typing import Optional

import torch

from geossl_tpu_torch.ops.geometry import pair_mask_from_nodes


def exact_count_subsample(generator: Optional[torch.Generator],
                          mask: torch.Tensor, ratio: float) -> torch.Tensor:
    """Keep exactly ``floor(M·ratio)`` of the True entries of each graph's
    ``mask`` (leading axis), as ``np.random.choice(M, int(M·ratio),
    replace=False)`` in distribution: i.i.d. uniforms on the selected
    entries, kept at or below the k-th order statistic."""
    u = torch.rand(mask.shape, generator=generator, device=mask.device)
    u = torch.where(mask, u, torch.full_like(u, float("inf")))
    flat = u.reshape(mask.shape[0], -1)
    m = mask.reshape(mask.shape[0], -1).sum(dim=1)
    k = torch.floor(m * ratio).long()
    order = torch.sort(flat, dim=1).values
    thr = torch.gather(order, 1, torch.clamp(k - 1, min=0)[:, None])
    keep = (flat <= thr) & (k[:, None] > 0)
    return keep.reshape(mask.shape) & mask


def pair_selection(node_mask: torch.Tensor, option: str = "permutation",
                   ratio: float = 1.0,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[B, N] node mask -> [B, N, N] pair-selection mask: 'permutation' is
    every ordered pair (i != j), 'combination' each unordered pair once
    (i < j); ``ratio < 1`` keeps exactly ``int(M·ratio)`` pairs per graph."""
    mask = pair_mask_from_nodes(node_mask)
    if option == "combination":
        n = node_mask.shape[-1]
        mask = mask & torch.ones(n, n, dtype=torch.bool,
                                 device=mask.device).triu(1)
    elif option != "permutation":
        raise ValueError(f"unknown pair option {option!r}")
    if ratio < 1.0:
        if generator is None:
            raise ValueError("ratio < 1 requires a generator")
        mask = exact_count_subsample(generator, mask, ratio)
    return mask
