"""The two helpers of ``geossl_tpu/objectives/contrastive.py`` that DDM
pretraining uses: the perturbed view and ``F.normalize``. The contrastive
losses come with the other GeoSSL objectives."""

from __future__ import annotations

from typing import Optional

import torch


def perturb_positions(generator: Optional[torch.Generator],
                      positions: torch.Tensor, mu: float,
                      sigma: float) -> torch.Tensor:
    """positions + N(mu, sigma) elementwise (``pretrain_GeoSSL.py:68-74``);
    padded rows get noise too and are masked downstream."""
    noise = torch.randn(positions.shape, generator=generator,
                        dtype=positions.dtype, device=positions.device)
    return positions + (mu + sigma * noise)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize`` as ``x · rsqrt(max(Σx², eps²))``: the same value, and
    a finite gradient at the all-zero rows of empty graph slots."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))
