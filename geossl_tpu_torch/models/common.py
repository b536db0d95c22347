"""Shared model building blocks: RBF expansion, cosine envelope, shifted
softplus and the reference-matching initializers (counterpart of
``geossl_tpu/models/common.py``).

Initialization follows PyTorch semantics as the JAX package does:
Xavier-uniform weights, zero biases, N(0,1) embeddings, every draw from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

LOG2 = math.log(2.0)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - log(2). ``jax.nn.softplus`` is ``logaddexp(x, 0)``;
    ``torch.nn.functional.softplus`` returns x itself above its threshold of
    20, which differs by ~2e-9 there and breaks f64 parity, so this uses
    ``logaddexp`` too."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device)) - LOG2


class ShiftedSoftplus(nn.Module):
    """Parameter-free module, so ``mlp.{0,2}`` keep the reference's indices."""

    def forward(self, x):
        return shifted_softplus(x)


def gaussian_smearing(dist: torch.Tensor, start: float, stop: float,
                      num_gaussians: int) -> torch.Tensor:
    """exp(-0.5/Δ² (d - μ_k)²) with μ_k = linspace(start, stop); appends a
    trailing axis of size ``num_gaussians``. (The kernels make the offsets as
    start + Δ·k in f32, about 1 ulp from ``linspace``.)"""
    offset = torch.linspace(start, stop, num_gaussians, dtype=dist.dtype,
                            device=dist.device)
    coeff = -0.5 / (offset[1] - offset[0]) ** 2
    diff = dist[..., None] - offset
    return torch.exp(coeff * diff * diff)


def cosine_envelope(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    """SchNet's CFConv envelope, with no hard gate: callers mask by the
    adjacency."""
    return 0.5 * (torch.cos(dist * math.pi / cutoff) + 1.0)


def xavier_uniform_(weight: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Glorot-uniform init of a ``[out, in]`` weight (the bound is symmetric
    in fan-in and fan-out, so the ``[in, out]`` layout gives the same law)."""
    fan_out, fan_in = weight.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return weight.uniform_(-bound, bound, generator=generator)


def init_linear_(lin: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """Xavier-uniform weight, zero bias."""
    xavier_uniform_(lin.weight, generator)
    if lin.bias is not None:
        with torch.no_grad():
            lin.bias.zero_()


def normal_(weight: torch.Tensor,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """N(0, 1) init (the embedding table)."""
    with torch.no_grad():
        return weight.normal_(0.0, 1.0, generator=generator)
