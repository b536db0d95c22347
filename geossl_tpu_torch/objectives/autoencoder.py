"""The AutoEncoder of the GeoSSL-RR objective (representation
reconstruction; counterpart of ``geossl_tpu/objectives/autoencoder.py``).

An MLP reconstructs the other view's graph representation, Linear ->
BatchNorm -> ReLU -> Linear, under an l1, l2 or cosine criterion, the target
detached by default (flags ``--AE_loss --detach_target``). The layers sit
in ``fc_layers`` at indices 0, 1 and 3, as in the GraphMVP lineage the
reference imports the class from.

Padding-aware: the empty graph slots of a partial batch (``graph_mask``
False) enter neither the BatchNorm statistics nor the loss.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from geossl_tpu_torch.models.common import init_linear_


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the rows of ``[B, F]`` whose statistics skip the rows
    ``graph_mask`` marks False, with flax's semantics: the biased (masked)
    variance, running statistics ``r ← m·r + (1 - m)·batch`` at momentum
    m = 0.99 (torch's ``BatchNorm1d`` would say 0.01, and keeps the unbiased
    variance), eps 1e-5. ``weight``/``bias`` are the affine parameters,
    ``running_mean``/``running_var`` buffers updated in ``train()`` mode
    only; ``eval()`` normalises by them."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor,
                graph_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            w = (torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
                 if graph_mask is None else graph_mask.to(x.dtype))
            tot = torch.clamp(w.sum(), min=1.0)
            mean = torch.sum(x * w[..., None], dim=0) / tot
            var = torch.sum((x - mean) ** 2 * w[..., None], dim=0) / tot
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.detach())
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class AutoEncoder(nn.Module):
    """``forward(x, y, graph_mask=None)`` -> the loss of reconstructing the
    target ``y`` [B, F] from ``x`` [B, F], averaged over the real rows."""

    def __init__(self, emb_dim: int = 128, loss: str = "l2",
                 detach_target: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if loss not in ("l1", "l2", "cosine"):
            raise ValueError(f"unknown AE loss {loss!r}")
        self.loss = loss
        self.detach_target = detach_target
        self.fc_layers = nn.ModuleList([
            nn.Linear(emb_dim, emb_dim), MaskedBatchNorm(emb_dim), nn.ReLU(),
            nn.Linear(emb_dim, emb_dim)])
        for k in (0, 3):
            init_linear_(self.fc_layers[k], generator)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                graph_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        lin0, bn, relu, lin1 = self.fc_layers
        recon = lin1(relu(bn(lin0(x), graph_mask)))
        if self.detach_target:
            y = y.detach()
        if self.loss == "l2":
            per = torch.mean((recon - y) ** 2, dim=-1)
        elif self.loss == "l1":
            per = torch.mean(torch.abs(recon - y), dim=-1)
        else:
            num = torch.sum(recon * y, dim=-1)
            den = torch.clamp(torch.linalg.norm(recon, dim=-1)
                              * torch.linalg.norm(y, dim=-1), min=1e-8)
            per = -num / den
        if graph_mask is None:
            return per.mean()
        gm = graph_mask.to(per.dtype)
        return torch.sum(per * gm) / torch.clamp(gm.sum(), min=1.0)
