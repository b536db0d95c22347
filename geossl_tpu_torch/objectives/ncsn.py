"""The GeoSSL-DDM score-matching head ``NCSN_version_03`` on pairwise
distances (counterpart of ``geossl_tpu/objectives/ncsn.py``; reference
``examples/NCSN.py:168-220``).

Recipe: a per-graph noise level σ drawn from the geometric ladder, pair
distances perturbed by ε·σ, target score −ε/σ, predicted score
MLP([h_i + h_j, demb(d')]) / σ, loss ½(score − target)²·σ^anneal summed per
graph over the selected pairs, mean over the real graphs.

The parameters carry the JAX package's flax names (``w_d1, b_d1, w_d2,
b_d2, w_od, b_od, w2, b2, w3, b3``, ``out0_h``) and its shapes and init
bounds, so ``utils/torch_import.ncsn_state_dict_from_flax`` carries a JAX
head across. NCSNv1/v2 are not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from geossl_tpu_torch.models.common import xavier_uniform_
from geossl_tpu_torch.ops.ncsn import (
    WEIGHT_NAMES,
    ncsn_score_loss,
    ncsn_score_loss_reference,
    weight_shapes,
)


def sigma_ladder(sigma_begin: float, sigma_end: float,
                 num_noise_level: int) -> np.ndarray:
    """Geometric σ schedule (``NCSN.py:178-179``), float32."""
    return np.exp(np.linspace(math.log(sigma_begin), math.log(sigma_end),
                              num_noise_level)).astype(np.float32)


def graph_masked_mean(per_graph: torch.Tensor,
                      graph_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if graph_mask is None:
        return per_graph.mean()
    gm = graph_mask.to(per_graph.dtype)
    return torch.sum(per_graph * gm) / torch.clamp(gm.sum(), min=1.0)


class NCSNv3(nn.Module):
    """``forward(node_feat [B,N,F], dist [B,N,N], sel_mask [B,N,N],
    graph_mask [B] | None, sigmas=None, noise=None, generator=None)`` ->
    scalar loss. The output MLP's first layer is factored as in the JAX
    package: ``out0_h`` per node, ``w_od`` on the distance embedding.

    ``sigmas [B]`` / ``noise [B,N,N]`` replace the internal draws when given
    (both or neither); the draws take ``generator``. ``use_kernel`` routes
    the per-pair chain through ``ops/ncsn.ncsn_score_loss`` (the kernel on
    CUDA, its plain version on the CPU), the counterpart of ``use_pallas``;
    otherwise the dense math runs on any device."""

    def __init__(self, emb_dim: int = 128, sigma_begin: float = 10.0,
                 sigma_end: float = 0.01, num_noise_level: int = 50,
                 anneal_power: float = 2.0, use_kernel: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.emb_dim = emb_dim
        self.num_noise_level = num_noise_level
        self.anneal_power = float(anneal_power)
        self.use_kernel = use_kernel
        self.register_buffer("sigmas", torch.from_numpy(sigma_ladder(
            sigma_begin, sigma_end, num_noise_level)), persistent=False)
        for name, shape in zip(WEIGHT_NAMES, weight_shapes(emb_dim)):
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))
        self.out0_h = nn.Linear(emb_dim, emb_dim, bias=False)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Glorot-uniform ``w_d1, w_d2, w2, w3``, zero biases; ``w_od`` and
        ``out0_h`` uniform in ±sqrt(6/(1+2·emb)), the bound of the
        reference's one (1+emb, emb) Xavier matrix they factor."""
        bound = math.sqrt(6.0 / (1 + 2 * self.emb_dim))
        with torch.no_grad():
            for name in ("w_d1", "w_d2", "w2", "w3"):
                xavier_uniform_(getattr(self, name), generator)
            for name in ("b_d1", "b_d2", "b_od", "b2", "b3"):
                getattr(self, name).zero_()
            self.w_od.uniform_(-bound, bound, generator=generator)
            self.out0_h.weight.uniform_(-bound, bound, generator=generator)

    def head_weights(self) -> tuple:
        return tuple(getattr(self, name) for name in WEIGHT_NAMES)

    def forward(self, node_feat, dist, sel_mask, graph_mask=None, sigmas=None,
                noise=None, generator: Optional[torch.Generator] = None):
        if (sigmas is None) != (noise is None):
            raise ValueError("supply sigmas and noise together")
        b = node_feat.shape[0]
        # σ and ε follow dist's dtype (at least f32), as in the JAX package
        dtype = torch.promote_types(torch.float32, dist.dtype)
        dev = dist.device
        if sigmas is None:
            level = torch.randint(0, self.num_noise_level, (b,),
                                  generator=generator, device=dev)
            used = self.sigmas.to(dtype)[level]
            noise = torch.randn(dist.shape, generator=generator, dtype=dtype,
                                device=dev)
        else:
            used = torch.as_tensor(sigmas, dtype=dtype, device=dev)
            noise = torch.as_tensor(noise, dtype=dtype, device=dev)
        u = self.out0_h(node_feat)
        args = (dist.to(dtype), noise, sel_mask.to(dtype), used, u,
                *self.head_weights(), self.anneal_power)
        rows = (ncsn_score_loss(*args) if self.use_kernel
                else ncsn_score_loss_reference(*args))
        return graph_masked_mean(rows.sum(dim=1), graph_mask)
