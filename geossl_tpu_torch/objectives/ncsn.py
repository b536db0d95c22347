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
head across. ``NCSNv1``/``NCSNv2`` (no driver calls them) are plain
PyTorch with the JAX package's layers: ``utils/torch_import
.ncsn_v1_state_dict_from_flax`` / ``ncsn_v2_state_dict_from_flax``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from geossl_tpu_torch.models.common import (
    gaussian_smearing,
    init_linear_,
    xavier_uniform_,
)
from geossl_tpu_torch.ops.ncsn import (
    WEIGHT_NAMES,
    ncsn_score_loss,
    ncsn_score_loss_reference,
    weight_shapes,
)
from geossl_tpu_torch.train.common import graph_masked_mean


def sigma_ladder(sigma_begin: float, sigma_end: float,
                 num_noise_level: int) -> np.ndarray:
    """Geometric σ schedule (``NCSN.py:178-179``), float32."""
    return np.exp(np.linspace(math.log(sigma_begin), math.log(sigma_end),
                              num_noise_level)).astype(np.float32)


class _NCSNBase(nn.Module):
    """The σ ladder, the draws and the annealed loss the three heads share
    (``NCSN.py:183-212``)."""

    def __init__(self, emb_dim: int, sigma_begin: float, sigma_end: float,
                 num_noise_level: int, anneal_power: float):
        super().__init__()
        self.emb_dim = emb_dim
        self.num_noise_level = num_noise_level
        self.anneal_power = float(anneal_power)
        self.register_buffer("sigmas", torch.from_numpy(sigma_ladder(
            sigma_begin, sigma_end, num_noise_level)), persistent=False)

    def draws(self, dist, sigmas=None, noise=None,
              generator: Optional[torch.Generator] = None,
              sigma_dtype=None):
        """(σ [B], ε [B,N,N]): a noise level per graph from the ladder, then
        ε ~ N(0, 1); or ``sigmas`` / ``noise`` when given (both or neither).
        ε takes ``dist``'s dtype, σ ``sigma_dtype`` (default: the same)."""
        if (sigmas is None) != (noise is None):
            raise ValueError("supply sigmas and noise together")
        sigma_dtype = sigma_dtype or dist.dtype
        dev = dist.device
        if sigmas is None:
            return self.sample(dist.shape, dist.dtype, dev, generator,
                               sigma_dtype)
        return (torch.as_tensor(sigmas, dtype=sigma_dtype, device=dev),
                torch.as_tensor(noise, dtype=dist.dtype, device=dev))

    def sample(self, shape, dtype, device,
               generator: Optional[torch.Generator] = None, sigma_dtype=None):
        """(σ [B], ε ``shape`` [B,N,N]) drawn from ``generator``: a noise
        level per graph from the ladder, then ε ~ N(0, 1) in ``dtype``; σ in
        ``sigma_dtype`` (default: ``dtype``)."""
        level = torch.randint(0, self.num_noise_level, (shape[0],),
                              generator=generator, device=device)
        return (self.sigmas.to(sigma_dtype or dtype)[level],
                torch.randn(shape, generator=generator, dtype=dtype,
                            device=device))

    def annealed_loss(self, scores, target, sel_mask, used, graph_mask):
        """½(score − target)²·σ^anneal on the selected pairs, summed per
        graph, mean over the real graphs (``NCSN.py:208-212``)."""
        per_pair = 0.5 * (scores - target) ** 2 * used ** self.anneal_power
        per_pair = per_pair * sel_mask.to(per_pair.dtype)
        return graph_masked_mean(per_pair.sum(dim=(1, 2)), graph_mask)


class _MLP(nn.Module):
    """The reference's ``MultiLayerPerceptron`` (``NCSN.py:9-43``): Linear
    layers in ``layers``, relu between them."""

    def __init__(self, dims, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        for lin in self.layers:
            init_linear_(lin, generator)

    def forward(self, x):
        for k, lin in enumerate(self.layers):
            x = lin(x) if k == 0 else lin(torch.relu(x))
        return x


class NCSNv1(_NCSNBase):
    """``NCSN_version_01`` (``NCSN.py:46-95``): scores from the MLP
    (emb -> emb -> emb/2 -> 1) of h_i ⊙ h_j. ``forward`` as
    :class:`NCSNv3`'s; σ is drawn in float32, as the JAX head draws it."""

    def __init__(self, emb_dim: int = 128, sigma_begin: float = 10.0,
                 sigma_end: float = 0.01, num_noise_level: int = 50,
                 anneal_power: float = 2.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(emb_dim, sigma_begin, sigma_end, num_noise_level,
                         anneal_power)
        self.output_mlp = _MLP([emb_dim, emb_dim, emb_dim // 2, 1], generator)

    def forward(self, node_feat, dist, sel_mask, graph_mask=None, sigmas=None,
                noise=None, generator: Optional[torch.Generator] = None):
        used, noise = self.draws(dist, sigmas, noise, generator,
                                 sigma_dtype=torch.float32)
        used = used[:, None, None]
        perturbed = dist + noise * used
        target = -(perturbed - dist) / used ** 2
        hprod = node_feat[:, :, None, :] * node_feat[:, None, :, :]
        scores = self.output_mlp(hprod)[..., 0] / used
        return self.annealed_loss(scores, target, sel_mask, used, graph_mask)


class NCSNv2(_NCSNBase):
    """``NCSN_version_02`` (``NCSN.py:110-166``): the perturbed distance
    Gaussian-smeared (51 gaussians over [0, 10]) and embedded by an MLP
    (51 -> emb -> emb); the output MLP's first layer factored as the JAX
    package factors it, ``out0_h`` per node and ``out0_d`` on the distance
    embedding, then emb -> emb/2 -> 1. σ is drawn in float32."""

    NUM_GAUSSIANS = 51

    def __init__(self, emb_dim: int = 128, sigma_begin: float = 10.0,
                 sigma_end: float = 0.01, num_noise_level: int = 50,
                 anneal_power: float = 2.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(emb_dim, sigma_begin, sigma_end, num_noise_level,
                         anneal_power)
        self.distance_mlp = _MLP([self.NUM_GAUSSIANS, emb_dim, emb_dim],
                                 generator)
        self.out0_h = nn.Linear(emb_dim, emb_dim, bias=False)
        self.out0_d = nn.Linear(emb_dim, emb_dim)
        self.output_mlp = _MLP([emb_dim, emb_dim // 2, 1], generator)
        init_linear_(self.out0_h, generator)
        init_linear_(self.out0_d, generator)

    def forward(self, node_feat, dist, sel_mask, graph_mask=None, sigmas=None,
                noise=None, generator: Optional[torch.Generator] = None):
        used, noise = self.draws(dist, sigmas, noise, generator,
                                 sigma_dtype=torch.float32)
        used = used[:, None, None]
        perturbed = dist + noise * used
        target = -(perturbed - dist) / used ** 2
        demb = self.distance_mlp(gaussian_smearing(perturbed, 0.0, 10.0,
                                                   self.NUM_GAUSSIANS))
        u = self.out0_h(node_feat)
        x = torch.relu(u[:, :, None, :] + u[:, None, :, :] + self.out0_d(demb))
        scores = self.output_mlp(x)[..., 0] / used
        return self.annealed_loss(scores, target, sel_mask, used, graph_mask)


class NCSNv3(_NCSNBase):
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
        super().__init__(emb_dim, sigma_begin, sigma_end, num_noise_level,
                         anneal_power)
        self.use_kernel = use_kernel
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
        return graph_masked_mean(
            self.per_graph(node_feat, dist, sel_mask, sigmas, noise,
                           generator), graph_mask)

    def per_graph(self, node_feat, dist, sel_mask, sigmas=None, noise=None,
                  generator: Optional[torch.Generator] = None):
        """The annealed loss summed per graph over the selected pairs, [B]
        (``forward`` is its mean over the real graphs)."""
        # σ and ε follow dist's dtype (at least f32), as in the JAX package
        dtype = torch.promote_types(torch.float32, dist.dtype)
        dist = dist.to(dtype)
        used, noise = self.draws(dist, sigmas, noise, generator)
        u = self.out0_h(node_feat)
        args = (dist, noise, sel_mask.to(dtype), used, u,
                *self.head_weights(), self.anneal_power)
        rows = (ncsn_score_loss(*args) if self.use_kernel
                else ncsn_score_loss_reference(*args))
        return rows.sum(dim=1)
