"""PaiNN on dense padded batches (counterpart of
``geossl_tpu/models/painn.py``; reference ``Geom3D/models/painn.py``).

Scalar features ``q [B,N,F]`` and vector features ``mu [B,N,3,F]``; every
edge quantity lives on the ``[B,N,N]`` pair grid. Parameters carry the
reference's torch state_dict names (``embedding``, ``filter_net``,
``interactions.{k}.interatomic_context_net.{0,1}``,
``mixing.{k}.mu_channel_mix``, ``mixing.{k}.intraatomic_context_net.{0,1}``),
so a reference ``.pth`` backbone loads with ``load_state_dict``
(``utils/torch_import.load_torch_checkpoint``). Linear weights are
``[out, in]``; the kernels take them transposed to ``[in, out]``.

As in the JAX package:
* the caller may pass ``pair_mask`` (DDM passes the clean-geometry radius
  graph for both views); distances and directions always come from the
  live positions;
* the embedding's row 0 is gated to zero in the forward (the reference's
  ``padding_idx=0``, the JAX model's ``zero_pad_embedding`` default), so it
  is zero in use and gets no gradient whatever its storage holds;
* the gate is the cosine cutoff with its hard ``d < cutoff`` gate, times
  the adjacency.

``PaiNN.forward`` is the training path: each interaction's message pass
goes through ``ops/painn.painn_message``, differentiable on the card (the
``painn_fwd``/``painn_bwd`` kernels; from N=256, when the pair grids are
symmetric, i.e. without ``max_neighbors`` or a caller's ``pair_mask``, the
symmetric pair ``painn_fwd_sym``/``painn_bwd_sym``); ``fused_stack_apply`` is inference
only (``painn_stack``); ``stack_train_apply`` is the differentiable whole
stack (``painn_stack_train``: the stack kernel forward, the per-block
backward). ``plain=True`` runs the JAX model's XLA math on any
device (its RBF width is the offsets' step rounded in the working dtype;
the kernels', and their plain versions', is the exact step, as in the JAX
package's kernels).

The JAX model casts positions, offsets and its node output to f32 whatever
the parameters' dtype; the port computes at the promoted dtype (at least
f32), which is the same on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F_
from torch import nn

from geossl_tpu_torch.models.common import (
    Dense,
    cosine_cutoff,
    gaussian_rbf,
    init_linear_,
    jax_linspace,
    normal_,
)
from geossl_tpu_torch.ops import geometry
from geossl_tpu_torch.ops.cfconv import sparse_auto
from geossl_tpu_torch.ops.painn import (
    STACK_MAX_N,
    painn_message,
    painn_message_fused,
    painn_message_reference,
    painn_stack_infer,
    painn_stack_train,
)
from geossl_tpu_torch.parallel import pair_parallel


class PaiNNInteraction(nn.Module):
    """Inter-atomic message block: the x-MLP, then the message pass with
    this layer's slice of the filter network."""

    def __init__(self, n_atom_basis: int, cutoff: float, sparse="auto",
                 pair_axis: Optional[str] = None):
        super().__init__()
        f = n_atom_basis
        self.cutoff = cutoff
        self.sparse = sparse
        # pair-grid model parallelism (parallel/pair_parallel.py)
        self.pair_axis = pair_axis
        self.interatomic_context_net = nn.Sequential(
            Dense(f, f, activation=F_.silu), Dense(f, 3 * f))

    def forward(self, q, mu, dist, gate, dirs, wk, bk, plain=False,
                symmetric=False):
        """q [B,N,F]; mu [B,N,3,F]; dist/gate [B,N,N]; dirs the three
        contiguous [B,N,N] direction planes (``direction_planes``, made once
        per forward by the caller); wk [R,3F] and bk [3F] in the [in, out]
        layout. ``symmetric``: the caller guarantees dist and gate symmetric
        and the directions antisymmetric, so the dispatcher may take the
        symmetric kernel pair (``ops/painn.painn_message``)."""
        b, n, f = q.shape
        x = self.interatomic_context_net(q)
        mu_flat = mu.reshape(b, n, 3 * f)
        if self.pair_axis is not None:
            dq, dmu = self._pair_sharded_message(dist, gate, dirs, x, mu_flat,
                                                 wk, bk, plain)
        elif plain:
            offsets = jax_linspace(self.cutoff, wk.shape[0], dist.dtype,
                                   dist.device)
            widths = torch.abs(offsets[1] - offsets[0]) * torch.ones_like(offsets)
            phi = gaussian_rbf(dist, offsets, widths)
            dq, dmu = painn_message_reference(dist, gate, *dirs, x, mu_flat, wk,
                                              bk, self.cutoff, phi=phi)
        else:
            dq, dmu = painn_message(dist, gate, *dirs, x, mu_flat, wk, bk,
                                    self.cutoff, symmetric=symmetric,
                                    sparse=self.sparse)
        return q + dq, mu + dmu.reshape(b, n, 3, f)

    def _pair_sharded_message(self, dist, gate, dirs, x, mu_flat, wk, bk,
                              plain):
        """The message pass on this rank's j-stripe of the pair grid, (dq,
        dmu) summed over the pair group (JAX ``PaiNNInteraction`` with
        ``pair_axis``): the plain-mode kernels on the ``[B, N, N/D]`` stripe
        (a stripe is not symmetric), gated on the full grid's N, or with
        ``plain`` the plain version with the kernels' RBF, as JAX's stripe
        path."""
        n = dist.shape[-1]
        j0, nloc = pair_parallel.local_stripe(n)
        args = (*(pair_parallel.stripe(t, j0, nloc, 2)
                  for t in (dist, gate, *dirs)),
                pair_parallel.stripe(x, j0, nloc, 1),
                pair_parallel.stripe(mu_flat, j0, nloc, 1), wk, bk,
                self.cutoff)
        if plain:
            dq, dmu = painn_message_reference(*args)
        else:
            dq, dmu = painn_message_fused(*args, sparse_auto(n, self.sparse))
        return pair_parallel.pair_sum(dq), pair_parallel.pair_sum(dmu)


def direction_planes(direction):
    """The three contiguous [B,N,N] planes of ``direction [B,N,N,3]``, the
    layout the message-pass kernels read."""
    return [direction[..., c].contiguous() for c in range(3)]


class PaiNNMixing(nn.Module):
    """Intra-atomic mixing block."""

    def __init__(self, n_atom_basis: int, epsilon: float = 1e-8):
        super().__init__()
        f = n_atom_basis
        self.epsilon = epsilon
        self.mu_channel_mix = Dense(f, 2 * f, bias=False)
        self.intraatomic_context_net = nn.Sequential(
            Dense(2 * f, f, activation=F_.silu), Dense(f, 3 * f))

    def forward(self, q, mu):
        f = q.shape[-1]
        v, w = torch.split(self.mu_channel_mix(mu), f, dim=-1)  # [B,N,3,F]
        vn = torch.sqrt(torch.sum(v * v, dim=-2) + self.epsilon)
        x = self.intraatomic_context_net(torch.cat([q, vn], dim=-1))
        dq, dgate, dqmu = torch.split(x, f, dim=-1)
        q = q + dq + dqmu * torch.sum(v * w, dim=-2)
        return q, mu + dgate[:, :, None, :] * w


class PaiNN(nn.Module):
    """Dense-batch PaiNN. ``forward(atom_type, positions, node_mask,
    pair_mask=None)`` returns ``(graph_repr [B,F], node_repr [B,N,F])``."""

    def __init__(self, n_atom_basis: int = 128, n_interactions: int = 3,
                 n_rbf: int = 20, cutoff: float = 5.0, readout: str = "add",
                 max_neighbors: Optional[int] = None, max_z: int = 9,
                 shared_interactions: bool = False,
                 shared_filters: bool = False, epsilon: float = 1e-8,
                 sparse="auto", pair_axis: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = n_atom_basis
        self.n_atom_basis = f
        self.n_interactions = n_interactions
        self.n_rbf = n_rbf
        self.cutoff = cutoff
        self.readout = readout
        self.max_neighbors = max_neighbors
        self.max_z = max_z
        self.shared_filters = shared_filters
        self.epsilon = epsilon
        self.embedding = nn.Embedding(max_z, f)
        self.filter_net = Dense(
            n_rbf, 3 * f if shared_filters else n_interactions * 3 * f)
        if shared_interactions:
            # one module repeated, as the reference's ModuleList([m] * L)
            inter = PaiNNInteraction(f, cutoff, sparse, pair_axis)
            mix = PaiNNMixing(f, epsilon)
            self.interactions = nn.ModuleList([inter] * n_interactions)
            self.mixing = nn.ModuleList([mix] * n_interactions)
        else:
            self.interactions = nn.ModuleList(
                PaiNNInteraction(f, cutoff, sparse, pair_axis)
                for _ in range(n_interactions))
            self.mixing = nn.ModuleList(PaiNNMixing(f, epsilon)
                                        for _ in range(n_interactions))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """N(0,1) embedding (row 0 included: it is gated in the forward),
        Xavier-uniform weights, zero biases."""
        normal_(self.embedding.weight, generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                init_linear_(mod, generator)

    def embed(self, atom_type):
        emb = self.embedding.weight
        gate = torch.ones((self.max_z, 1), dtype=emb.dtype, device=emb.device)
        gate[0] = 0.0
        emb = emb * gate
        # an embedding lookup, not emb[atom_type]: the backward of advanced
        # indexing on CUDA is a deterministic index_put that serializes the
        # B*N rows over the 9 atom types (~5 ms per view at B=128, N=128)
        return F_.embedding(atom_type, emb)

    def geometry(self, positions, node_mask, pair_mask=None):
        """(dist, direction, gate) at the geometry dtype (at least f32)."""
        dtype = torch.promote_types(torch.float32, positions.dtype)
        dist, direction, live = geometry.pairwise_directions(
            positions.to(dtype), node_mask)
        if pair_mask is None:
            adj = geometry.radius_adjacency(dist, live, self.cutoff,
                                            self.max_neighbors)
        else:
            adj = pair_mask & live
        return dist, direction, cosine_cutoff(dist, self.cutoff) * adj.to(dtype)

    def filter_weights(self):
        """Per block (wk [R,3F], bk [3F]) in the kernels' [in, out] layout:
        this layer's slice of the filter network."""
        f3 = 3 * self.n_atom_basis
        wk, bk = self.filter_net.weight.t(), self.filter_net.bias
        return [(wk[:, s:s + f3].contiguous(), bk[s:s + f3])
                for s in (0 if self.shared_filters else k * f3
                          for k in range(self.n_interactions))]

    def forward(self, atom_type, positions, node_mask, pair_mask=None,
                plain: bool = False, filters=None):
        """``filters``: ``filter_weights()`` made once by a caller whose
        weights are fixed (the Predictor); made here when None."""
        q = self.embed(atom_type)
        dist, direction, gate = self.geometry(positions, node_mask, pair_mask)
        mu = torch.zeros(q.shape[:2] + (3, q.shape[-1]), dtype=q.dtype,
                         device=q.device)
        filters = self.filter_weights() if filters is None else filters
        dirs = direction_planes(direction)  # once for all blocks
        # the radius graph of the live positions is symmetric; a truncated
        # neighbour list or a caller's pair mask may not be
        symmetric = self.max_neighbors is None and pair_mask is None
        for inter, mix, (wk, bk) in zip(self.interactions, self.mixing,
                                        filters):
            q, mu = inter(q, mu, dist, gate, dirs, wk, bk, plain=plain,
                          symmetric=symmetric)
            q, mu = mix(q, mu)
        return geometry.readout(q, node_mask, self.readout), q

    def stacked_weights(self):
        """The 11 per-block weight stacks of the whole-stack kernel, [in, out]
        layout (``ops/painn.painn_stack_infer``)."""
        cols = [[] for _ in range(11)]
        for inter, mix, (wk, bk) in zip(self.interactions, self.mixing,
                                        self.filter_weights()):
            d0, d1 = inter.interatomic_context_net
            c0, c1 = mix.intraatomic_context_net
            for col, t in zip(cols, (
                    d0.weight.t(), d0.bias, d1.weight.t(), d1.bias, wk, bk,
                    mix.mu_channel_mix.weight.t(), c0.weight.t(), c0.bias,
                    c1.weight.t(), c1.bias)):
                col.append(t)
        return tuple(torch.stack(c).contiguous() for c in cols)


def _check_stackable(name: str, model: PaiNN) -> None:
    """The whole-stack kernels run the whole pair grid on one device."""
    if any(inter.pair_axis is not None for inter in model.interactions):
        raise ValueError(f"{name}: default config only (no pair_axis)")


def fused_stack_apply(model: PaiNN, atom_type, positions, node_mask,
                      stacked=None):
    """Inference-only forward with all interaction and mixing blocks in one
    kernel launch (``ops/painn.painn_stack_infer``); the math of
    ``model.forward`` with the kernels' RBF. Needs f32 positions and
    N <= STACK_MAX_N. ``stacked`` is ``model.stacked_weights()`` made once
    by a caller whose weights are fixed; made here when None."""
    _check_stackable("fused_stack_apply", model)
    if positions.dtype != torch.float32:
        raise ValueError(f"fused_stack_apply: positions must be float32 (got "
                         f"{positions.dtype}); use model.forward")
    q0 = model.embed(atom_type).float()
    dist, direction, gate = model.geometry(positions, node_mask)
    dirs = direction_planes(direction)
    stacked = model.stacked_weights() if stacked is None else stacked
    q, _ = painn_stack_infer(dist, gate.contiguous(), *dirs, q0.contiguous(),
                             stacked, model.cutoff, model.epsilon)
    return geometry.readout(q, node_mask, model.readout), q


def stack_train_apply(model: PaiNN, atom_type, positions, node_mask,
                      pair_mask=None):
    """Differentiable forward with all interaction and mixing blocks in one
    kernel launch (``ops/painn.painn_stack_train``; JAX
    ``models/painn.stack_train_apply``): the stack kernel saves each block's
    boundary values and the backward runs the per-block chain, with the
    ``painn_bwd`` kernel for the message passes. Gradients flow to the
    parameters and the positions. Returns ``(graph_repr, node_repr)``, as
    ``model.forward``. Needs f32 positions, N <= STACK_MAX_N and no
    ``pair_axis`` (as the JAX function)."""
    _check_stackable("stack_train_apply", model)
    if positions.dtype != torch.float32:
        raise ValueError(f"stack_train_apply: positions must be float32 (got "
                         f"{positions.dtype}); use model.forward")
    if positions.shape[1] > STACK_MAX_N:
        raise ValueError(f"stack_train_apply: N={positions.shape[1]} exceeds "
                         f"{STACK_MAX_N}; use model.forward")
    q0 = model.embed(atom_type).float()
    dist, direction, gate = model.geometry(positions, node_mask, pair_mask)
    dirs = direction_planes(direction)
    stacked = [t.float() for t in model.stacked_weights()]
    q, _ = painn_stack_train(dist, gate.contiguous(), *dirs, q0.contiguous(),
                             stacked, model.cutoff, model.epsilon)
    return geometry.readout(q, node_mask, model.readout), q
