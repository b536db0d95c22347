"""SchNet on dense padded batches (counterpart of
``geossl_tpu/models/schnet.py``; reference ``Geom3D/models/schnet.py``).

Parameters carry the reference's torch state_dict names (``embedding``,
``interactions.{k}.mlp.{0,2}``, ``interactions.{k}.conv.lin1/lin2``,
``interactions.{k}.lin``, ``lin1``, ``lin2``, ``atomref``), so a reference
``.pth`` backbone loads with ``load_state_dict`` (see
``utils/torch_import.load_torch_checkpoint``). Linear weights are
``[out, in]`` as in torch; the kernels take them transposed to the JAX
package's ``[in, out]``.

The radius graph is recomputed from the live positions every forward,
``readout='mean'`` divides by the true atom count, and the dipole branch is
the JAX package's reconstruction (``dipole_readout``).

``SchNet.forward`` is the training path: each block's CFConv goes through
``ops/cfconv.cfconv``, differentiable on the card at every N (with
symmetric dist/env, i.e. without ``max_neighbors``, the symmetric modes
``cfconv_fwd_sym``/``cfconv_bwd_sym`` at every N, else the
``cfconv_fwd``/``cfconv_bwd`` kernels);
``fused_stack_apply`` is inference only.

A compute ``dtype`` (``--compute_dtype bfloat16``) is the JAX model's: the
embedding, the residual stream ``h`` and every dense layer in bf16 with
flax's rounding (``models/common.linear``), the geometry in f32, the CFConv
kernels fed ``x`` in f32 with the filter products on bf16 operands, their
messages cast back to bf16, and the output cast to f32 before the readout
(and the heads). It implies ``filter_mxu='bf16'``, which alone runs only
the CFConv filter products on bf16 operands (``ops/cfconv``'s ``mxu``).
Neither runs through the whole stack (``fused_stack_apply`` refuses them,
as the JAX package's does).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from geossl_tpu_torch.models.common import (
    ShiftedSoftplus,
    cosine_envelope,
    init_linear_,
    linear,
    normal_,
    shifted_softplus,
)
from geossl_tpu_torch.ops import geometry
from geossl_tpu_torch.ops.cfconv import (
    cfconv,
    cfconv_fused,
    cfconv_plain,
    check_mxu,
    schnet_stack,
    schnet_stack_reference,
    sparse_auto,
)
from geossl_tpu_torch.parallel import pair_parallel

# True masses for the index-coded vocab (H C N O F P S Cl, ?=0)
_ATOMIC_MASSES = (1.008, 12.011, 14.007, 15.999, 18.998, 30.974, 32.06,
                  35.45, 0.0)


class CFConv(nn.Module):
    """The dense layers around the continuous-filter convolution: ``lin1``
    (no bias) before it, ``lin2`` after it; the filter network itself is the
    block's ``mlp``, as in the reference."""

    def __init__(self, hidden_channels: int, num_filters: int):
        super().__init__()
        self.lin1 = nn.Linear(hidden_channels, num_filters, bias=False)
        self.lin2 = nn.Linear(num_filters, hidden_channels)


class InteractionBlock(nn.Module):
    """Residual interaction block: CFConv -> shifted softplus -> Linear."""

    def __init__(self, hidden_channels: int, num_filters: int,
                 num_gaussians: int, cutoff: float, symmetric: bool = True,
                 sparse="auto", pair_axis: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, mxu: str = "f32"):
        super().__init__()
        self.num_gaussians = num_gaussians
        self.cutoff = cutoff
        # the compute dtype of the dense layers (None: the parameters') and
        # the precision of the CFConv filter products
        self.dtype = dtype
        self.mxu = mxu
        # True only when dist AND adj are symmetric (a max_neighbors
        # truncated adjacency is not): lets the kernel skip mirrored tiles
        self.symmetric = symmetric
        self.sparse = sparse
        # pair-grid model parallelism: each rank convolves its j-stripe of
        # the pair grid and the stripes' messages are summed
        # (parallel/pair_parallel.py)
        self.pair_axis = pair_axis
        self.mlp = nn.Sequential(nn.Linear(num_gaussians, num_filters),
                                 ShiftedSoftplus(),
                                 nn.Linear(num_filters, num_filters))
        self.conv = CFConv(hidden_channels, num_filters)
        self.lin = nn.Linear(hidden_channels, hidden_channels)

    def filter_weights(self):
        """(W1 [G,F], b1, W2 [F,F], b2) in the kernels' [in, out] layout."""
        l0, l2 = self.mlp[0], self.mlp[2]
        return (l0.weight.t().contiguous(), l0.bias, l2.weight.t().contiguous(),
                l2.bias)

    def forward(self, h, dist, env, plain: bool = False, filt=None):
        """``env``: the cosine envelope on the radius graph
        (``SchNet.envelope``), the same for every block, so the caller makes
        it once. ``filt``: this block's ``filter_weights()`` made once by a
        caller whose weights are fixed (the Predictor); made here when
        None. In a compute dtype the kernels take ``x`` in f32 and their
        messages come back cast to it (JAX ``InteractionBlock``)."""
        x = linear(self.conv.lin1, h, self.dtype)
        x = x.to(torch.promote_types(torch.float32, x.dtype))
        filt = self.filter_weights() if filt is None else filt
        if self.pair_axis is not None:
            m = self._pair_sharded_conv(dist, env, x, filt, plain)
        else:
            m = cfconv(dist, env, x, *filt, 0.0, self.cutoff,
                       self.num_gaussians, symmetric=self.symmetric,
                       sparse=self.sparse, plain=plain, mxu=self.mxu)
        if self.dtype is not None:
            m = m.to(self.dtype)
        return linear(self.lin, shifted_softplus(
            linear(self.conv.lin2, m, self.dtype)), self.dtype)

    def _pair_sharded_conv(self, dist, env, x, filt, plain):
        """CFConv on this rank's j-stripe of the pair grid, the stripes'
        messages summed over the pair group (JAX ``_pair_sharded_conv``).
        Node tensors are whole on every rank; the stripe ``[B, N, N/D]``
        runs the plain-mode kernels (a stripe is not symmetric), gated on
        the full grid's N, or with ``plain`` the plain version."""
        j0, nloc = pair_parallel.local_stripe(dist.shape[-1])
        args = (pair_parallel.stripe(dist, j0, nloc, 2),
                pair_parallel.stripe(env, j0, nloc, 2),
                pair_parallel.stripe(x, j0, nloc, 1), *filt, 0.0, self.cutoff,
                self.num_gaussians)
        if plain:
            m = cfconv_plain(*args, self.mxu)
        else:
            m = cfconv_fused(*args, sparse_auto(dist.shape[-2], self.sparse),
                             self.mxu)
        return pair_parallel.pair_sum(m)


def dipole_readout(q, atom_type, positions, node_mask, masses):
    """Graph dipole magnitude from per-atom charges ``q [B,N,1]``: mass
    weighted center of mass over real atoms, ``|| Σ_i q_i (pos_i − com) ||``.
    ``masses``: the vocabulary's atomic masses on ``q``'s device (SchNet's
    ``atomic_masses`` buffer, so that no call copies them from the host)."""
    mask = node_mask.to(q.dtype)
    q = q * mask[..., None]
    m = masses.to(q.dtype)[atom_type] * mask
    pos = positions.to(q.dtype)
    com = torch.sum(m[..., None] * pos, dim=1) / torch.clamp(
        torch.sum(m, dim=1, keepdim=True), min=1e-9)
    mu = torch.sum(q * (pos - com[:, None, :]), dim=1)
    return torch.sqrt(torch.sum(mu * mu, dim=-1, keepdim=True) + 1e-18)


class SchNet(nn.Module):
    """Dense-batch SchNet. ``forward(atom_type, positions, node_mask)``
    returns ``(graph_repr [B,F], node_repr [B,N,F])``."""

    def __init__(self, hidden_channels: int = 128, num_filters: int = 128,
                 num_interactions: int = 6, num_gaussians: int = 51,
                 cutoff: float = 10.0, node_class: int = 9,
                 readout: str = "mean", max_neighbors: Optional[int] = None,
                 mean: Optional[float] = None, std: Optional[float] = None,
                 atomref: Optional[Sequence[float]] = None,
                 dipole: bool = False, sparse="auto",
                 pair_axis: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, filter_mxu: str = "f32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_mxu(filter_mxu)
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"dtype must be None or torch.bfloat16, got "
                             f"{dtype}")
        # the compute dtype (None: the parameters'); a bf16 model implies
        # bf16 filter products (JAX InteractionBlock's mxu)
        self.dtype = dtype
        self.mxu = "bf16" if dtype is not None or filter_mxu == "bf16" \
            else "f32"
        self.hidden_channels = hidden_channels
        self.num_filters = num_filters
        self.num_gaussians = num_gaussians
        self.cutoff = cutoff
        self.readout = readout
        self.max_neighbors = max_neighbors
        self.mean = mean
        self.std = std
        self.dipole = dipole
        self.embedding = nn.Embedding(node_class, hidden_channels)
        self.interactions = nn.ModuleList(
            InteractionBlock(hidden_channels, num_filters, num_gaussians,
                             cutoff, symmetric=max_neighbors is None,
                             sparse=sparse, pair_axis=pair_axis, dtype=dtype,
                             mxu=self.mxu)
            for _ in range(num_interactions))
        self.lin1 = nn.Linear(hidden_channels, hidden_channels)
        self.lin2 = nn.Linear(hidden_channels, hidden_channels)
        if dipole:
            self.dipole_lin = nn.Linear(hidden_channels, 1)
            # f64, so that .to(dtype) rounds each mass once, as the JAX
            # constant's cast does; not in the state_dict
            self.register_buffer(
                "atomic_masses",
                torch.tensor(_ATOMIC_MASSES, dtype=torch.float64),
                persistent=False)
        self.atomref = None
        if atomref is not None:
            self.atomref = nn.Embedding(node_class, 1)
        self.reset_parameters(generator, atomref)

    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         atomref: Optional[Sequence[float]] = None) -> None:
        """N(0,1) embedding, Xavier-uniform weights, zero biases."""
        normal_(self.embedding.weight, generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                init_linear_(mod, generator)
        if atomref is not None:
            with torch.no_grad():
                self.atomref.weight.copy_(
                    torch.as_tensor(atomref, dtype=torch.float32).reshape(-1, 1))

    def geometry(self, positions, node_mask):
        """(dist, adj) at the geometry dtype (at least f32)."""
        dtype = torch.promote_types(torch.float32, positions.dtype)
        dist, pair_mask = geometry.pairwise_distances(positions.to(dtype),
                                                      node_mask)
        return dist, geometry.radius_adjacency(dist, pair_mask, self.cutoff,
                                               self.max_neighbors)

    def envelope(self, dist, adj):
        """The cosine cutoff envelope on the radius graph ``adj``, [B,N,N]:
        every block's pair weights, made once per forward."""
        return cosine_envelope(dist, self.cutoff) * adj.to(dist.dtype)

    def filter_weights(self):
        """Every block's ``filter_weights()``: the kernels' layouts."""
        return [blk.filter_weights() for blk in self.interactions]

    def forward(self, atom_type, positions, node_mask, plain: bool = False,
                filters=None):
        """``filters``: the blocks' ``filter_weights()``, made once by a
        caller whose weights are fixed; made per block when None."""
        h = self.embedding(atom_type)
        if self.dtype is not None:
            h = h.to(self.dtype)
        dist, adj = self.geometry(positions, node_mask)
        env = self.envelope(dist, adj)
        filters = filters or [None] * len(self.interactions)
        for block, filt in zip(self.interactions, filters):
            h = h + block(h, dist, env, plain=plain, filt=filt)
        return self.output(h, atom_type, positions, node_mask)

    def output(self, h, atom_type, positions, node_mask):
        """Everything after the interaction blocks: lin1 -> ssp -> lin2, then
        the dipole branch or scaling, atomref and the readout, in the
        compute dtype up to the readout, which is f32 (or f64)."""
        dt = self.dtype
        h = linear(self.lin2, shifted_softplus(linear(self.lin1, h, dt)), dt)
        up = torch.promote_types(torch.float32, h.dtype)
        if self.dipole:
            q = linear(self.dipole_lin, h, dt).to(up)
            return dipole_readout(q, atom_type, positions, node_mask,
                                  self.atomic_masses), h.to(up)
        if self.mean is not None and self.std is not None:
            if dt is None:
                h = h * self.std + self.mean
            else:  # JAX's weakly typed scalars take h's dtype
                h = h * torch.full((), self.std, dtype=dt, device=h.device) \
                    + torch.full((), self.mean, dtype=dt, device=h.device)
        if self.atomref is not None:
            h = h + self.atomref(atom_type).to(h.dtype)
        h = h.to(up)
        return geometry.readout(h, node_mask, self.readout), h

    def stacked_weights(self):
        """The 9 per-block weight stacks of the whole-stack kernel, [in, out]
        layout: (wl1, w1, b1, w2, b2, wa, ba, wb, bb)."""
        cols = [[] for _ in range(9)]
        for blk in self.interactions:
            w1, b1, w2, b2 = blk.filter_weights()
            for col, t in zip(cols, (
                    blk.conv.lin1.weight.t(), w1, b1, w2, b2,
                    blk.conv.lin2.weight.t(), blk.conv.lin2.bias,
                    blk.lin.weight.t(), blk.lin.bias)):
                col.append(t)
        return tuple(torch.stack(c).contiguous() for c in cols)


def fused_stack_apply(model: SchNet, atom_type, positions, node_mask,
                      plain: bool = False, stacked=None):
    """Inference-only forward with all interaction blocks in one kernel
    launch (``ops/cfconv.schnet_stack``); same math as ``model.forward``.
    Needs a square filter width (h stays at one width) and f32 positions.
    ``plain=True`` takes the plain stack on any device. ``stacked`` is
    ``model.stacked_weights()`` made once by a caller whose weights are
    fixed; made here when None. A model in a compute dtype or with bf16
    filter products raises (the stack computes in f32 only, as the JAX
    package's ``fused_stack_apply`` refuses them)."""
    if model.dtype is not None or model.mxu != "f32":
        raise ValueError("fused_stack_apply: default config only (no "
                         "compute dtype, filter_mxu f32); use model.forward")
    if model.num_filters != model.hidden_channels:
        raise ValueError("fused_stack_apply: needs num_filters == "
                         "hidden_channels")
    if positions.dtype != torch.float32:
        raise ValueError(f"fused_stack_apply: positions must be float32 (got "
                         f"{positions.dtype}); use model.forward")
    h = model.embedding(atom_type).float()
    dist, adj = model.geometry(positions, node_mask)
    env = model.envelope(dist, adj)
    stacked = model.stacked_weights() if stacked is None else stacked
    if plain:
        h = schnet_stack_reference(dist, env, h, stacked, 0.0, model.cutoff,
                                   model.num_gaussians)
    else:
        # one filter per unordered pair unless max_neighbors truncates the
        # graph (the rule of the per-block InteractionBlock)
        h = schnet_stack(dist, env, h, stacked, 0.0, model.cutoff,
                         model.num_gaussians,
                         symmetric=model.max_neighbors is None)
    return model.output(h, atom_type, positions, node_mask)
