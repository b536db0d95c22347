"""Analytic FLOP counts for a step's share of the card's peak (counterpart of
``geossl_tpu/utils/flops.py``: the same conventions and the same numbers).

The counts are the arithmetic of the padded DENSE formulation: the model's
math, padding included. The kernels do not execute all of it: with
occupancy gating they skip 8x8 pair tiles whose env is all zero, and the
symmetric pairs compute each unordered tile once. Two rates therefore exist:

* **dense-effective** (dense FLOPs / time): what a dense implementation
  would have to sustain to match this time. It MAY exceed the card's peak;
  that is the point of skipping work.
* **executed** (dense FLOPs with the pair terms scaled by
  :func:`executed_pair_fraction` / time): the card's utilization. The
  fraction counts only pairs the kernels compute, so this share never reads
  above 100% of peak.

Conventions (the JAX module's):

* 1 MAC = 2 FLOP; elementwise transcendentals count 1 FLOP each (reported
  apart, so the binding resource is visible).
* A training step is ``forward + backward`` with the backward 2x the
  forward: 3x the forward in all.
* Peaks: NVIDIA H100 80GB HBM3 (SXM5), 700 W, data sheet: TF32 on the
  tensor cores (dense) 495 TFLOP/s, bf16 on them 989 TFLOP/s, f32 outside
  them 67 TFLOP/s, HBM3 3.35 TB/s. :func:`mfu` divides by the TF32 peak,
  because every f32 kernel of the port runs its products as 3xTF32 on the
  tensor cores; the bf16 instances of the CFConv kernels (``mxu='bf16'``)
  run theirs on bf16 operands, whose bound takes the bf16 peak
  (:func:`bound_basis`).

Reference hot op: ``Geom3D/models/schnet.py:170-195`` (the CFConv filter
MLP; its G·F + F² MACs per pair per block dominate).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# NVIDIA H100 80GB HBM3 (SXM5), 700 W power limit: data-sheet peaks
H100_CARD = "NVIDIA H100 80GB HBM3 (SXM5), 700 W"
H100_PEAK_TF32 = 495e12  # FLOP/s, tensor cores, dense
H100_PEAK_BF16 = 989e12  # FLOP/s, tensor cores, dense
H100_PEAK_F32 = 67e12  # FLOP/s, outside the tensor cores
H100_PEAK_BYTES = 3.35e12  # bytes/s, HBM3
# side of the kernels' square pair tiles (csrc/worklist.cuh, kTile)
TILE = 8


@dataclass
class FlopCount:
    matmul: float  # FLOPs of the products (2 * MACs)
    elementwise: float  # muls/adds of the pair-grid chains
    transcendental: float  # exp/log/softplus/sigmoid element count

    @property
    def total(self) -> float:
        return self.matmul + self.elementwise + self.transcendental

    def scale(self, k: float) -> "FlopCount":
        return FlopCount(self.matmul * k, self.elementwise * k,
                         self.transcendental * k)

    def __add__(self, o: "FlopCount") -> "FlopCount":
        return FlopCount(self.matmul + o.matmul,
                         self.elementwise + o.elementwise,
                         self.transcendental + o.transcendental)


def schnet_forward(n: int, g: int = 51, f: int = 128, blocks: int = 6,
                   pair_frac: float = 1.0) -> FlopCount:
    """Per-graph forward FLOPs at padded size n (``models/schnet.py``).
    ``pair_frac`` scales the pair-grid terms to the executed fraction
    (:func:`executed_pair_fraction`); 1.0 counts the dense model."""
    pairs = n * n * pair_frac
    # per block: filter MLP (G->F, F->F) on every pair + lin1/lin2/post Dense
    mm = blocks * (2.0 * pairs * (g * f + f * f) + 3 * 2.0 * n * f * f)
    # readout MLP (two Dense F->F)
    mm += 2 * 2.0 * n * f * f
    # RBF: diff, square, mul-coeff per (pair, G); envelope: 2 ops/pair;
    # message: w*env, w*x, sum over j (2 ops) per (pair, F)
    ew = blocks * (pairs * (3.0 * g + 2.0) + pairs * f * 4.0)
    # ssp in the filter MLP's hidden [pairs, F] and the block's [n, F]
    ts = blocks * (pairs * f + n * f) * 2.0  # softplus = exp + log1p
    return FlopCount(mm, ew, ts)


def painn_forward(n: int, r: int = 20, f: int = 128, blocks: int = 3,
                  pair_frac: float = 1.0) -> FlopCount:
    """Per-graph PaiNN forward (``models/painn.py``): message + mixing."""
    pairs = n * n * pair_frac
    # message: filter product R->3F per pair; q/mu reductions
    mm = blocks * (2.0 * pairs * r * 3 * f)
    # per-node MLPs: interaction (F->F, F->3F), mixing (2F channel mix on 3
    # vector channels, F+F->F, F->3F)
    mm += blocks * 2.0 * n * (f * f + f * 3 * f + 3 * f * 2 * f + 2 * f * f + f * 3 * f)
    ew = blocks * pairs * (3.0 * r + 2.0 * f + 9.0 * f + 9.0 * f + 3 * f)
    ts = blocks * (pairs * r + 2.0 * n * f)  # rbf exp + silu-ish
    return FlopCount(mm, ew, ts)


def ncsn_head_forward(n: int, emb: int = 128,
                      pair_frac: float = 1.0) -> FlopCount:
    """NCSNv3 per-graph forward (``objectives/ncsn.py``); ``pair_frac``
    scales its pair terms (the kernels compute the tiles holding a selected
    pair: :func:`executed_pair_fraction` with ``model="ncsn"``)."""
    pairs = n * n * pair_frac
    mm = 2.0 * pairs * (emb + emb + emb * emb // 2 + emb // 2)
    mm += 2.0 * n * emb * emb  # per-node u Dense
    ew = pairs * (emb * 4.0 + 10.0)  # perturb/target/adds/relu masks
    ts = 0.0
    return FlopCount(mm, ew, ts)


def train_step(fwd: FlopCount) -> FlopCount:
    """forward + backward ~= 3x the forward (see the module docstring)."""
    return fwd.scale(3.0)


def ddm_step(batch: int, n: int, g: int = 51, f: int = 128, blocks: int = 6,
             model: str = "schnet", pair_frac: float = 1.0,
             head_pair_frac: float = 1.0) -> FlopCount:
    """A whole DDM training step: two backbone views and two NCSN heads,
    backward through everything (``train/pretrain_geossl.py``'s loss).
    ``pair_frac`` / ``head_pair_frac`` scale the backbone's / the head's
    pair terms to what executes; 1.0 (the default) is the dense count."""
    bb = (schnet_forward(n, g, f, blocks, pair_frac) if model == "schnet"
          else painn_forward(n, f=f, pair_frac=pair_frac))
    head = ncsn_head_forward(n, f, head_pair_frac)
    per_graph = train_step(bb.scale(2.0) + head.scale(2.0))
    return per_graph.scale(batch)


def finetune_step(batch: int, n: int, model: str = "schnet",
                  forces: bool = False, pair_frac: float = 1.0) -> FlopCount:
    """Regression fine-tune step (the linear head is ~free). MD17's force
    loss differentiates an inner gradient: about twice the work again."""
    bb = (schnet_forward(n, pair_frac=pair_frac) if model == "schnet"
          else painn_forward(n, pair_frac=pair_frac))
    per = train_step(bb)
    if forces:
        per = per.scale(2.0)
    return per.scale(batch)


def mfu(flops_per_step: float, step_seconds: float,
        peak: float = H100_PEAK_TF32) -> tuple[float, float]:
    """(achieved TFLOP/s, fraction of ``peak``), by default of the H100's
    TF32 tensor-core peak."""
    achieved = flops_per_step / step_seconds
    return achieved / 1e12, achieved / peak


def bound_basis(mxu: str = "f32") -> tuple[float, str]:
    """(tensor-core peak, basis) on which a kernel row's products are
    bounded: each product counted once at the TF32 peak for the f32
    instances (3xTF32: the bound of one pass), at the bf16 peak for the
    bf16 ones; the row's elementwise terms at the f32 peak beside them
    (``+f32``: the two units at once)."""
    if mxu == "bf16":
        return H100_PEAK_BF16, "bf16_tensor_core+f32"
    if mxu != "f32":
        raise ValueError(f"mxu must be 'f32' or 'bf16', got {mxu!r}")
    return H100_PEAK_TF32, "tf32_tensor_core+f32"


def executed_pair_fraction(env, model: str = "schnet",
                           symmetric: bool = True) -> float:
    """Fraction of the dense pair-grid FLOPs the port's kernels execute.

    ``env``: [B, N, N] (numpy or torch), nonzero exactly where a pair is
    live: the grid the kernels build their tile list from (SchNet's env,
    PaiNN's gate, the NCSN head's selection). The geometry is the port's
    own (``csrc/worklist.cuh``, ``make_tile_list``): 8x8 tiles, with
    occupancy gating only the tiles holding a nonzero entry, with a
    symmetric pair only the tiles ``pj >= pi``, each of which serves its
    mirror too (so dividing by the FULL grid also counts the symmetric
    saving). The route is read from the dispatchers, so the count follows
    a route change:

    * ``schnet``: the symmetric pair whenever ``symmetric`` (pass
      ``max_neighbors is None``: a truncated adjacency is not symmetric and
      takes the plain-mode pair; ``ops/cfconv.cfconv``), gated from
      ``ops/cfconv.sparse_auto``'s size on.
    * ``painn``: the symmetric pair when ``symmetric`` (no max_neighbors,
      no caller's pair_mask) and ``ops/painn.sym_profitable(N)``, gated as
      SchNet.
    * ``ncsn``: the head's kernels gate every tile on the selection.

    A tile counts only its pairs inside the N x N grid, and per-node FLOPs
    are never scaled: the executed count stays at or below what runs, so
    the share of peak derived from it is never overstated.
    """
    from geossl_tpu_torch.ops.cfconv import sparse_auto
    from geossl_tpu_torch.ops.painn import sym_profitable

    if hasattr(env, "detach"):
        env = env.detach().cpu().numpy()
    env = np.asarray(env)
    b, n, _ = env.shape
    if model == "schnet":
        gated, sym = sparse_auto(n, "auto"), bool(symmetric)
    elif model == "painn":
        gated, sym = sparse_auto(n, "auto"), symmetric and sym_profitable(n)
    elif model == "ncsn":
        gated, sym = True, False
    else:
        raise ValueError(f"model must be 'schnet', 'painn' or 'ncsn', got "
                         f"{model!r}")
    if not gated and not sym:
        return 1.0  # every tile of the grid runs
    nt = -(-n // TILE)
    if gated:
        nz = np.zeros((b, nt * TILE, nt * TILE), bool)
        nz[:, :n, :n] = env != 0
        flags = nz.reshape(b, nt, TILE, nt, TILE).any(axis=(2, 4))
    else:
        flags = np.ones((b, nt, nt), bool)
    if sym:
        flags = flags & np.triu(np.ones((nt, nt), bool))[None]
    side = np.minimum(TILE, n - TILE * np.arange(nt))  # a tile's rows in N
    executed = (flags * (side[:, None] * side[None, :])[None]).sum()
    return float(executed) / float(b * n * n)
