"""SE(3)-equivariant weight basis (counterpart of ``geossl_tpu/ops/
se3_basis.py``; the reconstruction of the reference's ``get_basis``,
``Geom3D/models/utils.py:10-45``, whose ``from_se3cnn`` import is missing
from its repo).

Output contract (the reference's): a dict keyed ``"{d_in},{d_out}"`` of
tensors shaped ``[..., 1, 2*d_out+1, 1, 2*d_in+1, 2*min(d_in,d_out)+1]``,
the trailing axis over J = |d_in-d_out| .. d_in+d_out; each J-slice is the
equivariant kernel K_J(x).

The group theory runs once on the host in float64 numpy and is cached (this
module's own copy of the JAX module's): small constant matrices. The
runtime (:func:`precompute_sh`, :func:`get_basis`, :func:`wigner_d`,
:func:`basis_intertwiner`) is torch: the constants are moved to the input's
device and dtype, there is no data-dependent control flow, and gradients
flow to the input.

Construction:

- The degree-1 irrep is the vector rep in the (y, z, x) ordering, with
  Y_1 = sqrt(3/4pi) * (y, z, x).
- Degree-l irreps are the eigenspace of the Casimir C = -sum_k G_k^2 of
  the 1 x (l-1) product rep with eigenvalue l(l+1); an orthonormal basis of
  its projector (deterministic SVD, signs fixed) fixes the irrep basis.
- Real spherical harmonics follow the same recursion, Y_l proportional to
  V_l^T (Y_1 x Y_{l-1}), normalized by the addition theorem.
- Intertwiners Q_J: spin-J -> spin-a x spin-b solve Q G_prod = G_J Q
  (a one-dimensional nullspace, sign fixed).
- Wigner matrices: D^1 = P R P^T, D^l = V_l^T (D^1 x D^{l-1}) V_l.

The defining identities: Y_l(R x) = D^l(R) Y_l(x) and
K_J(R x) = D^{d_out}(R) K_J(x) D^{d_in}(R)^T.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

__all__ = ["precompute_sh", "get_basis", "wigner_d", "basis_intertwiner"]

# (x, y, z) -> (y, z, x): the real-SH ordering of the l=1 row (m = -1, 0, 1).
_P_YZX = np.array([[0.0, 1.0, 0.0],
                   [0.0, 0.0, 1.0],
                   [1.0, 0.0, 0.0]])

# so(3) generators in the Cartesian (x, y, z) basis: (A_k)_ij = -eps_kij.
_EPS = np.zeros((3, 3, 3))
for _i, _j, _k, _s in [(0, 1, 2, 1.0), (1, 2, 0, 1.0), (2, 0, 1, 1.0),
                       (2, 1, 0, -1.0), (0, 2, 1, -1.0), (1, 0, 2, -1.0)]:
    _EPS[_i, _j, _k] = _s
_A_XYZ = -_EPS  # [3 (axis k), 3, 3]


# -- host-side group theory (float64 numpy, cached) ---------------------------


def _projector_basis(proj: np.ndarray, dim: int) -> np.ndarray:
    """Deterministic orthonormal basis [n, dim] of a rank-``dim`` symmetric
    projector: SVD columns with singular value ~1, each sign-fixed so its
    largest-magnitude entry is positive."""
    u, s, _ = np.linalg.svd(proj)
    cols = u[:, s > 0.5]
    if cols.shape[1] != dim:
        raise AssertionError(
            f"projector rank {cols.shape[1]} != expected {dim}")
    for c in range(dim):
        i = np.argmax(np.abs(cols[:, c]))
        if cols[i, c] < 0:
            cols[:, c] = -cols[:, c]
    return cols


@lru_cache(maxsize=None)
def _irrep(l: int) -> Tuple[np.ndarray, np.ndarray]:
    """(generators [3, 2l+1, 2l+1], extractor V [3(2l-1), 2l+1]) of the
    spin-l real irrep; V maps the 1 x (l-1) product rep (1-major flatten)
    onto the spin-l subspace. l=0 and l=1 are the bases."""
    if l == 0:
        return np.zeros((3, 1, 1)), np.zeros((3, 1))
    if l == 1:
        g = np.einsum("ri,kij,cj->krc", _P_YZX, _A_XYZ, _P_YZX)
        return g, np.zeros((3, 3))
    g1, _ = _irrep(1)
    gp, _ = _irrep(l - 1)
    eye1, eyep = np.eye(3), np.eye(2 * l - 1)
    gprod = np.stack([np.kron(g1[k], eyep) + np.kron(eye1, gp[k])
                      for k in range(3)])
    casimir = -sum(gprod[k] @ gprod[k] for k in range(3))
    w, u = np.linalg.eigh(casimir)
    sel = np.abs(w - l * (l + 1)) < 0.5
    if int(sel.sum()) != 2 * l + 1:
        raise AssertionError(f"spin-{l} eigenspace has dim {int(sel.sum())}")
    v = _projector_basis(u[:, sel] @ u[:, sel].T, 2 * l + 1)  # [n, 2l+1]
    g = np.einsum("pr,kpq,qc->krc", v, gprod, v)
    return g, v


@lru_cache(maxsize=None)
def _sh_coeffs(lmax: int) -> Tuple[np.ndarray, ...]:
    """Per degree l, c_l * V_l^T: the [2l+1, 3(2l-1)] map from
    Y_1 x Y_{l-1} to Y_l (normalized by the addition theorem at a generic
    probe point, exact everywhere by equivariance)."""
    coeffs: List[np.ndarray] = [np.zeros((1, 1)), np.zeros((3, 3))]
    n0 = np.array([0.31, -0.52, 0.71])
    n0 /= np.linalg.norm(n0)
    y = [np.array([np.sqrt(1.0 / (4.0 * np.pi))]),
         np.sqrt(3.0 / (4.0 * np.pi)) * (_P_YZX @ n0)]
    for l in range(2, lmax + 1):
        _, v = _irrep(l)
        u = v.T @ np.kron(y[1], y[l - 1])
        c = np.sqrt((2 * l + 1) / (4.0 * np.pi)) / np.linalg.norm(u)
        coeffs.append(c * v.T)
        y.append(c * u)
    return tuple(coeffs[: lmax + 1])


@lru_cache(maxsize=None)
def _intertwiner(j: int, d_out: int, d_in: int) -> np.ndarray:
    """Orthonormal Q [2J+1, (2*d_out+1)*(2*d_in+1)] (d_out-major flatten)
    with Q (D_out x D_in) = D_J Q: the nullspace of the generators'
    commutation constraints (SVD), its sign fixed."""
    if not abs(d_out - d_in) <= j <= d_out + d_in:
        raise ValueError(f"J={j} outside |{d_out}-{d_in}| .. {d_out}+{d_in}")
    ga, _ = _irrep(d_out)
    gb, _ = _irrep(d_in)
    gj, _ = _irrep(j)
    na, nb, nj = 2 * d_out + 1, 2 * d_in + 1, 2 * j + 1
    n = na * nb
    gprod = np.stack([np.kron(ga[k], np.eye(nb)) + np.kron(np.eye(na), gb[k])
                      for k in range(3)])
    # vec_rowmajor(Q G) = (I x G^T) vec(Q); vec_rowmajor(G_J Q) = (G_J x I) vec(Q)
    m = np.concatenate([np.kron(np.eye(nj), gprod[k].T)
                        - np.kron(gj[k], np.eye(n)) for k in range(3)])
    _, s, vt = np.linalg.svd(m)
    if int(np.sum(s < 1e-8)) != 1:
        raise AssertionError(
            f"intertwiner ({j};{d_out},{d_in}) nullspace not 1-dim: "
            f"singular values {s}")
    q = vt[-1].reshape(nj, n)
    q /= np.sqrt(np.trace(q @ q.T) / nj)  # rows orthonormal: Q Q^T = I
    i = np.unravel_index(np.argmax(np.abs(q)), q.shape)
    return q if q[i] > 0 else -q


# -- runtime (torch) ----------------------------------------------------------


def _const(a: np.ndarray, like: Tensor) -> Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def basis_intertwiner(j: int, d_out: int, d_in: int,
                      dtype: torch.dtype = torch.float64,
                      device: Optional[torch.device] = None) -> Tensor:
    """The intertwiner Q_J [2J+1, (2*d_out+1)*(2*d_in+1)] (d_out-major
    flatten, rows orthonormal): Q (D^{d_out} x D^{d_in}) = D^J Q. Made once
    in float64 on the host, returned in ``dtype`` on ``device``."""
    return torch.as_tensor(_intertwiner(j, d_out, d_in), dtype=dtype,
                           device=device)


def _kron(a: Tensor, b: Tensor) -> Tensor:
    """Kronecker product over the last two axes, broadcast over the rest."""
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(*out.shape[:-4], a.shape[-2] * b.shape[-2],
                       a.shape[-1] * b.shape[-1])


def wigner_d(l: int, rot) -> Tensor:
    """Real Wigner matrix D^l(R) [..., 2l+1, 2l+1] in this module's irrep
    bases, for rotations ``rot`` [..., 3, 3] (a tensor, or an array taken
    as float64); it follows the tensor's device and dtype and is
    differentiable in it. D^1 = P R P^T; higher degrees ride the extractor
    recursion."""
    if not isinstance(rot, Tensor):
        rot = torch.as_tensor(np.asarray(rot, np.float64))
    if l == 0:
        return rot.new_ones(rot.shape[:-2] + (1, 1))
    p = _const(_P_YZX, rot)
    d1 = p @ rot @ p.T
    d = d1
    for ll in range(2, l + 1):
        v = _const(_irrep(ll)[1], rot)
        d = v.T @ _kron(d1, d) @ v
    return d


def precompute_sh(vectors: Tensor, lmax: int) -> Dict[int, Tensor]:
    """Real spherical harmonics of ``vectors`` [..., 3] (only the direction
    counts), degrees 0..lmax: dict l -> [..., 2l+1], the role of the
    reference's ``utils_steerable.precompute_sh`` (``models/utils.py:25``).
    A zero vector (padding, a self-pair) gives Y_0's constant and 0 for
    every l >= 1, with a finite (zero) gradient."""
    coeffs = _sh_coeffs(lmax)
    v = vectors
    lead = v.shape[:-1]
    # the zero guard wraps the norm's input too, or the sqrt's NaN at 0
    # rides the chain rule into masked gradients
    sq = (v * v).sum(dim=-1, keepdim=True)
    good = sq > 0
    r = torch.sqrt(torch.where(good, sq, torch.ones_like(sq)))
    n = torch.where(good, v, torch.zeros_like(v)) / r
    out: Dict[int, Tensor] = {
        0: v.new_full(lead + (1,), float(np.sqrt(1.0 / (4.0 * np.pi))))}
    if lmax == 0:
        return out
    gate = good.to(v.dtype)
    y1 = float(np.sqrt(3.0 / (4.0 * np.pi))) * (n @ _const(_P_YZX.T, v)) * gate
    out[1] = y1
    yp = y1
    for l in range(2, lmax + 1):
        prod = (y1[..., :, None] * yp[..., None, :]).reshape(
            lead + (3 * (2 * l - 1),))
        yp = prod @ _const(coeffs[l].T, v)
        out[l] = yp
    return out


def get_basis(d: Tensor, max_degree: int) -> Dict[str, Tensor]:
    """Equivariant weight basis over edge vectors ``d`` [..., 3]: dict
    ``"{d_in},{d_out}"`` -> [..., 1, 2*d_out+1, 1, 2*d_in+1, n_J] with
    n_J = 2*min(d_in,d_out)+1, J ascending from |d_in-d_out| (the
    reference's ``get_basis`` contract, ``models/utils.py:10-45``). Each
    J-slice K_J satisfies K_J(R x) = D^{d_out}(R) K_J(x) D^{d_in}(R)^T.
    On ``d``'s device and in its dtype; gradients flow to ``d``."""
    sh = precompute_sh(d, 2 * max_degree)
    lead = d.shape[:-1]
    basis: Dict[str, Tensor] = {}
    for d_in in range(max_degree + 1):
        for d_out in range(max_degree + 1):
            ks = [sh[j] @ basis_intertwiner(j, d_out, d_in, d.dtype, d.device)
                  for j in range(abs(d_in - d_out), d_in + d_out + 1)]
            basis[f"{d_in},{d_out}"] = torch.stack(ks, dim=-1).reshape(
                lead + (1, 2 * d_out + 1, 1, 2 * d_in + 1, len(ks)))
    return basis
