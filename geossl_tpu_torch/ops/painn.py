"""PaiNN's message pass on the card: kernel wrappers, their plain versions
and the dispatcher (counterpart of ``geossl_tpu/ops/painn_pallas.py``).

Per interaction layer, on the ``[B,N,N]`` pair grid:

    w        = (phi(d) Wk + bk) * gate        (per-pair filters, 3F wide)
    wq,wr,wm = split(w);  xq,xr,xm = split(x_j)
    dq[i,f]    = sum_j wq xq_j
    dmu[i,c,f] = sum_j wr xr_j dir_c[i,j] + sum_j wm xm_j mu_c[j,f]

with ``phi`` PaiNN's Gaussian RBF (offsets linspace(0, cutoff, R), width one
offset step). Directions come as three ``[B,N,N]`` components and ``mu`` as
``[B,N,3F]`` in the c-major layout ``mu[..., c*F + f]``, as the JAX package
passes them.

Each wrapper takes the plain PyTorch version for tensors on the CPU and
launches its hand-written CUDA kernel (``csrc/``) for tensors on a CUDA
device; anything else raises. Each counts its launches in
``<wrapper>.launches`` (``ops/_launch.py``).

Kernels:

* ``painn_message_fused``     -> ``csrc/painn_fwd.cu`` (replaces
  ``_fwd_kernel``); differentiable: its backward is ``painn_bwd``
* ``painn_bwd``               -> ``csrc/painn_bwd.cu`` (replaces
  ``_bwd_kernel``)
* ``painn_message_fused_sym`` -> ``csrc/painn_fwd.cu`` in symmetric mode
  (replaces ``_fwd_sym_kernel``); differentiable: its backward is
  ``painn_bwd_sym``
* ``painn_bwd_sym``           -> ``csrc/painn_bwd.cu`` in symmetric mode
  (replaces ``_bwd_sym_kernel``); the cotangents of dist, gate and the
  three directions come back placed (``ops/cfconv.place_sym_cotangent``)
* ``painn_stack_infer``       -> ``csrc/painn_stack.cu`` (replaces
  ``_stack_kernel`` in inference mode); raises under autograd on CUDA
* ``painn_stack_train``       -> ``csrc/painn_stack.cu`` in save_residuals
  mode (replaces ``_stack_kernel`` as ``painn_stack_train`` runs it);
  differentiable: its backward runs the per-block chain, with ``painn_bwd``
  for each message pass

The two message-pass Functions take a double backward (MD17's force
training): their backward is itself a Function (``_PaiNNBwd``) whose
forward launches the backward kernel and whose backward is
:func:`painn_bwd_bwd` / :func:`painn_bwd_sym_bwd`, autograd over the plain
backward, as the JAX package's XLA ``_painn_bwd_bwd`` /
``_painn_sym_bwd_bwd``. The stack's Function is first order only, as the
JAX package's: a double backward through it raises NotImplementedError.
Every kernel runs its products (the filter; the backwards also dWk and
dphi; the stack also its dense layers) on the tensor cores in 3xTF32
(``csrc/mma_tf32.cuh``), within f32 rounding of the plain version, over a
work list made on the device. The symmetric pair is the plain pair's
kernels in their ``SYM`` mode: one filter per unordered pair of 8x8
tiles, the mirror tile's messages added with atomics. The stack is one
cooperative launch, its rows written without atomics: two launches give
bitwise the same output.

The symmetric pair is for symmetric dist/gate and antisymmetric directions
only (dir[j, i] = -dir[i, j]): PaiNN's geometry gives them without
``max_neighbors`` (a truncated neighbour list is asymmetric). The dispatcher
trusts the caller, as the JAX one does. Its pair cotangents are exact only
upstream of the positions (a gradient to dist, gate or a direction grid
itself is the placed one).

Each launch is also a custom op (``ops/_launch.kernel_op``):
``geossl_torch::painn_fwd`` and ``painn_bwd`` (both modes; the backward's
weight gradients as one flat tensor), ``painn_stack`` (inference) and
``painn_stack_train`` (save_residuals).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F_
from torch import Tensor

from geossl_tpu_torch.models.common import jax_linspace
from geossl_tpu_torch.ops import _build
from geossl_tpu_torch.ops._launch import (
    check_launch,
    check_smem,
    counted,
    flat,
    fresh_thread,
    kernel_op,
    launch,
    on_cpu,
    ptr,
    refuse_grad,
    refuse_second_order,
    stream,
)
from geossl_tpu_torch.ops.cfconv import second_order, sparse_auto

# Feature width the PaiNN kernels' tiling is written for (csrc/pair_tile.cuh's
# kF; its filter is 3F wide); the PaiNN kernels take this width only.
KERNEL_F = 128
# Largest N the whole-stack kernel accepts (as painn_pallas.STACK_MAX_N).
STACK_MAX_N = 128
# PaiNN takes the symmetric kernel pair from this N up (the JAX package's
# painn_pallas.painn_sym_profitable threshold). On the H100 the pair beats
# the plain pair at the LBA shape (B=64, N=512; PERF.md §6), so
# PaiNN.forward asks for it whenever its pair grids are symmetric.
_SYM_MIN_N = 256


def sym_profitable(n: int) -> bool:
    """True when ``painn_message(symmetric=True)`` takes the symmetric kernel
    pair at pair-grid size ``n``."""
    return n >= _SYM_MIN_N


# The backward kernel keeps the R filter rows and the bias row in one
# 32-row thread layout.
MAX_R = 31
# -- plain versions -----------------------------------------------------------


def _rbf(dist, num_r, cutoff):
    """The RBF of ``painn_message_reference`` in the JAX package: f32
    offsets, the coefficient of the exact step."""
    offsets = jax_linspace(cutoff, num_r, device=dist.device).to(dist.dtype)
    delta = cutoff / (num_r - 1)
    diff = dist[..., None] - offsets
    return torch.exp((-0.5 / delta**2) * diff * diff)


def painn_message_reference(dist, gate, dirx, diry, dirz, x, mu, wk, bk,
                            cutoff, phi=None):
    """Plain message pass: materializes the [B,N,N,3F] gated filters.
    Returns (dq [B,N,F], dmu [B,N,3F]). ``phi`` [B,N,N,R] replaces the RBF
    (the model's plain path passes its own, as the JAX model does)."""
    if phi is None:
        phi = _rbf(dist, wk.shape[0], cutoff)
    w3 = (phi @ wk + bk) * gate[..., None]
    f = x.shape[-1] // 3
    wq, wr, wm = w3[..., :f], w3[..., f:2 * f], w3[..., 2 * f:]
    xq, xr, xm = x[..., :f], x[..., f:2 * f], x[..., 2 * f:]
    dq = torch.einsum("bijf,bjf->bif", wq, xq)
    dmu = []
    for c, dir_c in enumerate((dirx, diry, dirz)):
        mu_c = mu[..., c * f:(c + 1) * f]
        dmu.append(torch.einsum("bijf,bjf,bij->bif", wr, xr, dir_c)
                   + torch.einsum("bijf,bjf,bjf->bif", wm, xm, mu_c))
    return dq, torch.cat(dmu, dim=-1)


def painn_bwd_reference(dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu,
                        cutoff):
    """Plain backward of :func:`painn_message_reference` for the cotangents
    (gq [B,N,F], gmu [B,N,3F]), by autograd: (ddist, dgate, ddirx, ddiry,
    ddirz, dx, dmu, dwk, dbk), the order of ``painn_pallas._painn_bwd``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (dist, gate, dirx, diry, dirz, x, mu, wk, bk)]
        out = painn_message_reference(*ins, cutoff)
        return torch.autograd.grad(out, ins, (gq, gmu))


# The symmetric pair's plain versions are the plain pair's: the symmetric
# kernels compute the same function, and painn_bwd_sym_reference returns the
# true (unplaced) cotangents, as cfconv_bwd_sym_reference does.
painn_message_fused_sym_reference = painn_message_reference
painn_bwd_sym_reference = painn_bwd_reference


def _xmlp(q, wd1, bd1, wd2, bd2):
    return F_.silu(q @ wd1 + bd1) @ wd2 + bd2


def _mixing(q, mu, wmix, w1, b1, w2, b2, epsilon):
    """PaiNN's mixing block on [B,N,F] / [B,N,3F] tensors."""
    b, n, f = q.shape
    mu4 = mu.reshape(b, n, 3, f)
    v, w = torch.split(mu4 @ wmix, f, dim=-1)
    vn = torch.sqrt(torch.sum(v * v, dim=-2) + epsilon)
    x = _xmlp(torch.cat([q, vn], dim=-1), w1, b1, w2, b2)
    dq, dgate, dqmu = torch.split(x, f, dim=-1)
    q = q + dq + dqmu * torch.sum(v * w, dim=-2)
    mu4 = mu4 + dgate[:, :, None, :] * w
    return q, mu4.reshape(b, n, 3 * f)


def painn_stack_reference(dist, gate, dirx, diry, dirz, q0, stacked, cutoff,
                          epsilon=1e-8, save_residuals=False):
    """Plain whole-stack chain, the math of ``_stack_kernel``: per block the
    x-MLP, the message pass, the mixing. Returns (q [B,N,F], mu [B,N,3F]);
    with ``save_residuals`` also (qs, mus, qps, mups) [B,L,N,F or 3F]: q and
    mu at each block's entry and at its mixing's entry."""
    wd1, bd1, wd2, bd2, wk, bk, wmix, w1, b1, w2, b2 = stacked
    q = q0
    mu = torch.zeros(q0.shape[:2] + (3 * q0.shape[-1],), dtype=q0.dtype,
                     device=q0.device)
    res = ([], [], [], [])
    for k in range(wd1.shape[0]):
        x = _xmlp(q, wd1[k], bd1[k], wd2[k], bd2[k])
        dq, dmu = painn_message_reference(dist, gate, dirx, diry, dirz, x, mu,
                                          wk[k], bk[k], cutoff)
        entry = (q, mu)
        q, mu = q + dq, mu + dmu
        if save_residuals:
            for r, t in zip(res, (*entry, q, mu)):
                r.append(t)
        q, mu = _mixing(q, mu, wmix[k], w1[k], b1[k], w2[k], b2[k], epsilon)
    if not save_residuals:
        return q, mu
    return (q, mu, *(torch.stack(r, dim=1) for r in res))


# -- kernel wrappers ------------------------------------------------------------


def _rbf_consts(cutoff, num_r):
    delta = cutoff / (num_r - 1)
    return float(delta), float(-0.5 / delta**2)


def _check(name, dist, gate, dirs, x, mu, wk, bk):
    b, ni, nj = dist.shape
    f3 = x.shape[-1]
    num_r = wk.shape[0]
    if f3 != 3 * KERNEL_F or wk.shape != (num_r, f3) or bk.shape != (f3,) \
            or not 2 <= num_r <= MAX_R:
        raise ValueError(
            f"{name}: kernel takes F={KERNEL_F}, Wk [R,3F] with 2 <= R <= "
            f"{MAX_R}; got x {tuple(x.shape)}, Wk {tuple(wk.shape)}")
    if any(t.shape != dist.shape for t in (gate, *dirs)) \
            or x.shape != (b, nj, f3) or mu.shape != (b, nj, f3):
        raise ValueError(f"{name}: shapes dist {tuple(dist.shape)}, x "
                         f"{tuple(x.shape)}, mu {tuple(mu.shape)} disagree")


def _painn_fwd_fake(dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff,
                    symmetric, sparse):
    b, ni = dist.shape[:2]
    f3 = x.shape[-1]
    return x.new_empty((b, ni, f3 // 3)), x.new_empty((b, ni, f3))


def _painn_fwd_plain(dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff,
                     symmetric, sparse):
    return painn_message_reference(dist, gate, dirx, diry, dirz, x, mu, wk, bk,
                                   cutoff)


@kernel_op("painn_fwd", _painn_fwd_fake, _painn_fwd_plain)
def _launch_painn_fwd(dist: Tensor, gate: Tensor, dirx: Tensor, diry: Tensor,
                      dirz: Tensor, x: Tensor, mu: Tensor, wk: Tensor,
                      bk: Tensor, cutoff: float, symmetric: bool,
                      sparse: bool) -> tuple[Tensor, Tensor]:
    name = "painn_fwd_sym" if symmetric else "painn_fwd"
    _check(name, dist, gate, (dirx, diry, dirz), x, mu, wk, bk)
    b, ni, nj = dist.shape
    if symmetric and ni != nj:
        raise ValueError(f"{name}: the symmetric mode needs a square grid")
    num_r = wk.shape[0]
    check_smem(name, _build.kernel_fn(
        "painn_fwd", "painn_fwd_smem_bytes", [ctypes.c_int],
        ctypes.c_size_t)(int(symmetric)))
    fn = _build.kernel_fn(
        "painn_fwd", "painn_fwd",
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    dev = dist.device
    # the symmetric mode adds every output row with atomics; the plain mode
    # writes each row once. Both take a work list made on the device (tile
    # flags, per-item counts and their prefix sums, the tile list)
    alloc = torch.zeros if symmetric else torch.empty
    dq = alloc((b, ni, KERNEL_F), dtype=torch.float32, device=dev)
    dmu = alloc((b, ni, 3 * KERNEL_F), dtype=torch.float32, device=dev)
    ws = torch.empty(_build.kernel_fn(
        "painn_fwd", "painn_fwd_ws_ints", [ctypes.c_int] * 3,
        ctypes.c_size_t)(b, ni, nj), dtype=torch.int32, device=dev)
    delta, coeff = _rbf_consts(cutoff, num_r)
    err = fn(*map(ptr, (dist, gate, dirx, diry, dirz, x, mu, wk, bk, dq, dmu,
                        ws)),
             b, ni, nj, KERNEL_F, num_r, delta, coeff, int(symmetric),
             int(sparse), stream(dist))
    check_launch(name, err)
    return dq, dmu


class _PaiNNMessage(torch.autograd.Function):
    """``painn_fwd`` forward, ``painn_bwd`` backward, or with ``symmetric``
    both in symmetric mode (``painn_bwd_sym``: the pair cotangents placed,
    exact upstream of the positions). The backward runs through
    ``_PaiNNBwd``, so a double backward reaches the second order."""

    @staticmethod
    def forward(ctx, dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff,
                symmetric, sparse):
        ctx.save_for_backward(dist, gate, dirx, diry, dirz, x, mu, wk, bk)
        ctx.consts = (cutoff, sparse)
        ctx.symmetric = symmetric
        return launch(_launch_painn_fwd, dist, gate, dirx, diry,
                      dirz, x, mu, wk, bk, float(cutoff), symmetric,
                      bool(sparse))

    @staticmethod
    def backward(ctx, gq, gmu):
        grads = _PaiNNBwd.apply(*ctx.saved_tensors, gq.contiguous(),
                                gmu.contiguous(), *ctx.consts, ctx.symmetric)
        return (*grads, None, None, None)


class _PaiNNBwd(torch.autograd.Function):
    """The first-order backward as a differentiable function of (dist, gate,
    dirx, diry, dirz, x, mu, Wk, bk, gq, gmu): its forward is the
    ``painn_bwd`` kernel (with ``symmetric``, ``painn_bwd_sym``), its
    backward :func:`painn_bwd_bwd` (:func:`painn_bwd_sym_bwd`). It runs only
    where the forward ran the kernel, so its tensors are on the card."""

    @staticmethod
    def forward(ctx, dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu,
                cutoff, sparse, symmetric):
        args = (dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu)
        ctx.save_for_backward(*args)
        ctx.cutoff = cutoff
        ctx.symmetric = symmetric
        bwd = painn_bwd_sym if symmetric else painn_bwd
        return bwd(*args, cutoff, sparse)

    @staticmethod
    def backward(ctx, *cts):
        second = painn_bwd_sym_bwd if ctx.symmetric else painn_bwd_bwd
        grads = second(*ctx.saved_tensors, cts, ctx.cutoff)
        return (*grads, None, None, None)


def painn_bwd_bwd(dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu, cts,
                  cutoff, _places=()):
    """Second order of :func:`painn_bwd`: for the cotangents ``cts`` of its
    nine outputs, the cotangents of (dist, gate, dirx, diry, dirz, x, mu,
    Wk, bk, gq, gmu), by autograd over :func:`painn_message_reference` (JAX
    ``painn_pallas._painn_bwd_bwd``). Materializes the [B,N,N,3F] filter
    grid."""
    return second_order(lambda *a: painn_message_reference(*a, cutoff),
                        (dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq,
                         gmu), 9, cts, _places)


def painn_bwd_sym_bwd(dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu,
                      cts, cutoff):
    """Second order of :func:`painn_bwd_sym`, whose pair cotangents come back
    placed: :func:`painn_bwd_bwd` with the placement's transpose applied to
    the cotangents of ddist and dgate and, antisymmetric, of the three ddir
    (JAX ``painn_pallas._painn_sym_bwd_bwd``). The two agree on the
    (anti)symmetric cotangents a chain through the positions gives."""
    return painn_bwd_bwd(dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu,
                         cts, cutoff,
                         {0: False, 1: False, 2: True, 3: True, 4: True})


@counted("painn_fwd")
def painn_message_fused(dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff,
                        sparse=False):
    """(dq [B,Ni,F], dmu [B,Ni,3F]). ``sparse`` skips 8x8 pair tiles whose
    gate is all zero (same output). Differentiable on both devices (on CUDA
    through ``painn_bwd``)."""
    args = (dist, gate, dirx, diry, dirz, x, mu, wk, bk)
    if on_cpu("painn_fwd", *args):
        return painn_message_reference(*args, cutoff)
    out = _PaiNNMessage.apply(*args, cutoff, False, sparse)
    painn_message_fused.launches += 1
    return out


@counted("painn_fwd_sym")
def painn_message_fused_sym(dist, gate, dirx, diry, dirz, x, mu, wk, bk,
                            cutoff, sparse=False):
    """Same output as :func:`painn_message_fused` for SYMMETRIC dist/gate
    and ANTISYMMETRIC directions only: the kernel computes the 8x8 tiles on
    and above the diagonal and emits the mirrored messages of the ones below
    (direction terms negated). Differentiable on both devices (on CUDA
    through ``painn_bwd_sym``, whose pair cotangents are placed)."""
    args = (dist, gate, dirx, diry, dirz, x, mu, wk, bk)
    if on_cpu("painn_fwd_sym", *args):
        return painn_message_fused_sym_reference(*args, cutoff)
    out = _PaiNNMessage.apply(*args, cutoff, True, sparse)
    painn_message_fused_sym.launches += 1
    return out


def _painn_bwd_fake(dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu,
                    cutoff, symmetric, sparse):
    return (*(torch.empty_like(dist) for _ in range(5)), torch.empty_like(x),
            torch.empty_like(mu), wk.new_empty(((wk.shape[0] + 1) * wk.shape[1],)))


def _painn_bwd_plain(dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu,
                     cutoff, symmetric, sparse):
    *grads, dwk, dbk = fresh_thread(painn_bwd_reference, dist, gate, dirx,
                                    diry, dirz, x, mu, wk, bk, gq, gmu, cutoff)
    return (*grads, flat((dwk, dbk)))


def _split_wgrad(wgrad, wk):
    """(dWk [R,3F], dbk [3F]) from the kernel's flat weight gradient."""
    num_r, f3 = wk.shape
    dwk, dbk = wgrad.view(num_r + 1, f3).split([num_r, 1])
    return dwk, dbk.view(f3)


@kernel_op("painn_bwd", _painn_bwd_fake, _painn_bwd_plain)
def _launch_painn_bwd(dist: Tensor, gate: Tensor, dirx: Tensor, diry: Tensor,
                      dirz: Tensor, x: Tensor, mu: Tensor, wk: Tensor,
                      bk: Tensor, gq: Tensor, gmu: Tensor, cutoff: float,
                      symmetric: bool, sparse: bool
                      ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                 Tensor, Tensor, Tensor]:
    """(ddist, dgate, ddirx, ddiry, ddirz, dx, dmu, the flat weight
    gradient dWk|dbk)."""
    name = "painn_bwd_sym" if symmetric else "painn_bwd"
    _check(name, dist, gate, (dirx, diry, dirz), x, mu, wk, bk)
    b, ni, nj = dist.shape
    num_r, f3 = wk.shape
    if gq.shape != (b, ni, KERNEL_F) or gmu.shape != (b, ni, f3):
        raise ValueError(f"{name}: cotangents gq {tuple(gq.shape)}, gmu "
                         f"{tuple(gmu.shape)} do not match [B,Ni,F], [B,Ni,3F]")
    if symmetric and ni != nj:
        raise ValueError(f"{name}: the symmetric mode needs a square grid")
    check_smem(name, _build.kernel_fn(
        "painn_bwd", "painn_bwd_smem_bytes", [ctypes.c_int] * 2,
        ctypes.c_size_t)(ni, int(symmetric)))
    blocks = _build.kernel_fn("painn_bwd", "painn_bwd_blocks",
                              [ctypes.c_int, ctypes.c_int])(b, nj)
    fn = _build.kernel_fn(
        "painn_bwd", "painn_bwd",
        [ctypes.c_void_p] * 21 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    dev = dist.device
    ddist, dgate, ddx, ddy, ddz = (torch.empty_like(dist) for _ in range(5))
    # the symmetric mode adds every dx and dmu row with atomics
    alloc = torch.zeros_like if symmetric else torch.empty_like
    dx, dmu = alloc(x), alloc(mu)
    size = (num_r + 1) * f3  # dWk rows, then dbk
    part = torch.empty((blocks, size), dtype=torch.float32, device=dev)
    wgrad = torch.empty(size, dtype=torch.float32, device=dev)
    # the work list, made on the device: tile flags, per-item tile counts
    # and their prefix sums
    ws = torch.empty(_build.kernel_fn(
        "painn_bwd", "painn_bwd_ws_ints", [ctypes.c_int] * 3,
        ctypes.c_size_t)(b, ni, nj), dtype=torch.int32, device=dev)
    delta, coeff = _rbf_consts(cutoff, num_r)
    err = fn(*map(ptr, (dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu,
                        dx, dmu, ddist, dgate, ddx, ddy, ddz, part, wgrad,
                        ws)),
             b, ni, nj, KERNEL_F, num_r, delta, coeff, int(symmetric),
             int(sparse), stream(dist))
    check_launch(name, err)
    return ddist, dgate, ddx, ddy, ddz, dx, dmu, wgrad


@counted("painn_bwd")
def painn_bwd(dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu, cutoff,
              sparse=False):
    """Backward of :func:`painn_message_fused` for the cotangents (gq, gmu):
    (ddist, dgate, ddirx, ddiry, ddirz, dx, dmu, dwk, dbk). With ``sparse``
    the kernel skips 8x8 tiles whose gate is all zero and writes zeros to
    their five pair cotangents (exact downstream: the gate has value and
    slope zero there); elsewhere, and on the CPU, dgate is the true
    cotangent."""
    args = (dist, gate, dirx, diry, dirz, x, mu, wk, bk)
    if on_cpu("painn_bwd", *args, gq, gmu):
        return painn_bwd_reference(*args, gq, gmu, cutoff)
    *out, wgrad = launch(_launch_painn_bwd, *args, gq, gmu,
                         float(cutoff), False, bool(sparse))
    painn_bwd.launches += 1
    return (*out, *_split_wgrad(wgrad, wk))


@counted("painn_bwd_sym")
def painn_bwd_sym(dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu,
                  cutoff, sparse=False):
    """Backward of :func:`painn_message_fused_sym` for the cotangents
    (gq, gmu), SYMMETRIC dist/gate and ANTISYMMETRIC directions: (ddist,
    dgate, ddirx, ddiry, ddirz, dx, dmu, dwk, dbk). On CUDA the kernel
    computes the 8x8 tiles on and above the diagonal once and returns ddist
    and dgate placed (``place_sym_cotangent(c)``) and the three ddir placed
    antisymmetric (``place_sym_cotangent(c, antisymmetric=True)``); with
    ``sparse`` they are also zero on tiles whose gate is all zero. dx, dmu
    and the weight gradients are the true ones. On the CPU all nine are the
    true cotangents."""
    args = (dist, gate, dirx, diry, dirz, x, mu, wk, bk)
    if on_cpu("painn_bwd_sym", *args, gq, gmu):
        return painn_bwd_sym_reference(*args, gq, gmu, cutoff)
    *out, wgrad = launch(_launch_painn_bwd, *args, gq, gmu,
                         float(cutoff), True, bool(sparse))
    painn_bwd_sym.launches += 1
    return (*out, *_split_wgrad(wgrad, wk))


def painn_message(dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff,
                  symmetric=False, sparse="auto"):
    """Dispatcher, routed as ``painn_pallas.painn_message``: the plain-mode
    kernel with occupancy gating from N=128 ('auto'); with ``symmetric=True``
    the symmetric kernel pair from N=256 (``sym_profitable``, the JAX
    package's threshold). On the H100 that pair's forward and backward
    together beat the plain pair's at the LBA shape (PERF.md §6),
    and ``PaiNN.forward`` sets ``symmetric`` when its pair grids are
    symmetric (no ``max_neighbors``, no caller's ``pair_mask``); the JAX
    model does not (its TPU measured the pair at 0.96x). The caller
    guarantees what ``symmetric`` claims: dist and gate symmetric, the
    directions antisymmetric. Nothing checks it; the pair cotangents are
    then placed, exact only upstream of the positions."""
    args = (dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff)
    n = dist.shape[-1]
    if symmetric and sym_profitable(n):  # painn_sym_profitable's sizes
        return painn_message_fused_sym(*args, sparse_auto(n, sparse))
    return painn_message_fused(*args, sparse_auto(n, sparse))


def _painn_stack_fake(dist, gate, dirx, diry, dirz, q0, stacked, cutoff,
                      epsilon):
    b, n, f = q0.shape
    return torch.empty_like(q0), q0.new_empty((b, n, 3 * f))


def _painn_stack_train_fake(dist, gate, dirx, diry, dirz, q0, stacked, cutoff,
                            epsilon):
    b, n, f = q0.shape
    n_layers = stacked[0].shape[0]
    return (*_painn_stack_fake(dist, gate, dirx, diry, dirz, q0, stacked,
                               cutoff, epsilon),
            *(q0.new_empty((b, n_layers, n, w)) for w in (f, 3 * f, f, 3 * f)))


def _painn_stack_plain(dist, gate, dirx, diry, dirz, q0, stacked, cutoff,
                       epsilon):
    return painn_stack_reference(dist, gate, dirx, diry, dirz, q0, stacked,
                                 cutoff, epsilon)


def _painn_stack_train_plain(dist, gate, dirx, diry, dirz, q0, stacked,
                             cutoff, epsilon):
    return painn_stack_reference(dist, gate, dirx, diry, dirz, q0, stacked,
                                 cutoff, epsilon, save_residuals=True)


@kernel_op("painn_stack", _painn_stack_fake, _painn_stack_plain)
def _launch_painn_stack_infer(dist: Tensor, gate: Tensor, dirx: Tensor,
                              diry: Tensor, dirz: Tensor, q0: Tensor,
                              stacked: Sequence[Tensor], cutoff: float,
                              epsilon: float) -> tuple[Tensor, Tensor]:
    return _launch_painn_stack("painn_stack", (dist, gate, dirx, diry, dirz),
                               q0, stacked, cutoff, epsilon, False)


@kernel_op("painn_stack_train", _painn_stack_train_fake,
           _painn_stack_train_plain)
def _launch_painn_stack_train(dist: Tensor, gate: Tensor, dirx: Tensor,
                              diry: Tensor, dirz: Tensor, q0: Tensor,
                              stacked: Sequence[Tensor], cutoff: float,
                              epsilon: float
                              ) -> tuple[Tensor, Tensor, Tensor, Tensor,
                                         Tensor, Tensor]:
    return _launch_painn_stack("painn_stack_train",
                               (dist, gate, dirx, diry, dirz), q0, stacked,
                               cutoff, epsilon, True)


def _launch_painn_stack(name, pair, q0, stacked, cutoff, epsilon,
                        save_residuals):
    """The whole-stack kernel: (q, mu), then with ``save_residuals`` the
    four residual stacks (qs, mus, qps, mups)."""
    dist = pair[0]
    b, n, _ = dist.shape
    f = q0.shape[-1]
    n_layers, num_r = stacked[4].shape[:2]
    want = ((n_layers, f, f), (n_layers, f), (n_layers, f, 3 * f),
            (n_layers, 3 * f), (n_layers, num_r, 3 * f), (n_layers, 3 * f),
            (n_layers, f, 2 * f), (n_layers, 2 * f, f), (n_layers, f),
            (n_layers, f, 3 * f), (n_layers, 3 * f))
    got = tuple(tuple(t.shape) for t in stacked)
    if f != KERNEL_F or got != want or not 2 <= num_r <= MAX_R \
            or q0.shape != (b, n, f) or any(t.shape != dist.shape
                                            for t in pair[1:]):
        raise ValueError(f"{name}: kernel takes F={KERNEL_F} and the "
                         f"weight stacks {want}; got q0 {tuple(q0.shape)}, "
                         f"stacks {got}")
    check_smem(name, _build.kernel_fn(
        "painn_stack", "painn_stack_smem_bytes", [], ctypes.c_size_t)())
    fn = _build.kernel_fn(
        "painn_stack", "painn_stack",
        [ctypes.c_void_p] * 25 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_void_p])
    dev = q0.device
    q = torch.empty_like(q0)
    mu = torch.empty((b, n, 3 * f), dtype=torch.float32, device=dev)
    # x [B*N, 3F] (the mixing's scratch too) and the messages dq [B*N, F]
    # and dmu [B*N, 3F] of every block; the work list over the gate and the
    # grid barrier
    work = torch.empty(b * n * 7 * f, dtype=torch.float32, device=dev)
    ws = torch.empty(_build.kernel_fn(
        "painn_stack", "painn_stack_ws_ints", [ctypes.c_int] * 2,
        ctypes.c_size_t)(b, n), dtype=torch.int32, device=dev)
    res = [torch.empty((b, n_layers, n, w), dtype=torch.float32, device=dev)
           for w in (f, 3 * f, f, 3 * f)] if save_residuals else []
    res_ptrs = map(ptr, res) if save_residuals else [ctypes.c_void_p(None)] * 4
    delta, coeff = _rbf_consts(cutoff, num_r)
    err = fn(*map(ptr, (*pair, q0, *stacked, q, mu, work)), *res_ptrs, ptr(ws),
             b, n, f, num_r, n_layers, delta, coeff, float(epsilon),
             int(save_residuals), stream(dist))
    check_launch(name, err)
    return (q, mu, *res)


def _check_stack_n(name, n):
    if n > STACK_MAX_N:
        raise ValueError(f"{name}: N={n} exceeds {STACK_MAX_N}; use the "
                         "per-block path")


@counted("painn_stack")
def painn_stack_infer(dist, gate, dirx, diry, dirz, q0, stacked, cutoff,
                      epsilon=1e-8):
    """(q [B,N,F], mu [B,N,3F]) after all interaction and mixing blocks
    (inference only, as ``painn_pallas.painn_stack_infer``). ``stacked`` is
    the 11-tuple of per-block weight stacks, [in, out] layout: (wd1 [L,F,F],
    bd1 [L,F], wd2 [L,F,3F], bd2 [L,3F], wk [L,R,3F], bk [L,3F],
    wmix [L,F,2F], w1 [L,2F,F], b1 [L,F], w2 [L,F,3F], b2 [L,3F]). The
    kernel skips 8x8 tiles whose gate is all zero."""
    _check_stack_n("painn_stack", dist.shape[-1])
    pair = (dist, gate, dirx, diry, dirz)
    if on_cpu("painn_stack", *pair, q0, *stacked):
        return painn_stack_reference(*pair, q0, stacked, cutoff, epsilon)
    refuse_grad("painn_stack", "it is inference only; train through the "
                "per-block path (PaiNN.forward) or painn_stack_train",
                *pair, q0, *stacked)
    q, mu = launch(_launch_painn_stack_infer, *pair, q0,
                   list(stacked), float(cutoff), float(epsilon))
    painn_stack_infer.launches += 1
    return q, mu


def _vjp(fn, *inputs):
    """(fn(*inputs) detached, vjp): vjp(cotangents) gives the cotangents of
    ``inputs``, by autograd."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*ins)
    detached = (tuple(t.detach() for t in out) if isinstance(out, tuple)
                else out.detach())
    return detached, lambda cots: torch.autograd.grad(out, ins, cots)


class _PaiNNStackTrain(torch.autograd.Function):
    """The whole stack with its block boundaries saved (the ``painn_stack``
    kernel in save_residuals mode on CUDA, ``painn_stack_reference`` on the
    CPU); the backward is ``painn_pallas._stack_train_bwd``'s loop: per
    block in reverse, the mixing's and the x-MLP's VJPs in plain PyTorch and
    the message pass's through ``painn_bwd`` (the kernel on CUDA), which
    recomputes the pair grid. mu0 is made inside (zeros): no cotangent.
    First order only."""

    @staticmethod
    def forward(ctx, dist, gate, dirx, diry, dirz, q0, *rest):
        *stacked, cutoff, epsilon, on_host = rest
        pair = (dist, gate, dirx, diry, dirz)
        if on_host:
            q, mu, *res = painn_stack_reference(*pair, q0, stacked, cutoff,
                                                epsilon, save_residuals=True)
        else:
            q, mu, *res = launch(_launch_painn_stack_train, *pair, q0,
                                 list(stacked), float(cutoff), float(epsilon))
        ctx.save_for_backward(*pair, *stacked, *res)
        ctx.consts = (cutoff, epsilon)
        return q, mu

    @staticmethod
    def backward(ctx, gq, gmu):
        refuse_second_order("painn_stack_train")
        cutoff, epsilon = ctx.consts
        saved = ctx.saved_tensors
        pair, stacked, (qs, mus, qps, mups) = saved[:5], saved[5:16], saved[16:]
        wd1, bd1, wd2, bd2, wk, bk, wmix, w1, b1, w2, b2 = stacked
        n_layers = wd1.shape[0]
        sparse = sparse_auto(pair[0].shape[-1], "auto")
        per_k = [[None] * n_layers for _ in range(11)]
        gpair = [torch.zeros_like(t) for t in pair]
        for k in reversed(range(n_layers)):
            _, mix_vjp = _vjp(lambda *a: _mixing(*a, epsilon), qps[:, k],
                              mups[:, k], wmix[k], w1[k], b1[k], w2[k], b2[k])
            gqp, gmup, *gmix = mix_vjp((gq, gmu))
            for i, g in zip(range(6, 11), gmix):
                per_k[i][k] = g
            x, xmlp_vjp = _vjp(_xmlp, qs[:, k], wd1[k], bd1[k], wd2[k], bd2[k])
            *dpair, dx, dmu_in, dwk, dbk = painn_bwd(
                *pair, x.contiguous(), mus[:, k].contiguous(), wk[k], bk[k],
                gqp.contiguous(), gmup.contiguous(), cutoff, sparse)
            for acc, d in zip(gpair, dpair):
                acc += d
            per_k[4][k], per_k[5][k] = dwk, dbk
            gq_x, *gx = xmlp_vjp(dx)
            for i, g in enumerate(gx):
                per_k[i][k] = g
            # the residual paths into the block's inputs
            gq, gmu = gqp + gq_x, gmup + dmu_in
        return (*gpair, gq, *(torch.stack(g) for g in per_k), None, None,
                None)


@counted("painn_stack_train")
def painn_stack_train(dist, gate, dirx, diry, dirz, q0, stacked, cutoff,
                      epsilon=1e-8):
    """Differentiable whole-stack forward (``painn_pallas.painn_stack_train``,
    the same contract as :func:`painn_stack_infer`): (q, mu). Gradients flow
    to dist, gate, the three direction grids, q0 and the 11 weight stacks;
    first order only. The backward's ``painn_bwd`` gates empty tiles from
    N=128 ('auto'), which is exact downstream (its occupancy contract)."""
    _check_stack_n("painn_stack_train", dist.shape[-1])
    pair = (dist, gate, dirx, diry, dirz)
    on_host = on_cpu("painn_stack_train", *pair, q0, *stacked)
    out = _PaiNNStackTrain.apply(*pair, q0, *stacked, cutoff, epsilon,
                                 on_host)
    if not on_host:
        painn_stack_train.launches += 1
    return out
