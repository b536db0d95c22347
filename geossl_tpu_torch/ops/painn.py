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

* ``painn_message_fused`` -> ``csrc/painn_fwd.cu`` (replaces ``_fwd_kernel``);
  differentiable: its backward is ``painn_bwd``
* ``painn_bwd``           -> ``csrc/painn_bwd.cu`` (replaces ``_bwd_kernel``);
  first order only: the JAX package's second-order path (MD17 forces) is
  not ported, and a double backward on CUDA raises NotImplementedError
* ``painn_stack_infer``   -> ``csrc/painn_stack.cu`` (replaces
  ``_stack_kernel`` in inference mode); raises under autograd on CUDA

The symmetric pair (``_fwd_sym_kernel``/``_bwd_sym_kernel``) is not ported:
``painn_message(symmetric=True)`` raises on CUDA where the JAX dispatcher
would take it. The kernels compute in plain f32 (no TF32).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F_

from geossl_tpu_torch.models.common import jax_linspace
from geossl_tpu_torch.ops import _build
from geossl_tpu_torch.ops._launch import (
    check_launch,
    check_smem,
    counted,
    on_cpu,
    ptr,
    refuse_grad,
    stream,
)
from geossl_tpu_torch.ops.cfconv import KERNEL_F, sparse_auto, sym_profitable

# Largest N the whole-stack kernel accepts (as painn_pallas.STACK_MAX_N).
STACK_MAX_N = 128
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
                          epsilon=1e-8):
    """Plain whole-stack chain, the math of ``_stack_kernel``: per block the
    x-MLP, the message pass, the mixing. Returns (q [B,N,F], mu [B,N,3F])."""
    wd1, bd1, wd2, bd2, wk, bk, wmix, w1, b1, w2, b2 = stacked
    q = q0
    mu = torch.zeros(q0.shape[:2] + (3 * q0.shape[-1],), dtype=q0.dtype,
                     device=q0.device)
    for k in range(wd1.shape[0]):
        x = _xmlp(q, wd1[k], bd1[k], wd2[k], bd2[k])
        dq, dmu = painn_message_reference(dist, gate, dirx, diry, dirz, x, mu,
                                          wk[k], bk[k], cutoff)
        q, mu = _mixing(q + dq, mu + dmu, wmix[k], w1[k], b1[k], w2[k], b2[k],
                        epsilon)
    return q, mu


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


def _launch_painn_fwd(dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff,
                      sparse):
    _check("painn_fwd", dist, gate, (dirx, diry, dirz), x, mu, wk, bk)
    b, ni, nj = dist.shape
    num_r = wk.shape[0]
    check_smem("painn_fwd", _build.kernel_fn(
        "painn_fwd", "painn_fwd_smem_bytes", [ctypes.c_int, ctypes.c_int],
        ctypes.c_size_t)(num_r, nj))
    fn = _build.kernel_fn(
        "painn_fwd", "painn_fwd",
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
        + [ctypes.c_int, ctypes.c_void_p])
    dq = torch.empty((b, ni, KERNEL_F), dtype=torch.float32, device=dist.device)
    dmu = torch.empty((b, ni, 3 * KERNEL_F), dtype=torch.float32,
                      device=dist.device)
    delta, coeff = _rbf_consts(cutoff, num_r)
    err = fn(*map(ptr, (dist, gate, dirx, diry, dirz, x, mu, wk, bk, dq, dmu)),
             b, ni, nj, KERNEL_F, num_r, delta, coeff, int(sparse),
             stream(dist))
    check_launch("painn_fwd", err)
    return dq, dmu


class _PaiNNMessage(torch.autograd.Function):
    """``painn_fwd`` forward, ``painn_bwd`` backward (first order only: a
    backward that builds a graph raises)."""

    @staticmethod
    def forward(ctx, dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff,
                sparse):
        ctx.save_for_backward(dist, gate, dirx, diry, dirz, x, mu, wk, bk)
        ctx.consts = (cutoff, sparse)
        return _launch_painn_fwd(dist, gate, dirx, diry, dirz, x, mu, wk, bk,
                                 cutoff, sparse)

    @staticmethod
    def backward(ctx, gq, gmu):
        if torch.is_grad_enabled():  # create_graph: a second order is asked
            raise NotImplementedError(
                "painn_bwd is first order only: the second-order path of "
                "painn_pallas._painn_bwd (MD17 force training) is not ported")
        grads = painn_bwd(*ctx.saved_tensors, gq.contiguous(),
                          gmu.contiguous(), *ctx.consts)
        return (*grads, None, None)


@counted("painn_fwd")
def painn_message_fused(dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff,
                        sparse=False):
    """(dq [B,Ni,F], dmu [B,Ni,3F]). ``sparse`` skips 8x8 pair tiles whose
    gate is all zero (same output). Differentiable on both devices (on CUDA
    through ``painn_bwd``)."""
    args = (dist, gate, dirx, diry, dirz, x, mu, wk, bk)
    if on_cpu("painn_fwd", *args):
        return painn_message_reference(*args, cutoff)
    out = _PaiNNMessage.apply(*args, cutoff, sparse)
    painn_message_fused.launches += 1
    return out


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
    _check("painn_bwd", dist, gate, (dirx, diry, dirz), x, mu, wk, bk)
    b, ni, nj = dist.shape
    num_r, f3 = wk.shape
    if gq.shape != (b, ni, KERNEL_F) or gmu.shape != (b, ni, f3):
        raise ValueError(f"painn_bwd: cotangents gq {tuple(gq.shape)}, gmu "
                         f"{tuple(gmu.shape)} do not match [B,Ni,F], [B,Ni,3F]")
    check_smem("painn_bwd", _build.kernel_fn(
        "painn_bwd", "painn_bwd_smem_bytes", [ctypes.c_int, ctypes.c_int],
        ctypes.c_size_t)(num_r, ni))
    blocks = _build.kernel_fn("painn_bwd", "painn_bwd_blocks",
                              [ctypes.c_int, ctypes.c_int])(b, nj)
    fn = _build.kernel_fn(
        "painn_bwd", "painn_bwd",
        [ctypes.c_void_p] * 20 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
        + [ctypes.c_int, ctypes.c_void_p])
    dev = dist.device
    ddist, dgate, ddx, ddy, ddz = (torch.empty_like(dist) for _ in range(5))
    dx, dmu = torch.empty_like(x), torch.empty_like(mu)
    size = (num_r + 1) * f3  # dWk rows, then dbk
    part = torch.empty((blocks, size), dtype=torch.float32, device=dev)
    wgrad = torch.empty(size, dtype=torch.float32, device=dev)
    delta, coeff = _rbf_consts(cutoff, num_r)
    err = fn(*map(ptr, (*args, gq, gmu, dx, dmu, ddist, dgate, ddx, ddy, ddz,
                        part, wgrad)),
             b, ni, nj, KERNEL_F, num_r, delta, coeff, int(sparse), stream(dist))
    check_launch("painn_bwd", err)
    painn_bwd.launches += 1
    dwk, dbk = wgrad.view(num_r + 1, f3).split([num_r, 1])
    return ddist, dgate, ddx, ddy, ddz, dx, dmu, dwk, dbk.view(f3)


def painn_message(dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff,
                  symmetric=False, sparse="auto"):
    """Dispatcher, routed as ``painn_pallas.painn_message``: the plain-mode
    kernel with occupancy gating from N=128 ('auto'). ``symmetric=True``
    (symmetric dist/gate and antisymmetric directions) would take the
    symmetric kernel from N=256, which is not ported: there it runs the
    plain version on the CPU and raises on CUDA."""
    args = (dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff)
    n = dist.shape[-1]
    if symmetric and sym_profitable(n):  # painn_sym_profitable's sizes
        if dist.device.type == "cpu":
            return painn_message_reference(*args)
        raise NotImplementedError(
            "painn_message(symmetric=True): the symmetric kernels (#10/#11, "
            "painn_pallas._fwd_sym_kernel/_bwd_sym_kernel) are not ported")
    return painn_message_fused(*args, sparse_auto(n, sparse))


@counted("painn_stack")
def painn_stack_infer(dist, gate, dirx, diry, dirz, q0, stacked, cutoff,
                      epsilon=1e-8):
    """(q [B,N,F], mu [B,N,3F]) after all interaction and mixing blocks
    (inference only, as ``painn_pallas.painn_stack_infer``). ``stacked`` is
    the 11-tuple of per-block weight stacks, [in, out] layout: (wd1 [L,F,F],
    bd1 [L,F], wd2 [L,F,3F], bd2 [L,3F], wk [L,R,3F], bk [L,3F],
    wmix [L,F,2F], w1 [L,2F,F], b1 [L,F], w2 [L,F,3F], b2 [L,3F]). The
    kernel skips 8x8 tiles whose gate is all zero."""
    b, n, _ = dist.shape
    if n > STACK_MAX_N:
        raise ValueError(f"painn_stack: N={n} exceeds {STACK_MAX_N}; use the "
                         "per-block path")
    pair = (dist, gate, dirx, diry, dirz)
    if on_cpu("painn_stack", *pair, q0, *stacked):
        return painn_stack_reference(*pair, q0, stacked, cutoff, epsilon)
    refuse_grad("painn_stack", "it is inference only; train through the "
                "per-block path (PaiNN.forward)", *pair, q0, *stacked)
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
        raise ValueError(f"painn_stack: kernel takes F={KERNEL_F} and the "
                         f"weight stacks {want}; got q0 {tuple(q0.shape)}, "
                         f"stacks {got}")
    check_smem("painn_stack", _build.kernel_fn(
        "painn_stack", "painn_stack_smem_bytes", [ctypes.c_int, ctypes.c_int],
        ctypes.c_size_t)(n, num_r))
    fn = _build.kernel_fn(
        "painn_stack", "painn_stack",
        [ctypes.c_void_p] * 20 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
        + [ctypes.c_void_p])
    q = torch.empty_like(q0)
    mu = torch.empty((b, n, 3 * f), dtype=torch.float32, device=q0.device)
    # x and the new messages of every block, per graph, owned by its block
    work = torch.empty((b, n, 6 * f), dtype=torch.float32, device=q0.device)
    delta, coeff = _rbf_consts(cutoff, num_r)
    err = fn(*map(ptr, (*pair, q0, *stacked, q, mu, work)), b, n, f, num_r,
             n_layers, delta, coeff, float(epsilon), stream(dist))
    check_launch("painn_stack", err)
    painn_stack_infer.launches += 1
    return q, mu
