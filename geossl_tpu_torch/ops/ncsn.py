"""The DDM score-matching head per pair on the card: kernel wrappers and
their plain versions (counterpart of ``geossl_tpu/ops/ncsn_pallas.py``).

``ncsn_score_loss`` returns the per-row sums ``[B, N]`` of the annealed
loss of ``NCSN_version_03`` over the selected pairs. On CPU tensors it is
the plain PyTorch version (differentiable by autograd); on CUDA tensors it
runs ``csrc/ncsn_score.cu``: ``ncsn_score_fwd`` (replaces ``_fwd_kernel``)
forward and ``ncsn_score_bwd`` (replaces ``_bwd_kernel``) backward, first
order only. Gradients flow to the node projections ``u`` and the ten head
weights; dist, noise, sel and sigma are data and get none.

The kernels take emb = 128 only (``KERNEL_E``). Both run the head's
products on the tensor cores in 3xTF32 (``csrc/mma_tf32.cuh``; the forward
l1 W2, the backward also dl1 and dW2), within f32 rounding of the plain
version, over a tile list made on the device, and sum everything in a fixed
order (bitwise repeatable).
"""

from __future__ import annotations

import ctypes

import torch

from geossl_tpu_torch.ops import _build
from geossl_tpu_torch.ops._launch import (
    check_launch,
    check_smem,
    counted,
    on_cpu,
    ptr,
    refuse_second_order,
    stream,
)

# Head width the kernels' thread layout is written for.
KERNEL_E = 128
WEIGHT_NAMES = ("w_d1", "b_d1", "w_d2", "b_d2", "w_od", "b_od", "w2", "b2",
                "w3", "b3")


def weight_shapes(emb: int) -> tuple:
    """Shapes of the ten head weights, in ``WEIGHT_NAMES`` order (the JAX
    package's parameter shapes)."""
    h = emb // 2
    return ((1, emb), (emb,), (emb, 1), (1,), (1, emb), (emb,), (emb, h),
            (h,), (h, 1), (1,))


# -- plain versions -----------------------------------------------------------


def ncsn_score_loss_reference(dist, noise, sel, sigma, u, w_d1, b_d1, w_d2,
                              b_d2, w_od, b_od, w2, b2, w3, b3, anneal):
    """The dense math of ``NCSNv3.__call__`` (``objectives/ncsn.py``),
    reduced to rows: materializes [B,N,N,emb]. The target -(d' - d)/σ² is
    written -ε/σ, its value without the cancellation of d' - d: in f32 that
    difference carries ulp(d) of rounding, ~1e-2 of target error at
    σ = 0.01 (the Pallas kernel writes it so too)."""
    used = sigma[:, None, None]
    perturbed = dist + noise * used
    target = -noise / used
    demb = torch.relu(perturbed[..., None] * w_d1[0] + b_d1) @ w_d2 + b_d2
    d_term = demb @ w_od + b_od  # [B,N,N,emb]
    x = torch.relu(u[:, :, None, :] + u[:, None, :, :] + d_term)
    x = torch.relu(x @ w2 + b2)
    scores = (x @ w3 + b3)[..., 0] / used
    per_pair = 0.5 * (scores - target) ** 2 * used**anneal * sel
    return per_pair.sum(dim=2)


def ncsn_score_bwd_reference(dist, noise, sel, sigma, u, g_rows, *weights,
                             anneal):
    """Plain backward for the row cotangent ``g_rows`` [B,N]: (du, then the
    ten weight gradients), by autograd."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (u, *weights)]
        rows = ncsn_score_loss_reference(dist, noise, sel, sigma, *ins, anneal)
        return torch.autograd.grad(rows, ins, g_rows)


# -- kernel wrappers ------------------------------------------------------------


def _check(name, dist, noise, sel, sigma, u, weights):
    b, n, n2 = dist.shape
    emb = u.shape[-1]
    if emb != KERNEL_E or u.shape != (b, n, emb) or n2 != n:
        raise ValueError(f"{name}: kernel takes emb={KERNEL_E} and square "
                         f"grids; got dist {tuple(dist.shape)}, u "
                         f"{tuple(u.shape)}")
    if noise.shape != dist.shape or sel.shape != dist.shape \
            or sigma.shape != (b,):
        raise ValueError(f"{name}: noise/sel must be [B,N,N] and sigma [B]")
    got = tuple(tuple(w.shape) for w in weights)
    if got != weight_shapes(emb):
        raise ValueError(f"{name}: head weight shapes {got}, want "
                         f"{weight_shapes(emb)}")


@counted("ncsn_score_fwd")
def ncsn_score_fwd(dist, noise, sel, sigma, u, *weights, anneal):
    """Row sums [B,N] of the annealed loss (no autograd graph on CUDA; use
    :func:`ncsn_score_loss` for a differentiable call)."""
    if on_cpu("ncsn_score_fwd", dist, noise, sel, sigma, u, *weights):
        return ncsn_score_loss_reference(dist, noise, sel, sigma, u, *weights,
                                         anneal)
    _check("ncsn_score_fwd", dist, noise, sel, sigma, u, weights)
    b, n, _ = dist.shape
    check_smem("ncsn_score_fwd", _build.kernel_fn(
        "ncsn_score", "ncsn_smem_bytes", [], ctypes.c_size_t)())
    ws_ints, rpart_floats = (_build.kernel_fn(
        "ncsn_score", name, [ctypes.c_int] * 2, ctypes.c_size_t)(b, n)
        for name in ("ncsn_ws_ints", "ncsn_fwd_rpart_floats"))
    fn = _build.kernel_fn(
        "ncsn_score", "ncsn_score_fwd",
        [ctypes.c_void_p] * 18 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p])
    dev = dist.device
    rows = torch.empty((b, n), dtype=torch.float32, device=dev)
    # the work list (tile flags, counts, prefix sums, the tile list) and the
    # row sums' partials of each (block, row tile) segment
    ws = torch.empty(ws_ints, dtype=torch.int32, device=dev)
    rpart = torch.empty(rpart_floats, dtype=torch.float32, device=dev)
    err = fn(*map(ptr, (dist, noise, sel, sigma, u, *weights, rows, rpart,
                        ws)), b, n, KERNEL_E, float(anneal), stream(dist))
    check_launch("ncsn_score_fwd", err)
    ncsn_score_fwd.launches += 1
    return rows


@counted("ncsn_score_bwd")
def ncsn_score_bwd(dist, noise, sel, sigma, u, g_rows, *weights, anneal):
    """(du [B,N,emb], then the ten weight gradients) for the row cotangent
    ``g_rows`` [B,N]."""
    if on_cpu("ncsn_score_bwd", dist, noise, sel, sigma, u, g_rows, *weights):
        return ncsn_score_bwd_reference(dist, noise, sel, sigma, u, g_rows,
                                        *weights, anneal=anneal)
    _check("ncsn_score_bwd", dist, noise, sel, sigma, u, weights)
    b, n, _ = dist.shape
    if g_rows.shape != (b, n):
        raise ValueError(f"ncsn_score_bwd: g_rows {tuple(g_rows.shape)}, "
                         f"want {(b, n)}")
    check_smem("ncsn_score_bwd", _build.kernel_fn(
        "ncsn_score", "ncsn_smem_bytes", [], ctypes.c_size_t)())
    blocks = _build.kernel_fn("ncsn_score", "ncsn_blocks",
                              [ctypes.c_int, ctypes.c_int])(b, n)
    size = _build.kernel_fn("ncsn_score", "ncsn_wgrad_size", [])()
    ws_ints, dpart_floats = (_build.kernel_fn(
        "ncsn_score", name, [ctypes.c_int] * 2, ctypes.c_size_t)(b, n)
        for name in ("ncsn_ws_ints", "ncsn_bwd_dpart_floats"))
    fn = _build.kernel_fn(
        "ncsn_score", "ncsn_score_bwd",
        [ctypes.c_void_p] * 21 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p])
    dev = dist.device
    du = torch.empty_like(u)
    # the work list (tile flags, counts, prefix sums, the tile list), the du
    # partials of the listed tiles and the per-block weight gradients
    ws = torch.empty(ws_ints, dtype=torch.int32, device=dev)
    dpart = torch.empty(dpart_floats, dtype=torch.float32, device=dev)
    part = torch.empty((blocks, size), dtype=torch.float32, device=dev)
    wgrad = torch.empty(size, dtype=torch.float32, device=dev)
    err = fn(*map(ptr, (dist, noise, sel, sigma, u, g_rows, *weights, du,
                        dpart, part, wgrad, ws)),
             b, n, KERNEL_E, float(anneal), stream(dist))
    check_launch("ncsn_score_bwd", err)
    ncsn_score_bwd.launches += 1
    sizes = [w.numel() for w in weights]
    return (du, *(g.view(w.shape) for g, w in
                  zip(torch.split(wgrad, sizes), weights)))


class _NCSNScore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dist, noise, sel, sigma, u, *weights_and_anneal):
        *weights, anneal = weights_and_anneal
        ctx.save_for_backward(dist, noise, sel, sigma, u, *weights)
        ctx.anneal = anneal
        return ncsn_score_fwd(dist, noise, sel, sigma, u, *weights,
                              anneal=anneal)

    @staticmethod
    def backward(ctx, g_rows):
        refuse_second_order("ncsn_score_bwd")
        dist, noise, sel, sigma, u, *weights = ctx.saved_tensors
        grads = ncsn_score_bwd(dist, noise, sel, sigma, u,
                               g_rows.contiguous(), *weights,
                               anneal=ctx.anneal)
        return (None, None, None, None, *grads, None)


def ncsn_score_loss(dist, noise, sel, sigma, u, w_d1, b_d1, w_d2, b_d2, w_od,
                    b_od, w2, b2, w3, b3, anneal):
    """Per-row annealed score-matching loss sums [B, N]; differentiable in
    ``u`` and the head weights on both devices."""
    weights = (w_d1, b_d1, w_d2, b_d2, w_od, b_od, w2, b2, w3, b3)
    if on_cpu("ncsn_score_loss", dist, noise, sel, sigma, u, *weights):
        return ncsn_score_loss_reference(dist, noise, sel, sigma, u, *weights,
                                         anneal)
    return _NCSNScore.apply(dist, noise, sel, sigma, u, *weights,
                            float(anneal))
