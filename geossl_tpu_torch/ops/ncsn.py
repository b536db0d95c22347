"""The DDM score-matching head per pair on the card: kernel wrappers and
their plain versions (counterpart of ``geossl_tpu/ops/ncsn_pallas.py``).

``ncsn_score_loss`` returns the per-row sums ``[B, N]`` of the annealed
loss of ``NCSN_version_03`` over the selected pairs. On CPU tensors it is
the plain PyTorch version (differentiable by autograd); on CUDA tensors it
runs ``csrc/ncsn_score.cu``: ``ncsn_score_fwd`` (replaces ``_fwd_kernel``)
forward and ``ncsn_score_bwd`` (replaces ``_bwd_kernel``) backward, first
order only. Gradients flow to the node projections ``u`` and the ten head
weights; dist, noise, sel and sigma are data and get none.

The kernels take emb up to 256 (``MAX_E``): the source builds once per
width in ``KERNEL_WIDTHS`` (128, 256), and a head runs in the narrowest
instance that holds it, zero-padded to that width inside the launch
functions (exact: every padded unit is relu(0) = 0 and meets zero weights;
outputs are sliced back, so the autograd Function, the ops' fake
implementations and sealed programs keep the user's width). The 256
instance's launches count as ``<kernel>_e256`` (:data:`E256_LAUNCHES`), not
under the wrapper's name. Both instances run the head's products on the
tensor cores in 3xTF32 (``csrc/mma_tf32.cuh``; the forward l1 W2, the
backward also dl1 and dW2), within f32 rounding of the plain version, over
a tile list made on the device, and sum everything in a fixed order
(bitwise repeatable).

Each launch is also a custom op (``ops/_launch.kernel_op``):
``geossl_torch::ncsn_score_fwd`` and ``ncsn_score_bwd`` (the weight
gradients as one flat tensor).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch
from torch import Tensor

from geossl_tpu_torch.ops import _build
from geossl_tpu_torch.ops._launch import (
    check_launch,
    check_smem,
    counted,
    counter,
    flat,
    fresh_thread,
    instance_counter,
    kernel_op,
    launch,
    on_cpu,
    ptr,
    ptr_or_null,
    refuse_second_order,
    stream,
)

# Head widths of the kernels' instances (csrc/ncsn_score.cu built with
# NCSN_E = each): a head of width emb runs in the narrowest that holds it.
KERNEL_WIDTHS = (128, 256)
KERNEL_E = KERNEL_WIDTHS[0]
MAX_E = KERNEL_WIDTHS[-1]
# The wider instance's launch counters, by the wrapper's name: each counts as
# "<name>_e256" in ops/_launch.launch_counts()
E256_LAUNCHES = {name: instance_counter(f"{name}_e256")
                 for name in ("ncsn_score_fwd", "ncsn_score_bwd")}
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


def kernel_width(emb: int) -> int:
    """The width of the kernel instance that runs a head of width ``emb``
    (zero-padded up to it); ValueError above :data:`MAX_E`."""
    for width in KERNEL_WIDTHS:
        if emb <= width:
            return width
    raise ValueError(f"ncsn_score: the kernels take emb up to {MAX_E}; got "
                     f"{emb}")


def _count(name, width):
    """One launch of kernel ``name`` in the instance of head width
    ``width``: the wrapper's count, or the 256 instance's."""
    (E256_LAUNCHES[name] if width == 256 else counter(name)).launches += 1


def pad_head(u, weights, width):
    """``u`` [B,N,E] and the ten head weights zero-padded to a head of
    ``width`` (H = E // 2 to width // 2): every padded unit of the distance
    MLP, of l1 and of x2 is relu(0) = 0 and meets zero weights, so the row
    sums are those of the unpadded head. Nothing is copied at E = width."""
    emb = u.shape[-1]
    if emb == width:
        return u, list(weights)
    h, wh = emb // 2, width // 2
    pad = torch.nn.functional.pad
    de, dh = width - emb, wh - h
    w_d1, b_d1, w_d2, b_d2, w_od, b_od, w2, b2, w3, b3 = weights
    return pad(u, (0, de)), [
        pad(w_d1, (0, de)), pad(b_d1, (0, de)), pad(w_d2, (0, 0, 0, de)),
        b_d2, pad(w_od, (0, de)), pad(b_od, (0, de)),
        pad(w2, (0, dh, 0, de)), pad(b2, (0, dh)), pad(w3, (0, 0, 0, dh)), b3]


def unpad_wgrad(wgrad, emb, width):
    """The flat weight gradient of a ``width`` head (``WEIGHT_NAMES`` order)
    cut back to the ten gradients' ``emb`` parts, flat again."""
    if emb == width:
        return wgrad
    parts = torch.split(wgrad, [math.prod(s) for s in weight_shapes(width)])
    h = emb // 2
    cuts = (lambda g: g[:, :emb], lambda g: g[:emb], lambda g: g[:emb],
            lambda g: g, lambda g: g[:, :emb], lambda g: g[:emb],
            lambda g: g[:emb, :h], lambda g: g[:h], lambda g: g[:h],
            lambda g: g)
    return torch.cat([cut(g.view(shape)).reshape(-1) for cut, g, shape in
                      zip(cuts, parts, weight_shapes(width))])


def _check(name, dist, noise, sel, sigma, u, weights):
    b, n, n2 = dist.shape
    emb = u.shape[-1]
    if emb > MAX_E or u.shape != (b, n, emb) or n2 != n:
        raise ValueError(f"{name}: kernel takes emb <= {MAX_E} and square "
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
    return launch(_launch_ncsn_fwd, dist, noise, sel, sigma, u,
                  list(weights), float(anneal))


def _ncsn_fwd_fake(dist, noise, sel, sigma, u, weights, anneal):
    return dist.new_empty(dist.shape[:2])


def _ncsn_fwd_plain(dist, noise, sel, sigma, u, weights, anneal):
    return ncsn_score_loss_reference(dist, noise, sel, sigma, u, *weights,
                                     anneal)


def _lib(width):
    """The library of the instance of head width ``width``."""
    return "ncsn_score" if width == KERNEL_E else f"ncsn_score_e{width}"


@functools.cache
def _w2_floats(lib):
    """The floats of the split-W2 buffer the instance in ``lib`` takes (0
    for the 128 instance, which keeps W2 in shared memory)."""
    return _build.kernel_fn(lib, "ncsn_w2_floats", [], ctypes.c_size_t)()


def _w2_split(lib, dev):
    """The split-W2 buffer of the instance in ``lib``, or None."""
    floats = _w2_floats(lib)
    return torch.empty(floats, dtype=torch.float32, device=dev) \
        if floats else None


@kernel_op("ncsn_score_fwd", _ncsn_fwd_fake, _ncsn_fwd_plain)
def _launch_ncsn_fwd(dist: Tensor, noise: Tensor, sel: Tensor, sigma: Tensor,
                     u: Tensor, weights: Sequence[Tensor],
                     anneal: float) -> Tensor:
    width = kernel_width(u.shape[-1])
    rows = _ncsn_fwd_kernel(dist, noise, sel, sigma,
                            *pad_head(u, weights, width), anneal)
    _count("ncsn_score_fwd", width)
    return rows


def _ncsn_fwd_kernel(dist, noise, sel, sigma, u, weights, anneal):
    """One launch of the instance of u's width (KERNEL_WIDTHS)."""
    b, n, _ = dist.shape
    width = u.shape[-1]
    lib = _lib(width)
    check_smem("ncsn_score_fwd", _build.kernel_fn(
        lib, "ncsn_smem_bytes", [], ctypes.c_size_t)())
    ws_ints, rpart_floats = (_build.kernel_fn(
        lib, name, [ctypes.c_int] * 2, ctypes.c_size_t)(b, n)
        for name in ("ncsn_ws_ints", "ncsn_fwd_rpart_floats"))
    fn = _build.kernel_fn(
        lib, "ncsn_score_fwd",
        [ctypes.c_void_p] * 19 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p])
    dev = dist.device
    rows = torch.empty((b, n), dtype=torch.float32, device=dev)
    # the work list (tile flags, counts, prefix sums, the tile list) and the
    # row sums' partials of each (block, row tile) segment
    ws = torch.empty(ws_ints, dtype=torch.int32, device=dev)
    rpart = torch.empty(rpart_floats, dtype=torch.float32, device=dev)
    w2s = _w2_split(lib, dev)
    err = fn(*map(ptr, (dist, noise, sel, sigma, u, *weights, rows, rpart,
                        ws)), ptr_or_null(w2s), b, n, width, float(anneal),
             stream(dist))
    check_launch("ncsn_score_fwd", err)
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
    du, wgrad = launch(_launch_ncsn_bwd, dist, noise, sel,
                       sigma, u, g_rows, list(weights), float(anneal))
    sizes = [w.numel() for w in weights]
    return (du, *(g.view(w.shape) for g, w in
                  zip(torch.split(wgrad, sizes), weights)))


def _ncsn_bwd_fake(dist, noise, sel, sigma, u, g_rows, weights, anneal):
    return torch.empty_like(u), u.new_empty((sum(w.numel() for w in weights),))


def _ncsn_bwd_plain(dist, noise, sel, sigma, u, g_rows, weights, anneal):
    du, *grads = fresh_thread(
        lambda: ncsn_score_bwd_reference(dist, noise, sel, sigma, u, g_rows,
                                         *weights, anneal=anneal))
    return du, flat(grads)


@kernel_op("ncsn_score_bwd", _ncsn_bwd_fake, _ncsn_bwd_plain)
def _launch_ncsn_bwd(dist: Tensor, noise: Tensor, sel: Tensor, sigma: Tensor,
                     u: Tensor, g_rows: Tensor, weights: Sequence[Tensor],
                     anneal: float) -> tuple[Tensor, Tensor]:
    """(du, the flat weight gradient in ``WEIGHT_NAMES`` order), from the
    instance that holds emb (:func:`pad_head`), cut back to emb."""
    emb = u.shape[-1]
    width = kernel_width(emb)
    pu, pw = pad_head(u, weights, width)
    du, wgrad = _ncsn_bwd_kernel(dist, noise, sel, sigma, pu, g_rows, pw,
                                 anneal)
    _count("ncsn_score_bwd", width)
    if emb == width:
        return du, wgrad
    return du[..., :emb].contiguous(), unpad_wgrad(wgrad, emb, width)


def _ncsn_bwd_kernel(dist, noise, sel, sigma, u, g_rows, weights, anneal):
    """One launch of the instance of u's width: (du, the flat weight
    gradient)."""
    b, n, _ = dist.shape
    width = u.shape[-1]
    lib = _lib(width)
    check_smem("ncsn_score_bwd", _build.kernel_fn(
        lib, "ncsn_smem_bytes", [], ctypes.c_size_t)())
    blocks = _build.kernel_fn(lib, "ncsn_blocks",
                              [ctypes.c_int, ctypes.c_int])(b, n)
    size = _build.kernel_fn(lib, "ncsn_wgrad_size", [])()
    ws_ints, dpart_floats = (_build.kernel_fn(
        lib, name, [ctypes.c_int] * 2, ctypes.c_size_t)(b, n)
        for name in ("ncsn_ws_ints", "ncsn_bwd_dpart_floats"))
    fn = _build.kernel_fn(
        lib, "ncsn_score_bwd",
        [ctypes.c_void_p] * 22 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p])
    dev = dist.device
    du = torch.empty_like(u)
    # the work list (tile flags, counts, prefix sums, the tile list), the du
    # partials of the listed tiles and the per-block weight gradients
    ws = torch.empty(ws_ints, dtype=torch.int32, device=dev)
    dpart = torch.empty(dpart_floats, dtype=torch.float32, device=dev)
    part = torch.empty((blocks, size), dtype=torch.float32, device=dev)
    wgrad = torch.empty(size, dtype=torch.float32, device=dev)
    w2s = _w2_split(lib, dev)
    err = fn(*map(ptr, (dist, noise, sel, sigma, u, g_rows, *weights, du,
                        dpart, part, wgrad, ws)), ptr_or_null(w2s),
             b, n, width, float(anneal), stream(dist))
    check_launch("ncsn_score_bwd", err)
    return du, wgrad


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
