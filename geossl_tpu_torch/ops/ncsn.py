"""The DDM score-matching head per pair on the card: kernel wrappers and
their plain versions (counterpart of ``geossl_tpu/ops/ncsn_pallas.py``).

``ncsn_score_loss`` returns the per-row sums ``[B, N]`` of the annealed
loss of ``NCSN_version_03`` over the selected pairs. On CPU tensors it is
the plain PyTorch version (differentiable by autograd); on CUDA tensors it
runs ``csrc/ncsn_score.cu``: ``ncsn_score_fwd`` (replaces ``_fwd_kernel``)
forward and ``ncsn_score_bwd`` (replaces ``_bwd_kernel``) backward, first
order only. Gradients flow to the node projections ``u`` and the ten head
weights; dist, noise, sel and sigma are data and get none.

Widths. The source builds once per width in ``KERNEL_WIDTHS`` (128, 256),
and a head up to 256 runs in the narrowest instance that holds it,
zero-padded to that width inside the launch functions (exact: every padded
unit is relu(0) = 0 and meets zero weights; outputs are sliced back, so the
autograd Function, the ops' fake implementations and sealed programs keep
the user's width). The 256 instance's launches count as ``<kernel>_e256``
(:data:`E256_LAUNCHES`). A wider head runs the streamed instance
(``csrc/ncsn_score_wide.cu``), whose width is a runtime value: E padded to
a multiple of ``WIDE_CHUNK`` = 128 and streamed in chunks of it (H in
groups of half of it), so that its shared memory does not grow with E; its
launches count as ``<kernel>_wide`` (:data:`WIDE_LAUNCHES`) and its plain
version is :func:`ncsn_streamed_reference`. :func:`instance_width` picks
the width. Every instance runs the head's products on the tensor cores in
3xTF32 (``csrc/mma_tf32.cuh``; the forward l1 W2, the backward also dl1
and dW2), within f32 rounding of the plain version, over a tile list made
on the device, and sums everything in a fixed order (bitwise repeatable).

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

# Head widths of the fixed-width instances (csrc/ncsn_score.cu built with
# NCSN_E = each): a head up to the last runs in the narrowest that holds it
# (read at call time).
KERNEL_WIDTHS = (128, 256)
KERNEL_E = KERNEL_WIDTHS[0]
# The streamed instance's chunk of E (csrc/ncsn_score_wide.cu: kEC; H
# streams in groups of half of it): a wider head is padded to a multiple
# of it (read at call time).
WIDE_CHUNK = 128
# The 256 instance's and the streamed instance's launch counters, by the
# wrapper's name: "<name>_e256" and "<name>_wide" in
# ops/_launch.launch_counts()
E256_LAUNCHES = {name: instance_counter(f"{name}_e256")
                 for name in ("ncsn_score_fwd", "ncsn_score_bwd")}
WIDE_LAUNCHES = {name: instance_counter(f"{name}_wide")
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


@torch.no_grad()
def ncsn_streamed_reference(dist, noise, sel, sigma, u, weights, anneal,
                            g_rows=None):
    """The plain version of the streamed instance (``csrc/ncsn_score_wide.cu``)
    at a width E that is a multiple of ``WIDE_CHUNK``: demb over all of E;
    per H group of ``WIDE_CHUNK // 2`` columns, pre2 summed over E chunks of
    ``WIDE_CHUNK`` (l1 made chunk by chunk), then the score over the groups.
    Returns the row sums; with ``g_rows`` (their cotangent [B,N]) du and the
    ten weight gradients instead, the backward written out as the kernel
    streams it: per group dx2, its column sums, then per chunk dW2[ec, hg]
    and the masked dl1's terms of du, w_od, b_od and ddemb, then the
    distance MLP. The same function as :func:`ncsn_score_loss_reference`
    (its sums in another order)."""
    w_d1, b_d1, w_d2, b_d2, w_od, b_od, w2, b2, w3, b3 = weights
    emb = u.shape[-1]
    hid = emb // 2
    cs, gs = WIDE_CHUNK, WIDE_CHUNK // 2
    ecs = [slice(c, c + cs) for c in range(0, emb, cs)]
    hgs = [slice(h, h + gs) for h in range(0, hid, gs)]
    used = sigma[:, None, None]
    dp = dist + noise * used
    t1 = dp[..., None] * w_d1[0] + b_d1
    demb = torch.relu(t1) @ w_d2 + b_d2  # [B,N,N,1]

    def l1(ec):
        return torch.relu(u[:, :, None, ec] + u[:, None, :, ec]
                          + demb * w_od[0, ec] + b_od[ec])

    pre2 = []
    for hg in hgs:
        p = 0
        for ec in ecs:
            p = p + l1(ec) @ w2[ec, hg]
        pre2.append(p + b2[hg])
    score = b3[0]
    for hg, p in zip(hgs, pre2):
        score = score + (torch.relu(p) @ w3[hg])[..., 0]
    r = score / used + noise / used  # scores - target
    wsig = used ** anneal
    if g_rows is None:
        return (0.5 * r * r * wsig * sel).sum(dim=2)
    ds = r * wsig * sel * g_rows[:, :, None] / used
    du = torch.zeros_like(u)
    ddemb = torch.zeros_like(dist)
    gw_od, gb_od = torch.zeros_like(w_od), torch.zeros_like(b_od)
    gw2, gb2, gw3 = (torch.zeros_like(w) for w in (w2, b2, w3))
    for hg, p in zip(hgs, pre2):
        dx2 = (p > 0) * ds[..., None] * w3[hg, 0]
        gw3[hg, 0] = (torch.relu(p) * ds[..., None]).sum((0, 1, 2))
        gb2[hg] = dx2.sum((0, 1, 2))
        for ec in ecs:
            a = l1(ec)
            gw2[ec, hg] += a.reshape(-1, a.shape[-1]).t() @ dx2.reshape(
                -1, dx2.shape[-1])
            dl = (dx2 @ w2[ec, hg].t()) * (a > 0)
            du[..., ec] += dl.sum(2) + dl.sum(1)
            gw_od[0, ec] += (dl * demb).sum((0, 1, 2))
            gb_od[ec] += dl.sum((0, 1, 2))
            ddemb = ddemb + (dl * w_od[0, ec]).sum(-1)
    on = (t1 > 0).to(t1.dtype) * ddemb[..., None]
    gw_d2 = (torch.relu(t1) * ddemb[..., None]).sum((0, 1, 2))[:, None]
    gw_d1 = ((on * dp[..., None]).sum((0, 1, 2)) * w_d2[:, 0])[None]
    gb_d1 = on.sum((0, 1, 2)) * w_d2[:, 0]
    return (du, gw_d1, gb_d1, gw_d2, ddemb.sum().reshape(1), gw_od, gb_od,
            gw2, gb2, gw3, ds.sum().reshape(1))


# -- kernel wrappers ------------------------------------------------------------


def instance_width(emb: int) -> int:
    """The width of the kernel instance that runs a head of width ``emb``,
    which is zero-padded up to it: the narrowest of ``KERNEL_WIDTHS`` that
    holds it, above them the next multiple of ``WIDE_CHUNK`` (the streamed
    instance)."""
    for width in KERNEL_WIDTHS:
        if emb <= width:
            return width
    return -(-emb // WIDE_CHUNK) * WIDE_CHUNK


def streamed(width: int) -> bool:
    """Whether an instance of ``width`` is the streamed one."""
    return width > KERNEL_WIDTHS[-1]


def _count(name, width):
    """One launch of kernel ``name`` in the instance of head width
    ``width``: the wrapper's count, the 256 instance's or the streamed
    instance's."""
    if streamed(width):
        WIDE_LAUNCHES[name].launches += 1
    else:
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
    if u.shape != (b, n, emb) or n2 != n:
        raise ValueError(f"{name}: kernel takes u [B,N,emb] and square grids; "
                         f"got dist {tuple(dist.shape)}, u {tuple(u.shape)}")
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
    width = instance_width(u.shape[-1])
    run = _ncsn_wide_fwd_kernel if streamed(width) else _ncsn_fwd_kernel
    rows = run(dist, noise, sel, sigma, *pad_head(u, weights, width), anneal)
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
    width = instance_width(emb)
    pu, pw = pad_head(u, weights, width)
    run = _ncsn_wide_bwd_kernel if streamed(width) else _ncsn_bwd_kernel
    du, wgrad = run(dist, noise, sel, sigma, pu, g_rows, pw, anneal)
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


def _ncsn_wide_fwd_plain(dist, noise, sel, sigma, u, weights, anneal):
    """The plain version of :func:`_ncsn_wide_fwd_kernel`: the row sums of
    :func:`ncsn_streamed_reference`."""
    return ncsn_streamed_reference(dist, noise, sel, sigma, u, weights,
                                   anneal)


def _ncsn_wide_bwd_plain(dist, noise, sel, sigma, u, g_rows, weights,
                         anneal):
    """The plain version of :func:`_ncsn_wide_bwd_kernel`: du and the flat
    weight gradient of :func:`ncsn_streamed_reference`."""
    du, *grads = ncsn_streamed_reference(dist, noise, sel, sigma, u, weights,
                                         anneal, g_rows)
    return du, flat(grads)


def _wide(name, *ints, restype=ctypes.c_size_t):
    """The streamed instance's C query ``name`` of ``ints``."""
    return _build.kernel_fn("ncsn_score_wide", name,
                            [ctypes.c_int] * len(ints), restype)(*ints)


def _wide_entry(name, n_ptrs):
    """The streamed instance's C entry ``name``: pointers, B, N, E, anneal,
    the stream."""
    return _build.kernel_fn(
        "ncsn_score_wide", name,
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p])


def _ncsn_wide_fwd_kernel(dist, noise, sel, sigma, u, weights, anneal):
    """One launch of the streamed instance (csrc/ncsn_score_wide.cu) at u's
    width, a multiple of WIDE_CHUNK: the row sums."""
    b, n, _ = dist.shape
    width = u.shape[-1]
    check_smem("ncsn_score_fwd", _wide("ncsn_wide_smem_bytes"))
    dev = dist.device
    rows = torch.empty((b, n), dtype=torch.float32, device=dev)
    # the work list, the rows' segment partials, W2's split pieces
    ws = torch.empty(_wide("ncsn_wide_ws_ints", b, n), dtype=torch.int32,
                     device=dev)
    rpart, w2s = (torch.empty(size, dtype=torch.float32, device=dev)
                  for size in (_wide("ncsn_wide_rpart_floats", b, n),
                               _wide("ncsn_wide_w2_floats", width)))
    err = _wide_entry("ncsn_wide_fwd", 19)(
        *map(ptr, (dist, noise, sel, sigma, u, *weights, rows, rpart, ws,
                   w2s)), b, n, width, float(anneal), stream(dist))
    check_launch("ncsn_score_fwd", err)
    return rows


def _ncsn_wide_bwd_kernel(dist, noise, sel, sigma, u, g_rows, weights,
                          anneal):
    """One launch of the streamed instance's backward at u's width: (du,
    the flat weight gradient)."""
    b, n, _ = dist.shape
    width = u.shape[-1]
    check_smem("ncsn_score_bwd", _wide("ncsn_wide_smem_bytes"))
    blocks = _wide("ncsn_wide_blocks", b, n, restype=ctypes.c_int)
    size = _wide("ncsn_wide_wgrad_size", width, restype=ctypes.c_int)
    dev = dist.device
    du = torch.empty_like(u)
    # the work list; the du partials, the per-block weight gradients and
    # their sum, each thread's kept pre2, W2's split pieces
    ws = torch.empty(_wide("ncsn_wide_ws_ints", b, n), dtype=torch.int32,
                     device=dev)
    dpart, part, wgrad, keep, w2s = (
        torch.empty(shape, dtype=torch.float32, device=dev) for shape in (
            _wide("ncsn_wide_dpart_floats", b, n, width), (blocks, size),
            size, _wide("ncsn_wide_keep_floats", b, n, width),
            _wide("ncsn_wide_w2_floats", width)))
    err = _wide_entry("ncsn_wide_bwd", 23)(
        *map(ptr, (dist, noise, sel, sigma, u, g_rows, *weights, du, dpart,
                   part, wgrad, keep, ws, w2s)),
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
