"""SchNet's CFConv on the card: kernel wrappers, their plain versions and
the dispatcher (counterpart of ``geossl_tpu/ops/cfconv_pallas.py``).

Each wrapper takes the plain PyTorch version for tensors on the CPU and
launches its hand-written CUDA kernel (``csrc/``) for tensors on a CUDA
device; anything else raises. There is no fallback from a kernel to the
plain version. Each wrapper counts its kernel's launches in
``<wrapper>.launches`` (``ops/_launch.py``), one as each launch returns
(a call above ``KERNEL_F`` makes several: Widths, below).

Kernels:

* ``cfconv_fused``     -> ``csrc/cfconv_fwd.cu`` (replaces ``_fwd_kernel``);
  differentiable: its backward is ``cfconv_bwd``
* ``cfconv_bwd``       -> ``csrc/cfconv_bwd.cu`` (replaces ``_bwd_kernel``)
* ``cfconv_fused_sym`` -> ``csrc/cfconv_fwd.cu`` in symmetric mode
  (replaces ``_fwd_sym_kernel``); differentiable: its backward is
  ``cfconv_bwd_sym``
* ``cfconv_bwd_sym``   -> ``csrc/cfconv_bwd.cu`` in symmetric mode
  (replaces ``_bwd_sym_kernel``); ddist/denv come back placed
  (:func:`place_sym_cotangent`)
* ``schnet_stack``     -> ``csrc/schnet_stack.cu`` (replaces
  ``_stack_kernel`` / ``schnet_stack_infer``); inference only: it raises
  under autograd on a CUDA device instead of returning a tensor cut off
  from the graph; with ``symmetric`` one filter per unordered pair

The two CFConv Functions take a double backward (MD17's force training):
their backward is itself a Function (``_CFConvBwd``) whose forward launches
the backward kernel and whose backward is :func:`cfconv_bwd_bwd` /
:func:`cfconv_bwd_sym_bwd`, autograd over the plain backward, as the JAX
package's XLA ``_cfconv_bwd_bwd`` / ``_cfconv_sym_bwd_bwd``.

Every kernel runs its tile products (the stack also its dense layers) on
the tensor cores in 3xTF32 (``csrc/mma_tf32.cuh``), within f32 rounding of
the plain version. With ``mxu='bf16'`` (``--filter_mxu bf16``, and implied
by ``--compute_dtype bfloat16``) the four CFConv kernels run their bf16
instances instead: every filter product on bf16 operands with f32
accumulation (``csrc/mma_bf16.cuh``), the products that the JAX package's
``cfconv_pallas._dot`` rounds and no others; their plain versions round the
same operands (:func:`_dot`), and the plain bf16 backward is the JAX
kernel's backward body written out product by product
(:func:`cfconv_bwd_bf16_reference`). The stack has no bf16 instance (the
JAX package routes bf16 away from it). A bf16 launch counts under the
instance's own name, ``<kernel>_bf16`` (:data:`BF16_LAUNCHES`), and not
under the wrapper's. The plain-mode forward writes each output row once (no
atomics): two launches give bitwise the same output.
``plain_precision()`` makes the plain versions' PyTorch matmuls full f32.
SchNet's dispatcher takes the symmetric pair whenever dist/env are
symmetric, at every N (the card's measurement); PaiNN's takes its
symmetric pair from N=256 (``ops/painn.sym_profitable``).

Widths. The kernels' register tiling is written for F = ``KERNEL_F`` =
128 filters. A narrower filter is zero-padded to 128 inside the launch
functions (exact: a padded hidden unit's ssp(0) meets zero rows of W2, and a
padded output column is zero); a wider one runs as column blocks
(:func:`filter_blocks_fwd`, :func:`filter_blocks_bwd`): the output is
linear in the filter and the filter is a sum over W2's row blocks, so k =
ceil(F / 128) blocks of 128 make k^2 launches of the 128-wide kernels, one
per (hidden block i, output block o), summed exactly (within f32 rounding
of one full-width sum), k^2 counted launches per call. The bf16 backward
above 128 does not split so: a (i, o) launch would round its own partial dh
to bf16 where the JAX kernel rounds their sum. It runs its own instance
(``csrc/cfconv_bwd_bf16w.cu``, :func:`_cfconv_bwd_bf16w_kernel`): one
launch per hidden block i that walks every output block o inside the
launch and rounds dh_i once, k launches a call, counted as
``<kernel>_bf16w`` (:data:`BF16W_LAUNCHES`); its plain version is
:func:`cfconv_bwd_bf16_blocks_reference`. The stack
pads up to 128 and refuses wider F (serving routes such a model through the
per-block kernels). The padding and the blocks stay inside the launch
functions, so the autograd Functions, the ops' fake implementations and
sealed programs keep the user's width.

Each launch is also a custom op (``ops/_launch.kernel_op``):
``geossl_torch::cfconv_fwd`` (both forward modes), ``cfconv_bwd`` (both
backward modes; the weight gradients as one flat tensor), each with its
``mxu``, and ``schnet_stack``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
from torch import Tensor

from geossl_tpu_torch.models.common import (
    gaussian_smearing,
    rbf_offsets,
    shifted_softplus,
)
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
    refuse_grad,
    stream,
)

# Largest N the whole-stack kernel accepts (as cfconv_pallas.STACK_MAX_N).
STACK_MAX_N = 128
# Filter width the kernels' register tiling is written for: F below it is
# zero-padded to it, F above it runs in column blocks of it (read at call
# time). The Gaussian count G is free: up to SMALL_G each kernel keeps W1
# and the RBF tile in shared memory, above it streams W1 in chunks of 32
# rows (csrc/filter_mma.cuh, csrc/cfconv_bwd.cu), in the same shared memory.
KERNEL_F = 128
SMALL_G = 64
# Side of the kernels' square pair tiles.
KERNEL_TILE = 8
# Precisions of the filter products (JAX ``cfconv_pallas._dot``'s ``mxu``).
MXU_MODES = ("f32", "bf16")
# The bf16 instances' launch counters, by the wrapper's name: each counts
# as "<name>_bf16" in ops/_launch.launch_counts()
BF16_LAUNCHES = {name: instance_counter(f"{name}_bf16") for name in (
    "cfconv_fwd", "cfconv_bwd", "cfconv_fwd_sym", "cfconv_bwd_sym")}
# The bf16 backwards' hidden-block instances above KERNEL_F (one launch per
# hidden block): each counts as "<name>_bf16w"
BF16W_LAUNCHES = {name: instance_counter(f"{name}_bf16w")
                  for name in ("cfconv_bwd", "cfconv_bwd_sym")}


def _count(name, mxu):
    """One launch of kernel ``name`` in the ``mxu`` instance: the wrapper's
    count, or its bf16 instance's."""
    (BF16_LAUNCHES[name] if mxu == "bf16" else counter(name)).launches += 1


def plain_precision() -> None:
    """Full-f32 matmuls for the plain versions on the card (no single-pass
    TF32), the precision the kernels keep."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sparse_auto(n: int, sparse) -> bool:
    """Resolve a ``sparse`` knob ('auto' or a bool): 'auto' gates tiles from
    N=128 up, as ``pallas_utils.sparse_auto`` does."""
    if sparse == "auto":
        return n >= 128
    if isinstance(sparse, bool):
        return sparse
    raise ValueError(f"sparse must be 'auto' or a bool; got {sparse!r}")


def filter_blocks(f: int) -> int:
    """Column blocks of ``KERNEL_F`` a filter of width ``f`` runs in."""
    return -(-f // KERNEL_F)


def launches_per_call(f: int) -> int:
    """Kernel launches one CFConv call at filter width ``f`` makes: one up
    to ``KERNEL_F`` (padded), k^2 for k column blocks above it (the bf16
    backward's hidden-block instance makes k)."""
    return filter_blocks(f) ** 2


def _pad_filter(x, w1, b1, w2, b2, width):
    """x [..., F], W1 [G,F], b1, W2 [F,F], b2 zero-padded to F = width."""
    d = width - x.shape[-1]
    pad = torch.nn.functional.pad
    return (pad(x, (0, d)), pad(w1, (0, d)), pad(b1, (0, d)),
            pad(w2, (0, d, 0, d)), pad(b2, (0, d)))


def _blocks(f):
    """(k, the padded width, the k column slices of KERNEL_F)."""
    k = filter_blocks(f)
    return k, k * KERNEL_F, [slice(o * KERNEL_F, (o + 1) * KERNEL_F)
                             for o in range(k)]


def _block_args(x, w1, b1, w2, b2, i, o, sl):
    """The inputs of block pair (hidden block i, output block o): x[:, o],
    W1[:, i], b1[i], W2[i, o], and b2[o] in the i = 0 call only (zero in the
    others, so that the k calls of column block o add it once)."""
    bias = b2[sl[o]] if i == 0 else torch.zeros_like(b2[sl[o]])
    return (x[..., sl[o]].contiguous(), w1[:, sl[i]].contiguous(),
            b1[sl[i]].contiguous(), w2[sl[i], sl[o]].contiguous(),
            bias.contiguous())


def filter_blocks_fwd(call, x, w1, b1, w2, b2):
    """The CFConv forward at any filter width through ``call(x, w1, b1, w2,
    b2)``, a ``KERNEL_F``-wide forward: F = KERNEL_F passes straight
    through (no copy); F below is zero-padded to it; above, for k column
    blocks, m[:, o] = sum over i (in order) of the call of block pair (i,
    o) (:func:`_block_args`), k^2 calls. Returns m at width F."""
    f = x.shape[-1]
    if f == KERNEL_F:
        return call(x, w1, b1, w2, b2)
    k, width, sl = _blocks(f)
    x, w1, b1, w2, b2 = _pad_filter(x, w1, b1, w2, b2, width)
    if k == 1:
        return call(x, w1, b1, w2, b2)[..., :f].contiguous()
    cols = []
    for o in range(k):
        m = None
        for i in range(k):
            part = call(*_block_args(x, w1, b1, w2, b2, i, o, sl))
            m = part if m is None else m + part
        cols.append(m)
    return torch.cat(cols, dim=-1)[..., :f].contiguous()


def filter_blocks_bwd(call, x, g, w1, b1, w2, b2):
    """The CFConv backward at any filter width through ``call(x, g, w1, b1,
    w2, b2)``, a ``KERNEL_F``-wide backward returning (ddist, denv, dx,
    dW1, db1, dW2, db2); padded or in column blocks as
    :func:`filter_blocks_fwd` (g sliced with x). Over the k^2 calls: dx[:,
    o] = sum over i, dW1[:, i] and db1[i] = sum over o, dW2[i, o] as it
    comes, ddist and denv = sum over all, db2[o] from the i = 0 call only
    (every call of column block o returns the same db2, whatever its b2)."""
    f = x.shape[-1]
    if f == KERNEL_F:
        return call(x, g, w1, b1, w2, b2)
    k, width, sl = _blocks(f)
    x, w1, b1, w2, b2 = _pad_filter(x, w1, b1, w2, b2, width)
    g = torch.nn.functional.pad(g, (0, width - f))
    if k == 1:
        ddist, denv, dx, dw1, db1, dw2, db2 = call(x, g, w1, b1, w2, b2)
        return (ddist, denv, dx[..., :f].contiguous(), dw1[:, :f],
                db1[:f], dw2[:f, :f], db2[:f])
    ddist = denv = None
    dx, db2 = [None] * k, [None] * k
    dw1, db1 = [None] * k, [None] * k
    dw2 = [[None] * k for _ in range(k)]

    def add(a, b):
        return b if a is None else a + b

    for o in range(k):
        for i in range(k):
            xo, w1i, b1i, w2io, b2o = _block_args(x, w1, b1, w2, b2, i, o, sl)
            dd, de, dxo, dw1i, db1i, dw2io, db2o = call(
                xo, g[..., sl[o]].contiguous(), w1i, b1i, w2io, b2o)
            ddist, denv = add(ddist, dd), add(denv, de)
            dx[o] = add(dx[o], dxo)
            dw1[i], db1[i] = add(dw1[i], dw1i), add(db1[i], db1i)
            dw2[i][o] = dw2io
            if i == 0:
                db2[o] = db2o
    return (ddist, denv, torch.cat(dx, -1)[..., :f].contiguous(),
            torch.cat(dw1, -1)[:, :f], torch.cat(db1)[:f],
            torch.cat([torch.cat(row, -1) for row in dw2])[:f, :f],
            torch.cat(db2)[:f])


# -- plain versions -----------------------------------------------------------


def check_mxu(mxu: str) -> None:
    if mxu not in MXU_MODES:
        raise ValueError(f"mxu must be one of {MXU_MODES}, got {mxu!r}")


def _dot(a, b, mxu):
    """``a @ b`` as the kernels take a filter product (JAX
    ``cfconv_pallas._dot``): with ``mxu='bf16'`` both operands rounded to
    bf16 (to nearest even), then multiplied and summed in their own dtype,
    where the products of two bf16 values are exact. Autograd through the
    casts rounds the cotangents to bf16, as JAX's through ``astype`` (the
    second orders); the first-order plain backward is
    :func:`cfconv_bwd_bf16_reference`."""
    if mxu == "bf16":
        bf = torch.bfloat16
        return a.to(bf).to(a.dtype) @ b.to(bf).to(b.dtype)
    return a @ b


def cfconv_fused_reference(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                           mxu="f32"):
    """Plain CFConv: materializes the [B,N,N,F] filter tensor. ``mxu``: the
    filter products' precision (:func:`_dot`)."""
    check_mxu(mxu)
    rbf = gaussian_smearing(dist, start, stop, num_g)
    w = _dot(shifted_softplus(_dot(rbf, w1, mxu) + b1), w2, mxu) + b2
    return torch.einsum("bijf,bij,bjf->bif", w, env, x)


@torch.no_grad()
def cfconv_bwd_bf16_reference(dist, env, x, g, w1, b1, w2, b2, start, stop,
                              num_g):
    """The plain backward with ``mxu='bf16'``: the JAX kernel's backward body
    (``cfconv_pallas._bwd_kernel``), product by product, each product's two
    operands rounded to bf16 (:func:`_dot`) and everything else in the
    working dtype: (ddist, denv, dx, dW1, db1, dW2, db2). Not autograd
    through the casts, which would round the cotangent and each product's
    output to bf16 as well, where the kernels do not. Its outputs carry no
    graph, as the f32 plain backward's (its second order is
    :func:`cfconv_bwd_bwd`)."""
    f = x.shape[-1]
    offset, coeff = rbf_offsets(start, stop, num_g, dist.dtype, dist.device)
    diff = dist[..., None] - offset
    rbf = torch.exp(coeff * diff * diff)  # [B,N,N,G]
    pre1 = _dot(rbf, w1, "bf16") + b1
    s = shifted_softplus(pre1)
    w = _dot(s, w2, "bf16") + b2  # [B,N,N,F]
    env4 = env[..., None]
    g4 = g[:, :, None, :]
    q = g4 * x[:, None, :, :]  # q[b,i,j,f] = g[b,i,f] x[b,j,f]
    denv = torch.sum(w * q, dim=-1)
    dx = torch.sum(w * env4 * g4, dim=1)
    qe = (q * env4).reshape(-1, f)
    dw2 = _dot(s.reshape(-1, f).t(), qe, "bf16")
    db2 = torch.sum(qe, dim=0)
    dh = _dot(qe, w2.t(), "bf16") * torch.sigmoid(pre1).reshape(-1, f)
    dw1 = _dot(rbf.reshape(-1, num_g).t(), dh, "bf16")
    db1 = torch.sum(dh, dim=0)
    drbf = _dot(dh, w1.t(), "bf16").reshape(rbf.shape)
    ddist = torch.sum(drbf * rbf * (2.0 * coeff) * diff, dim=-1)
    return ddist, denv, dx, dw1, db1, dw2, db2


@torch.no_grad()
def cfconv_bwd_bf16_blocks_reference(dist, env, x, g, w1, b1, w2, b2, start,
                                     stop, num_g):
    """The plain version of the bf16 backward's hidden-block instance
    (``csrc/cfconv_bwd_bf16w.cu``): :func:`cfconv_bwd_bf16_reference`'s
    body over k = ceil(F / KERNEL_F) hidden blocks i (W1's and b1's
    columns, W2's rows of block i), each walking the output blocks o:
    w_o = s_i W2[i, o] (+ b2[o] for i = 0), dW2[i, o] = s_i^T qe_o, and dh_i
    summed over o in the working dtype before it is rounded once, as the
    operand of dW1[:, i] and drbf_i; ddist, denv and dx summed over the
    blocks in order. F is zero-padded to k KERNEL_F and cut back. The same
    rounded operands as the full-width body: they differ only in the order
    of their sums."""
    f = x.shape[-1]
    k, width, sl = _blocks(f)
    x, w1, b1, w2, b2 = _pad_filter(x, w1, b1, w2, b2, width)
    g = torch.nn.functional.pad(g, (0, width - f))
    offset, coeff = rbf_offsets(start, stop, num_g, dist.dtype, dist.device)
    diff = dist[..., None] - offset
    rbf = torch.exp(coeff * diff * diff)  # [B,N,N,G]
    env4 = env[..., None]
    q = g[:, :, None, :] * x[:, None, :, :]
    qe = q * env4
    ddist = denv = dx = 0
    dw1, db1, dw2 = [], [], []
    for i in range(k):
        pre1 = _dot(rbf, w1[:, sl[i]], "bf16") + b1[sl[i]]
        s = shifted_softplus(pre1)
        dh, dxs, dw2_i = 0, [], []
        for o in range(k):
            w = _dot(s, w2[sl[i], sl[o]], "bf16")
            if i == 0:
                w = w + b2[sl[o]]
            denv = denv + torch.sum(w * q[..., sl[o]], dim=-1)
            dxs.append(torch.sum(w * env4 * g[:, :, None, sl[o]], dim=1))
            qe_o = qe[..., sl[o]].reshape(-1, KERNEL_F)
            dw2_i.append(_dot(s.reshape(-1, KERNEL_F).t(), qe_o, "bf16"))
            dh = dh + _dot(qe_o, w2[sl[i], sl[o]].t(), "bf16")
        dx = dx + torch.cat(dxs, -1)
        dh = dh * torch.sigmoid(pre1).reshape(-1, KERNEL_F)
        dw1.append(_dot(rbf.reshape(-1, num_g).t(), dh, "bf16"))
        db1.append(torch.sum(dh, dim=0))
        dw2.append(torch.cat(dw2_i, -1))
        drbf = _dot(dh, w1[:, sl[i]].t(), "bf16").reshape(rbf.shape)
        ddist = ddist + torch.sum(drbf * rbf * (2.0 * coeff) * diff, dim=-1)
    db2 = torch.sum(qe.reshape(-1, width), dim=0)
    return (ddist, denv, dx[..., :f].contiguous(), torch.cat(dw1, -1)[:, :f],
            torch.cat(db1)[:f], torch.cat(dw2)[:f, :f], db2[:f])


def cfconv_bwd_reference(dist, env, x, g, w1, b1, w2, b2, start, stop, num_g,
                         mxu="f32"):
    """Plain backward of :func:`cfconv_fused_reference` for the cotangent
    ``g`` [B,N,F]: (ddist, denv, dx, dW1, db1, dW2, db2), by autograd; with
    ``mxu='bf16'`` :func:`cfconv_bwd_bf16_reference`."""
    check_mxu(mxu)
    if mxu == "bf16":
        return cfconv_bwd_bf16_reference(dist, env, x, g, w1, b1, w2, b2,
                                         start, stop, num_g)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (dist, env, x, w1, b1, w2, b2)]
        out = cfconv_fused_reference(*ins, start, stop, num_g)
        return torch.autograd.grad(out, ins, g)


def cfconv_bwd_sym_reference(dist, env, x, g, w1, b1, w2, b2, start, stop,
                             num_g, mxu="f32"):
    """Plain version of :func:`cfconv_bwd_sym`: the true, unplaced
    cotangents (those of :func:`cfconv_bwd_reference`).
    :func:`place_sym_cotangent` maps its ddist/denv to the kernel's
    placement. (In bf16 the kernel rounds each computed cell's qe with its
    mirror's added, as the JAX symmetric kernel does, where this rounds
    each cell's own: they differ at bf16 rounding of the weight
    gradients.)"""
    return cfconv_bwd_reference(dist, env, x, g, w1, b1, w2, b2, start, stop,
                                num_g, mxu)


def place_sym_cotangent(c, antisymmetric=False):
    """The symmetric backward kernels' placement of a pair cotangent
    ``c [..., N, N]``, with 8x8 tiles (pi, pj) of cells (i, j): a tile with
    pj > pi holds ``c + c^T`` (with ``antisymmetric``, ``c - c^T``), a
    diagonal tile ``c``, a tile with pj < pi zero. (With occupancy gating
    the kernels also write zero on tiles whose env or gate is all zero.)
    Exact for training when the pair field is a symmetric (antisymmetric:
    PaiNN's directions) function of the positions: every gradient upstream
    of it is the same as with ``c``. Used by ``cfconv_bwd_sym`` and
    ``ops/painn.painn_bwd_sym``."""
    n = c.shape[-1]
    t = torch.arange(n, device=c.device) // KERNEL_TILE
    upper = t[None, :] > t[:, None]
    diag = t[None, :] == t[:, None]
    ct = c.transpose(-1, -2)
    return torch.where(upper, c - ct if antisymmetric else c + ct,
                       torch.where(diag, c, torch.zeros_like(c)))


def second_order(reference, primals, n_first, cts, pair_places=()):
    """The VJP of a plain first-order backward, the second order of the
    kernels' Functions (``jax.vjp`` of ``ref_grads`` in the JAX package's
    ``*_bwd_bwd``). ``reference(*primals[:n_first])`` is the plain forward
    and ``primals[n_first:]`` its output cotangents; the first-order
    backward is autograd over it, its outputs the cotangents of
    ``primals[:n_first]``; ``pair_places`` maps some of those outputs'
    indices to ``place_sym_cotangent``'s ``antisymmetric`` flag (a
    symmetric kernel's placed pair cotangents), so that the placement's
    transpose reaches ``cts``. Returns the cotangents of ``primals``, zeros
    where nothing flows; differentiable in turn when grad mode is on."""
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        ins = [t if outer and t.requires_grad
               else t.detach().requires_grad_(True) for t in primals]
        out = reference(*ins[:n_first])
        first = list(torch.autograd.grad(out, ins[:n_first], ins[n_first:],
                                         create_graph=True))
        for k, anti in dict(pair_places).items():
            first[k] = place_sym_cotangent(first[k], anti)
        grads = torch.autograd.grad(first, ins, cts, allow_unused=True,
                                    create_graph=outer)
    return tuple(torch.zeros_like(t) if d is None else d
                 for t, d in zip(primals, grads))


def schnet_stack_reference(dist, env, h0, stacked, start, stop, num_g):
    """Plain whole-stack chain, the math of ``_stack_kernel`` (RBF hoisted,
    lin1 without bias, residual ``h + lin(ssp(lin2(m)))``)."""
    wl1, w1, b1, w2, b2, wa, ba, wb, bb = stacked
    rbf = gaussian_smearing(dist, start, stop, num_g)
    h = h0
    for k in range(wl1.shape[0]):
        x = h @ wl1[k]
        w = shifted_softplus(rbf @ w1[k] + b1[k]) @ w2[k] + b2[k]
        m = torch.einsum("bijf,bij,bjf->bif", w, env, x)
        h = h + shifted_softplus(m @ wa[k] + ba[k]) @ wb[k] + bb[k]
    return h


# -- kernel wrappers ------------------------------------------------------------


def _rbf_consts(start, stop, num_g):
    delta = (stop - start) / (num_g - 1)
    return float(start), float(delta), float(-0.5 / delta**2)


def _rbf_table(start, stop, num_g, device):
    """Above ``SMALL_G`` Gaussians, the RBF basis the plain version uses
    (``rbf_offsets``: linspace's f32 offsets, then -0.5/Δ²) as one [G + 1]
    tensor on ``device``, made by the same ops on every call, for the
    kernels to read: a Gaussian's value moves by ~2|coeff||d - μ| times an
    offset's error, which grows with G, and start + Δk in f32 lies an ulp or
    two from linspace. None up to ``SMALL_G`` (the kernels take start + Δk
    there)."""
    if num_g <= SMALL_G:
        return None
    offset, coeff = rbf_offsets(start, stop, num_g, torch.float32, device)
    return torch.cat([offset, coeff.reshape(1)])


def _check_filter_shapes(name, dist, env, x, w1, b1, w2, b2, num_g):
    """Any F >= 1 (padded, or in column blocks of KERNEL_F)."""
    b, _, nj = dist.shape
    f = x.shape[-1]
    if f < 1 or w1.shape != (num_g, f) or w2.shape != (f, f) \
            or b1.shape != (f,) or b2.shape != (f,):
        raise ValueError(
            f"{name}: kernel takes W1 [G,F], W2 [F,F], b1, b2 [F]; got "
            f"x {tuple(x.shape)}, W1 {tuple(w1.shape)}, W2 {tuple(w2.shape)}")
    if env.shape != dist.shape or x.shape != (b, nj, f):
        raise ValueError(f"{name}: shapes dist {tuple(dist.shape)}, env "
                         f"{tuple(env.shape)}, x {tuple(x.shape)} disagree")


def _cfconv_fwd_fake(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                     symmetric, sparse, mxu="f32"):
    return x.new_empty((dist.shape[0], dist.shape[1], x.shape[-1]))


def _cfconv_fwd_plain(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                      symmetric, sparse, mxu="f32"):
    return cfconv_fused_reference(dist, env, x, w1, b1, w2, b2, start, stop,
                                  num_g, mxu)


@kernel_op("cfconv_fwd", _cfconv_fwd_fake, _cfconv_fwd_plain)
def _launch_cfconv(dist: Tensor, env: Tensor, x: Tensor, w1: Tensor,
                   b1: Tensor, w2: Tensor, b2: Tensor, start: float,
                   stop: float, num_g: int, symmetric: bool,
                   sparse: bool, mxu: str = "f32") -> Tensor:
    """The forward at any F: :func:`filter_blocks_fwd` over
    :func:`_cfconv_fwd_kernel`, each launch counted as it returns."""
    ni, nj = dist.shape[1:]
    _check_filter_shapes("cfconv_fwd", dist, env, x, w1, b1, w2, b2, num_g)
    check_mxu(mxu)
    if symmetric and ni != nj:
        raise ValueError("cfconv_fwd: the symmetric mode needs a square grid; "
                         f"got dist {tuple(dist.shape)}")
    name = "cfconv_fwd_sym" if symmetric else "cfconv_fwd"

    def call(*xw):
        out = _cfconv_fwd_kernel(dist, env, *xw, start, stop, num_g,
                                 symmetric, sparse, mxu)
        _count(name, mxu)
        return out

    return filter_blocks_fwd(call, x, w1, b1, w2, b2)


def _cfconv_fwd_kernel(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                       symmetric, sparse, mxu):
    """One launch of csrc/cfconv_fwd.cu at F = KERNEL_F."""
    b, ni, nj = dist.shape
    f = x.shape[-1]
    smem = _build.kernel_fn("cfconv_fwd", "cfconv_fwd_smem_bytes",
                            [ctypes.c_int], ctypes.c_size_t)(int(symmetric))
    check_smem("cfconv_fwd", smem)
    fn = _build.kernel_fn(
        "cfconv_fwd", "cfconv_fwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    # both modes make their work list on the device (tile flags, counts,
    # prefix sums, the tile list); the symmetric mode adds every row with
    # atomics, the plain mode writes each row once
    alloc = torch.zeros if symmetric else torch.empty
    out = alloc((b, ni, f), dtype=torch.float32, device=dist.device)
    ws_ints = _build.kernel_fn("cfconv_fwd", "cfconv_fwd_ws_ints",
                               [ctypes.c_int] * 4,
                               ctypes.c_size_t)(b, ni, nj, int(symmetric))
    ws = torch.empty(ws_ints, dtype=torch.int32, device=dist.device)
    s0, delta, coeff = _rbf_consts(start, stop, num_g)
    tab = _rbf_table(start, stop, num_g, dist.device)
    err = fn(*map(ptr, (dist, env, x, w1)), ptr_or_null(tab),
             *map(ptr, (b1, w2, b2, out, ws)), b, ni, nj, f, num_g, s0, delta,
             coeff, int(symmetric), int(sparse), int(mxu == "bf16"),
             stream(dist))
    check_launch("cfconv_fwd", err)
    return out


class _CFConv(torch.autograd.Function):
    """``cfconv_fwd`` forward, ``cfconv_bwd`` backward, or with ``symmetric``
    both in symmetric mode (``cfconv_bwd_sym``: ddist/denv placed, exact
    upstream of symmetric dist/env); with ``plain`` the plain versions of
    both (the true cotangents), on any device. The backward runs through
    ``_CFConvBwd``, so a double backward reaches the second order."""

    @staticmethod
    def forward(ctx, dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                symmetric, sparse, mxu, plain):
        ctx.save_for_backward(dist, env, x, w1, b1, w2, b2)
        ctx.consts = (start, stop, num_g, sparse, symmetric, mxu, plain)
        if plain:
            return cfconv_fused_reference(dist, env, x, w1, b1, w2, b2, start,
                                          stop, num_g, mxu)
        return launch(_launch_cfconv, dist, env, x, w1, b1, w2,
                      b2, float(start), float(stop), num_g, symmetric,
                      bool(sparse), mxu)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = _CFConvBwd.apply(*saved[:3], g.contiguous(), *saved[3:],
                                 *ctx.consts)
        return (*grads, None, None, None, None, None, None, None)


class _CFConvBwd(torch.autograd.Function):
    """The first-order backward as a differentiable function of (dist, env,
    x, g, W1, b1, W2, b2): its forward is the ``cfconv_bwd`` kernel (with
    ``symmetric``, ``cfconv_bwd_sym``; with ``plain``, the plain backward),
    its backward :func:`cfconv_bwd_bwd` (:func:`cfconv_bwd_sym_bwd` after
    the symmetric kernel). Without ``plain`` it runs only where the forward
    ran the kernel, so its tensors are on the card."""

    @staticmethod
    def forward(ctx, dist, env, x, g, w1, b1, w2, b2, start, stop, num_g,
                sparse, symmetric, mxu, plain):
        ctx.save_for_backward(dist, env, x, g, w1, b1, w2, b2)
        ctx.consts = (start, stop, num_g, mxu)
        ctx.placed = symmetric and not plain
        if plain:
            return cfconv_bwd_reference(dist, env, x, g, w1, b1, w2, b2,
                                        start, stop, num_g, mxu)
        bwd = cfconv_bwd_sym if symmetric else cfconv_bwd
        return bwd(dist, env, x, g, w1, b1, w2, b2, start, stop, num_g,
                   sparse, mxu)

    @staticmethod
    def backward(ctx, *cts):
        second = cfconv_bwd_sym_bwd if ctx.placed else cfconv_bwd_bwd
        grads = second(*ctx.saved_tensors, cts, *ctx.consts)
        return (*grads, None, None, None, None, None, None, None)


def cfconv_bwd_bwd(dist, env, x, g, w1, b1, w2, b2, cts, start, stop, num_g,
                   mxu="f32", _places=()):
    """Second order of :func:`cfconv_bwd`: for the cotangents ``cts`` of its
    seven outputs, the cotangents of (dist, env, x, g, W1, b1, W2, b2), by
    autograd over :func:`cfconv_fused_reference` with ``mxu`` (JAX
    ``cfconv_pallas._cfconv_bwd_bwd``: in bf16, autograd through the
    operands' casts, as JAX's through ``astype``). Materializes the
    [B,N,N,F] filter grid."""
    d = second_order(
        lambda *a: cfconv_fused_reference(*a, start, stop, num_g, mxu),
        (dist, env, x, w1, b1, w2, b2, g), 7, cts, _places)
    return (*d[:3], d[7], *d[3:7])


def cfconv_bwd_sym_bwd(dist, env, x, g, w1, b1, w2, b2, cts, start, stop,
                       num_g, mxu="f32"):
    """Second order of :func:`cfconv_bwd_sym`, whose ddist/denv come back
    placed: :func:`cfconv_bwd_bwd` with the placement's transpose applied to
    the ddist/denv cotangents (JAX ``cfconv_pallas._cfconv_sym_bwd_bwd``).
    The two agree on the symmetric cotangents a chain through the positions
    gives."""
    return cfconv_bwd_bwd(dist, env, x, g, w1, b1, w2, b2, cts, start, stop,
                          num_g, mxu, {0: False, 1: False})


def cfconv_plain(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                 mxu="f32"):
    """The plain version of the CFConv pair, differentiable on any device:
    in f32 :func:`cfconv_fused_reference` (autograd is the plain backward);
    in bf16 the same forward with the plain bf16 backward
    (:func:`cfconv_bwd_bf16_reference`, the kernels' rounding) and, behind
    it, the second order (:func:`cfconv_bwd_bwd`)."""
    check_mxu(mxu)
    if mxu == "f32":
        return cfconv_fused_reference(dist, env, x, w1, b1, w2, b2, start,
                                      stop, num_g)
    return _CFConv.apply(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                         False, False, mxu, True)


@counted("cfconv_fwd")
def cfconv_fused(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                 sparse=False, mxu="f32"):
    """m[b,i,f] = Σ_j env·(ssp(rbf(d)W1+b1)W2+b2)[f]·x[b,j,f]; [B,N,F].
    ``sparse`` skips pair tiles whose env is all zero (same output).
    ``mxu='bf16'``: the filter products on bf16 operands (the kernel's bf16
    instance). Differentiable on both devices (on CUDA through
    ``cfconv_bwd``)."""
    if on_cpu("cfconv_fwd", dist, env, x, w1, b1, w2, b2):
        return cfconv_plain(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                            mxu)
    return _CFConv.apply(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                         False, sparse, mxu, False)


def _cfconv_bwd_fake(dist, env, x, g, w1, b1, w2, b2, start, stop, num_g,
                     symmetric, sparse, mxu="f32"):
    f = x.shape[-1]
    return (torch.empty_like(dist), torch.empty_like(env), torch.empty_like(x),
            x.new_empty((num_g * f + f + f * f + f,)))


def _cfconv_bwd_plain(dist, env, x, g, w1, b1, w2, b2, start, stop, num_g,
                      symmetric, sparse, mxu="f32"):
    ddist, denv, dx, *wgrads = fresh_thread(
        cfconv_bwd_reference, dist, env, x, g, w1, b1, w2, b2, start, stop,
        num_g, mxu)
    return ddist, denv, dx, flat(wgrads)


def _split_wgrad(wgrad, num_g, f):
    """(dW1 [G,F], db1, dW2 [F,F], db2) from the kernel's flat weight
    gradient."""
    dw1, db1, dw2, db2 = torch.split(wgrad, [num_g * f, f, f * f, f])
    return dw1.view(num_g, f), db1, dw2.view(f, f), db2


@kernel_op("cfconv_bwd", _cfconv_bwd_fake, _cfconv_bwd_plain)
def _launch_cfconv_bwd(dist: Tensor, env: Tensor, x: Tensor, g: Tensor,
                       w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
                       start: float, stop: float, num_g: int, symmetric: bool,
                       sparse: bool,
                       mxu: str = "f32") -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(ddist, denv, dx, the flat weight gradient dW1|db1|dW2|db2), at any
    F: :func:`filter_blocks_bwd` over :func:`_cfconv_bwd_kernel`, each
    launch counted as it returns."""
    name = "cfconv_bwd_sym" if symmetric else "cfconv_bwd"
    b, ni, nj = dist.shape
    f = x.shape[-1]
    _check_filter_shapes(name, dist, env, x, w1, b1, w2, b2, num_g)
    check_mxu(mxu)
    if g.shape != (b, ni, f):
        raise ValueError(f"{name}: kernel takes g [B,N,F]; got g "
                         f"{tuple(g.shape)}")
    if symmetric and ni != nj:
        raise ValueError(f"{name}: the symmetric mode needs a square grid")
    if mxu == "bf16" and f > KERNEL_F:
        # one launch per hidden block (dh rounded once, as the JAX kernel)
        k, width, _ = _blocks(f)
        x, w1, b1, w2, b2 = _pad_filter(x, w1, b1, w2, b2, width)
        g = torch.nn.functional.pad(g, (0, width - f))
        ddist, denv, dx, wblocks = _cfconv_bwd_bf16w_kernel(
            dist, env, x, g, w1, b1, w2, b2, start, stop, num_g, symmetric,
            sparse)
        BF16W_LAUNCHES[name].launches += k
        return (ddist, denv, dx[..., :f].contiguous(),
                flat(_unpack_hidden_blocks(wblocks, num_g, f)))
    if f == KERNEL_F:
        out = _cfconv_bwd_kernel(dist, env, x, g, w1, b1, w2, b2, start,
                                 stop, num_g, symmetric, sparse, mxu)
        _count(name, mxu)
        return out

    def call(*xw):
        *out, wgrad = _cfconv_bwd_kernel(dist, env, *xw, start, stop, num_g,
                                         symmetric, sparse, mxu)
        _count(name, mxu)
        return (*out, *_split_wgrad(wgrad, num_g, KERNEL_F))

    ddist, denv, dx, *wgrads = filter_blocks_bwd(call, x, g, w1, b1, w2, b2)
    return ddist, denv, dx, flat(wgrads)


def _cfconv_bwd_kernel(dist, env, x, g, w1, b1, w2, b2, start, stop, num_g,
                       symmetric, sparse, mxu):
    """One launch of csrc/cfconv_bwd.cu at F = KERNEL_F: (ddist, denv, dx,
    the flat weight gradient)."""
    name = "cfconv_bwd_sym" if symmetric else "cfconv_bwd"
    b, ni, nj = dist.shape
    f = x.shape[-1]
    smem = _build.kernel_fn("cfconv_bwd", "cfconv_bwd_smem_bytes",
                            [ctypes.c_int], ctypes.c_size_t)(ni)
    check_smem(name, smem)
    blocks = _build.kernel_fn("cfconv_bwd", "cfconv_bwd_blocks",
                              [ctypes.c_int, ctypes.c_int])(b, nj)
    ws_ints = _build.kernel_fn("cfconv_bwd", "cfconv_bwd_ws_ints",
                               [ctypes.c_int] * 3,
                               ctypes.c_size_t)(b, ni, nj)
    fn = _build.kernel_fn(
        "cfconv_bwd", "cfconv_bwd",
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    size = num_g * f + f + f * f + f
    ddist, denv = torch.empty_like(dist), torch.empty_like(env)
    # the symmetric mode adds every dx row with atomics
    dx = (torch.zeros_like if symmetric else torch.empty_like)(x)
    part = torch.empty((blocks, size), dtype=torch.float32, device=dist.device)
    wgrad = torch.empty(size, dtype=torch.float32, device=dist.device)
    # tile flags, per-item tile counts and their prefix sums (the kernel's
    # work list, made on the device)
    ws = torch.empty(ws_ints, dtype=torch.int32, device=dist.device)
    s0, delta, coeff = _rbf_consts(start, stop, num_g)
    tab = _rbf_table(start, stop, num_g, dist.device)
    err = fn(*map(ptr, (dist, env, x, g, w1)), ptr_or_null(tab),
             *map(ptr, (b1, w2, b2, ddist, denv, dx, part, wgrad, ws)),
             b, ni, nj, f, num_g, s0, delta, coeff, int(symmetric),
             int(sparse), int(mxu == "bf16"), stream(dist))
    check_launch(name, err)
    return ddist, denv, dx, wgrad


def _hidden_block_size(num_g, width):
    """Floats of one hidden block's share of the weight gradients: dW1[:, i]
    [G, KERNEL_F], db1[i], dW2[i, :] [KERNEL_F, width] and db2 as 8 rows of
    width (row 0 the sum; the same in every share)."""
    return num_g * KERNEL_F + KERNEL_F + KERNEL_F * width + 8 * width


def _unpack_hidden_blocks(wblocks, num_g, f):
    """(dW1, db1, dW2, db2) at width ``f`` from the hidden blocks' shares
    ``wblocks`` [k, :func:`_hidden_block_size`] at the padded width."""
    k = wblocks.shape[0]
    width = k * KERNEL_F
    parts = [torch.split(row, [num_g * KERNEL_F, KERNEL_F, KERNEL_F * width,
                               8 * width]) for row in wblocks]
    dw1 = torch.cat([p[0].view(num_g, KERNEL_F) for p in parts], -1)
    dw2 = torch.cat([p[2].view(KERNEL_F, width) for p in parts])
    return (dw1[:, :f], torch.cat([p[1] for p in parts])[:f], dw2[:f, :f],
            parts[0][3][:f])


def _pack_hidden_blocks(dw1, db1, dw2, db2):
    """The layout of :func:`_unpack_hidden_blocks` from full-width weight
    gradients at a multiple of KERNEL_F (the plain version's)."""
    width = dw2.shape[-1]
    db2_rows = torch.cat([db2, db2.new_zeros(7 * width)])
    return torch.stack([torch.cat([
        dw1[:, sl].reshape(-1), db1[sl], dw2[sl].reshape(-1), db2_rows])
        for sl in _blocks(width)[2]])


def _cfconv_bwd_bf16w_plain(dist, env, x, g, w1, b1, w2, b2, start, stop,
                            num_g, symmetric, sparse):
    """The plain version of :func:`_cfconv_bwd_bf16w_kernel` (its inputs and
    its outputs' layout): :func:`cfconv_bwd_bf16_blocks_reference`, ddist /
    denv placed in the symmetric mode as the kernel writes them."""
    ddist, denv, dx, *wgrads = cfconv_bwd_bf16_blocks_reference(
        dist, env, x, g, w1, b1, w2, b2, start, stop, num_g)
    if symmetric:
        ddist, denv = place_sym_cotangent(ddist), place_sym_cotangent(denv)
    return ddist, denv, dx, _pack_hidden_blocks(*wgrads)


def _cfconv_bwd_bf16w_kernel(dist, env, x, g, w1, b1, w2, b2, start, stop,
                             num_g, symmetric, sparse):
    """The bf16 backward's hidden-block instance (csrc/cfconv_bwd_bf16w.cu)
    at F = k KERNEL_F (k >= 2): one C call, k launches (one per hidden
    block) after one work list. Returns (ddist, denv, dx, the k hidden
    blocks' weight-gradient shares [k, :func:`_hidden_block_size`])."""
    name = "cfconv_bwd_sym" if symmetric else "cfconv_bwd"
    lib = "cfconv_bwd_bf16w"
    b, ni, nj = dist.shape
    f = x.shape[-1]
    k = f // KERNEL_F
    smem = _build.kernel_fn(lib, "cfconv_bwd_bf16w_smem_bytes",
                            [ctypes.c_int], ctypes.c_size_t)(ni)
    check_smem(name, smem)
    blocks = _build.kernel_fn(lib, "cfconv_bwd_bf16w_blocks",
                              [ctypes.c_int, ctypes.c_int])(b, nj)
    ws_ints = _build.kernel_fn(lib, "cfconv_bwd_bf16w_ws_ints",
                               [ctypes.c_int] * 3, ctypes.c_size_t)(b, ni, nj)
    size = _build.kernel_fn(lib, "cfconv_bwd_bf16w_wgrad_size",
                            [ctypes.c_int] * 2, ctypes.c_size_t)(num_g, f)
    fn = _build.kernel_fn(
        lib, "cfconv_bwd_bf16w",
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    dev = dist.device
    ddist, denv = torch.empty_like(dist), torch.empty_like(env)
    # every launch adds its dx terms to the earlier launches'
    dx = torch.zeros_like(x)
    part = torch.empty((blocks, size), dtype=torch.float32, device=dev)
    wblocks = torch.empty((k, size), dtype=torch.float32, device=dev)
    ws = torch.empty(ws_ints, dtype=torch.int32, device=dev)
    # W1's column blocks, each [G, KERNEL_F] contiguous
    w1b = w1.view(num_g, k, KERNEL_F).transpose(0, 1).contiguous()
    s0, delta, coeff = _rbf_consts(start, stop, num_g)
    tab = _rbf_table(start, stop, num_g, dev)
    err = fn(*map(ptr, (dist, env, x, g, w1b)), ptr_or_null(tab),
             *map(ptr, (b1, w2, b2, ddist, denv, dx, part, wblocks, ws)),
             b, ni, nj, f, num_g, s0, delta, coeff, int(symmetric),
             int(sparse), stream(dist))
    check_launch(name, err)
    return ddist, denv, dx, wblocks


@counted("cfconv_bwd")
def cfconv_bwd(dist, env, x, g, w1, b1, w2, b2, start, stop, num_g,
               sparse=False, mxu="f32"):
    """Backward of :func:`cfconv_fused` for the cotangent ``g`` [B,N,F]:
    (ddist, denv, dx, dW1, db1, dW2, db2). With ``sparse`` the kernel skips
    8x8 tiles whose env is all zero and writes ddist = denv = 0 there (exact
    downstream: env has value and slope zero on those pairs); elsewhere, and
    on the CPU, denv is the true cotangent. ``mxu='bf16'``: the kernel's
    bf16 instance (on the CPU :func:`cfconv_bwd_bf16_reference`)."""
    if on_cpu("cfconv_bwd", dist, env, x, g, w1, b1, w2, b2):
        return cfconv_bwd_reference(dist, env, x, g, w1, b1, w2, b2, start,
                                    stop, num_g, mxu)
    *out, wgrad = launch(_launch_cfconv_bwd, dist, env, x, g,
                         w1, b1, w2, b2, float(start), float(stop), num_g,
                         False, bool(sparse), mxu)
    return (*out, *_split_wgrad(wgrad, num_g, x.shape[-1]))


@counted("cfconv_bwd_sym")
def cfconv_bwd_sym(dist, env, x, g, w1, b1, w2, b2, start, stop, num_g,
                   sparse=False, mxu="f32"):
    """Backward of :func:`cfconv_fused_sym` for the cotangent ``g``
    [B,N,F] and SYMMETRIC dist/env: (ddist, denv, dx, dW1, db1, dW2, db2).
    On CUDA the kernel computes the 8x8 tiles on and above the diagonal
    once and returns ddist/denv placed (:func:`place_sym_cotangent`; with
    ``sparse`` also zero on tiles whose env is all zero); dx and the
    weight gradients are the true ones. On the CPU all seven are the true
    cotangents."""
    if on_cpu("cfconv_bwd_sym", dist, env, x, g, w1, b1, w2, b2):
        return cfconv_bwd_sym_reference(dist, env, x, g, w1, b1, w2, b2,
                                        start, stop, num_g, mxu)
    *out, wgrad = launch(_launch_cfconv_bwd, dist, env, x, g,
                         w1, b1, w2, b2, float(start), float(stop), num_g,
                         True, bool(sparse), mxu)
    return (*out, *_split_wgrad(wgrad, num_g, x.shape[-1]))


@counted("cfconv_fwd_sym")
def cfconv_fused_sym(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                     sparse=False, mxu="f32"):
    """Same output as :func:`cfconv_fused` for SYMMETRIC dist/env only: the
    kernel computes the tiles on and above the diagonal and emits the
    mirrored messages of the ones below. Differentiable on both devices (on
    CUDA through ``cfconv_bwd_sym``)."""
    if on_cpu("cfconv_fwd_sym", dist, env, x, w1, b1, w2, b2):
        return cfconv_plain(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                            mxu)
    return _CFConv.apply(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                         True, sparse, mxu, False)


def cfconv(dist, env, x, w1, b1, w2, b2, start, stop, num_g, symmetric=False,
           sparse="auto", plain=False, mxu="f32"):
    """Dispatcher, as ``cfconv_pallas.cfconv``: the symmetric kernel pair
    whenever the caller guarantees symmetric dist/env, else the plain-mode
    pair; ``plain=True`` takes the plain version on any device (the
    counterpart of ``use_pallas=False``; in bf16 with the kernels' rounding,
    :func:`cfconv_plain`). ``mxu``: the filter products' precision. The JAX
    package waits for N=256 (``cfconv_pallas.sym_profitable``, its TPU
    tiling's first skippable tile); on the H100 the symmetric pair (forward
    + backward) is faster than the plain pair at every DDM bucket from N=32
    and at N=512 (``chip_smoke.py``'s ``cfconv_sym_vs_plain_kernels:``
    line, PERF.md)."""
    if plain:
        return cfconv_plain(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                            mxu)
    sp = sparse_auto(dist.shape[-1], sparse)
    if symmetric:
        return cfconv_fused_sym(dist, env, x, w1, b1, w2, b2, start, stop,
                                num_g, sp, mxu)
    return cfconv_fused(dist, env, x, w1, b1, w2, b2, start, stop, num_g, sp,
                        mxu)


@counted("schnet_stack")
def schnet_stack(dist, env, h0, stacked, start, stop, num_g, symmetric=False,
                 mxu="f32"):
    """Node features after all interaction blocks, [B,N,F] (inference only,
    as ``schnet_stack_infer``). ``stacked`` is the 9-tuple of per-block
    weight stacks (wl1 [L,F,F], w1 [L,G,F], b1 [L,F], w2 [L,F,F], b2 [L,F],
    wa [L,F,F], ba [L,F], wb [L,F,F], bb [L,F]). The kernel skips all-zero
    env tiles; with ``symmetric`` (the caller guarantees symmetric dist/env,
    as for ``cfconv_fused_sym``) it computes one filter per unordered pair.
    Its messages are summed with atomics, in an order that varies from run
    to run (f32 rounding). It computes in f32 only: ``mxu='bf16'`` raises,
    as the JAX package's ``fused_stack_apply`` refuses a bf16 model (its
    serving routes bf16 to the per-block kernels)."""
    check_mxu(mxu)
    if mxu != "f32":
        raise ValueError("schnet_stack: no bf16 instance; run the per-block "
                         "path (SchNet.forward)")
    b, n, _ = dist.shape
    if n > STACK_MAX_N:
        raise ValueError(f"schnet_stack: N={n} exceeds {STACK_MAX_N}; use "
                         "the per-block path")
    if on_cpu("schnet_stack", dist, env, h0, *stacked):
        return schnet_stack_reference(dist, env, h0, stacked, start, stop,
                                      num_g)
    refuse_grad("schnet_stack", "it is inference only; train through the "
                "per-block path (SchNet.forward)", dist, env, h0, *stacked)
    out = launch(_launch_schnet_stack, dist, env, h0,
                 list(stacked), float(start), float(stop), num_g,
                 bool(symmetric))
    schnet_stack.launches += 1
    return out


def _schnet_stack_fake(dist, env, h0, stacked, start, stop, num_g, symmetric):
    return torch.empty_like(h0)


def _schnet_stack_plain(dist, env, h0, stacked, start, stop, num_g,
                        symmetric):
    return schnet_stack_reference(dist, env, h0, stacked, start, stop, num_g)


def pad_stack(h0, stacked, width):
    """h0 [B,N,F] and the stack's nine weight stacks zero-padded to F =
    width: h's padded columns stay zero through every block (lin's zero rows
    and columns; a padded unit's ssp(0) meets zero rows of W2 and of wb).
    Nothing is copied at F = width."""
    f = h0.shape[-1]
    if f == width:
        return h0, list(stacked)
    d = width - f
    pad = torch.nn.functional.pad
    wl1, w1, b1, w2, b2, wa, ba, wb, bb = stacked
    sq = lambda w: pad(w, (0, d, 0, d))  # noqa: E731
    return pad(h0, (0, d)), [sq(wl1), pad(w1, (0, d)), pad(b1, (0, d)),
                             sq(w2), pad(b2, (0, d)), sq(wa), pad(ba, (0, d)),
                             sq(wb), pad(bb, (0, d))]


@kernel_op("schnet_stack", _schnet_stack_fake, _schnet_stack_plain)
def _launch_schnet_stack(dist: Tensor, env: Tensor, h0: Tensor,
                         stacked: Sequence[Tensor], start: float, stop: float,
                         num_g: int, symmetric: bool) -> Tensor:
    """The stack at F <= KERNEL_F, zero-padded to it (:func:`pad_stack`)."""
    f = h0.shape[-1]
    n_layers = stacked[0].shape[0]
    if not 1 <= f <= KERNEL_F or stacked[1].shape != (n_layers, num_g, f):
        raise ValueError(f"schnet_stack: kernel takes F <= {KERNEL_F} and W1 "
                         f"[L,G,F]; got h0 {tuple(h0.shape)}, W1 "
                         f"{tuple(stacked[1].shape)}")
    out = _schnet_stack_kernel(dist, env, *pad_stack(h0, stacked, KERNEL_F),
                               start, stop, num_g, symmetric)
    return out if f == KERNEL_F else out[..., :f].contiguous()


def _schnet_stack_kernel(dist, env, h0, stacked, start, stop, num_g,
                         symmetric):
    """One launch of csrc/schnet_stack.cu at F = KERNEL_F."""
    b, n, _ = dist.shape
    f = h0.shape[-1]
    n_layers = stacked[0].shape[0]
    smem = _build.kernel_fn("schnet_stack", "schnet_stack_smem_bytes",
                            [ctypes.c_int], ctypes.c_size_t)(n)
    check_smem("schnet_stack", smem)
    ws_ints = _build.kernel_fn("schnet_stack", "schnet_stack_ws_ints",
                               [ctypes.c_int] * 2, ctypes.c_size_t)(b, n)
    fn = _build.kernel_fn(
        "schnet_stack", "schnet_stack",
        [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_void_p])
    out = torch.empty_like(h0)
    # x and the messages of every block, and the work list and grid barrier
    xbuf, mbuf = torch.empty_like(h0), torch.empty_like(h0)
    ws = torch.empty(ws_ints, dtype=torch.int32, device=dist.device)
    s0, delta, coeff = _rbf_consts(start, stop, num_g)
    tab = _rbf_table(start, stop, num_g, dist.device)
    wl1, w1, *rest = stacked
    err = fn(*map(ptr, (dist, env, h0, wl1, w1)), ptr_or_null(tab),
             *map(ptr, (*rest, out, xbuf, mbuf, ws)), b, n, f, num_g,
             n_layers, s0, delta, coeff, int(symmetric), stream(dist))
    check_launch("schnet_stack", err)
    return out
