"""SchNet's CFConv on the card: kernel wrappers, their plain versions and
the dispatcher (counterpart of ``geossl_tpu/ops/cfconv_pallas.py``).

Each wrapper takes the plain PyTorch version for tensors on the CPU and
launches its hand-written CUDA kernel (``csrc/``) for tensors on a CUDA
device; anything else raises. There is no fallback from a kernel to the
plain version. Each wrapper counts its launches in ``<wrapper>.launches``
(``ops/_launch.py``).

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

The two CFConv Functions are first order only: a double backward on CUDA
(MD17 force training) raises ``NotImplementedError``.

Every kernel runs its tile products (the stack also its dense layers) on
the tensor cores in 3xTF32 (``csrc/mma_tf32.cuh``), within f32 rounding of
the plain version. The plain-mode forward writes each output row once (no
atomics): two launches give bitwise the same output.
``plain_precision()`` makes the plain versions' PyTorch matmuls full f32.
SchNet's dispatcher takes the symmetric pair whenever dist/env are
symmetric, at every N (the card's measurement); PaiNN keeps the JAX
package's rule (``ops/painn.sym_profitable``).
"""

from __future__ import annotations

import ctypes

import torch

from geossl_tpu_torch.models.common import gaussian_smearing, shifted_softplus
from geossl_tpu_torch.ops import _build
from geossl_tpu_torch.ops._launch import (
    check_launch,
    check_smem,
    counted,
    on_cpu,
    ptr,
    refuse_grad,
    refuse_second_order,
    stream,
)

# Largest N the whole-stack kernel accepts (as cfconv_pallas.STACK_MAX_N).
STACK_MAX_N = 128
# Feature width the kernels' register tiling is written for.
KERNEL_F = 128
# Side of the kernels' square pair tiles.
KERNEL_TILE = 8


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


# -- plain versions -----------------------------------------------------------


def cfconv_fused_reference(dist, env, x, w1, b1, w2, b2, start, stop, num_g):
    """Plain CFConv: materializes the [B,N,N,F] filter tensor."""
    rbf = gaussian_smearing(dist, start, stop, num_g)
    w = shifted_softplus(rbf @ w1 + b1) @ w2 + b2
    return torch.einsum("bijf,bij,bjf->bif", w, env, x)


def cfconv_bwd_reference(dist, env, x, g, w1, b1, w2, b2, start, stop, num_g):
    """Plain backward of :func:`cfconv_fused_reference` for the cotangent
    ``g`` [B,N,F]: (ddist, denv, dx, dW1, db1, dW2, db2), by autograd."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (dist, env, x, w1, b1, w2, b2)]
        out = cfconv_fused_reference(*ins, start, stop, num_g)
        return torch.autograd.grad(out, ins, g)


def cfconv_bwd_sym_reference(dist, env, x, g, w1, b1, w2, b2, start, stop,
                             num_g):
    """Plain version of :func:`cfconv_bwd_sym`: the true, unplaced
    cotangents (those of :func:`cfconv_bwd_reference`).
    :func:`place_sym_cotangent` maps its ddist/denv to the kernel's
    placement."""
    return cfconv_bwd_reference(dist, env, x, g, w1, b1, w2, b2, start, stop,
                                num_g)


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


def _check_filter_shapes(name, dist, env, x, w1, b1, w2, b2, num_g):
    b, _, nj = dist.shape
    f = x.shape[-1]
    if f != KERNEL_F or w1.shape != (num_g, f) or w2.shape != (f, f) \
            or b1.shape != (f,) or b2.shape != (f,):
        raise ValueError(
            f"{name}: kernel takes F={KERNEL_F}, W1 [G,F], W2 [F,F]; got "
            f"x {tuple(x.shape)}, W1 {tuple(w1.shape)}, W2 {tuple(w2.shape)}")
    if env.shape != dist.shape or x.shape != (b, nj, f):
        raise ValueError(f"{name}: shapes dist {tuple(dist.shape)}, env "
                         f"{tuple(env.shape)}, x {tuple(x.shape)} disagree")


def _launch_cfconv(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                   symmetric, sparse):
    b, ni, nj = dist.shape
    f = x.shape[-1]
    _check_filter_shapes("cfconv_fwd", dist, env, x, w1, b1, w2, b2, num_g)
    if symmetric and (ni != nj or num_g > 64):
        raise ValueError("cfconv_fwd: the symmetric mode needs a square grid "
                         f"and G <= 64; got dist {tuple(dist.shape)}, "
                         f"G={num_g}")
    smem = _build.kernel_fn("cfconv_fwd", "cfconv_fwd_smem_bytes",
                            [ctypes.c_int] * 2,
                            ctypes.c_size_t)(num_g, int(symmetric))
    check_smem("cfconv_fwd", smem)
    fn = _build.kernel_fn(
        "cfconv_fwd", "cfconv_fwd",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
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
    err = fn(*map(ptr, (dist, env, x, w1, b1, w2, b2, out, ws)), b, ni, nj, f,
             num_g, s0, delta, coeff, int(symmetric), int(sparse),
             stream(dist))
    check_launch("cfconv_fwd", err)
    return out


class _CFConv(torch.autograd.Function):
    """``cfconv_fwd`` forward, ``cfconv_bwd`` backward, or with ``symmetric``
    both in symmetric mode (``cfconv_bwd_sym``: ddist/denv placed, exact
    upstream of symmetric dist/env). First order only."""

    @staticmethod
    def forward(ctx, dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                symmetric, sparse):
        ctx.save_for_backward(dist, env, x, w1, b1, w2, b2)
        ctx.consts = (start, stop, num_g, sparse)
        ctx.symmetric = symmetric
        return _launch_cfconv(dist, env, x, w1, b1, w2, b2, start, stop,
                              num_g, symmetric, sparse)

    @staticmethod
    def backward(ctx, g):
        bwd = cfconv_bwd_sym if ctx.symmetric else cfconv_bwd
        refuse_second_order(bwd.__name__)
        grads = bwd(*ctx.saved_tensors[:3], g.contiguous(),
                    *ctx.saved_tensors[3:], *ctx.consts)
        return (*grads, None, None, None, None, None)


@counted("cfconv_fwd")
def cfconv_fused(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                 sparse=False):
    """m[b,i,f] = Σ_j env·(ssp(rbf(d)W1+b1)W2+b2)[f]·x[b,j,f]; [B,N,F].
    ``sparse`` skips pair tiles whose env is all zero (same output).
    Differentiable on both devices (on CUDA through ``cfconv_bwd``)."""
    if on_cpu("cfconv_fwd", dist, env, x, w1, b1, w2, b2):
        return cfconv_fused_reference(dist, env, x, w1, b1, w2, b2, start,
                                      stop, num_g)
    out = _CFConv.apply(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                        False, sparse)
    cfconv_fused.launches += 1
    return out


def _launch_cfconv_bwd(name, dist, env, x, g, w1, b1, w2, b2, start, stop,
                       num_g, symmetric, sparse):
    b, ni, nj = dist.shape
    f = x.shape[-1]
    _check_filter_shapes(name, dist, env, x, w1, b1, w2, b2, num_g)
    if g.shape != (b, ni, f) or num_g > 64:
        raise ValueError(f"{name}: kernel takes g [B,N,F] and G <= 64; "
                         f"got g {tuple(g.shape)}, G={num_g}")
    if symmetric and ni != nj:
        raise ValueError(f"{name}: the symmetric mode needs a square grid")
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
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
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
    err = fn(*map(ptr, (dist, env, x, g, w1, b1, w2, b2, ddist, denv, dx,
                        part, wgrad, ws)),
             b, ni, nj, f, num_g, s0, delta, coeff, int(symmetric),
             int(sparse), stream(dist))
    check_launch(name, err)
    dw1, db1, dw2, db2 = torch.split(wgrad, [num_g * f, f, f * f, f])
    return (ddist, denv, dx, dw1.view(num_g, f), db1, dw2.view(f, f), db2)


@counted("cfconv_bwd")
def cfconv_bwd(dist, env, x, g, w1, b1, w2, b2, start, stop, num_g,
               sparse=False):
    """Backward of :func:`cfconv_fused` for the cotangent ``g`` [B,N,F]:
    (ddist, denv, dx, dW1, db1, dW2, db2). With ``sparse`` the kernel skips
    8x8 tiles whose env is all zero and writes ddist = denv = 0 there (exact
    downstream: env has value and slope zero on those pairs); elsewhere, and
    on the CPU, denv is the true cotangent."""
    if on_cpu("cfconv_bwd", dist, env, x, g, w1, b1, w2, b2):
        return cfconv_bwd_reference(dist, env, x, g, w1, b1, w2, b2, start,
                                    stop, num_g)
    out = _launch_cfconv_bwd("cfconv_bwd", dist, env, x, g, w1, b1, w2, b2,
                             start, stop, num_g, False, sparse)
    cfconv_bwd.launches += 1
    return out


@counted("cfconv_bwd_sym")
def cfconv_bwd_sym(dist, env, x, g, w1, b1, w2, b2, start, stop, num_g,
                   sparse=False):
    """Backward of :func:`cfconv_fused_sym` for the cotangent ``g``
    [B,N,F] and SYMMETRIC dist/env: (ddist, denv, dx, dW1, db1, dW2, db2).
    On CUDA the kernel computes the 8x8 tiles on and above the diagonal
    once and returns ddist/denv placed (:func:`place_sym_cotangent`; with
    ``sparse`` also zero on tiles whose env is all zero); dx and the
    weight gradients are the true ones. On the CPU all seven are the true
    cotangents."""
    if on_cpu("cfconv_bwd_sym", dist, env, x, g, w1, b1, w2, b2):
        return cfconv_bwd_sym_reference(dist, env, x, g, w1, b1, w2, b2,
                                        start, stop, num_g)
    out = _launch_cfconv_bwd("cfconv_bwd_sym", dist, env, x, g, w1, b1, w2,
                             b2, start, stop, num_g, True, sparse)
    cfconv_bwd_sym.launches += 1
    return out


@counted("cfconv_fwd_sym")
def cfconv_fused_sym(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                     sparse=False):
    """Same output as :func:`cfconv_fused` for SYMMETRIC dist/env only: the
    kernel computes the tiles on and above the diagonal and emits the
    mirrored messages of the ones below. Differentiable on both devices (on
    CUDA through ``cfconv_bwd_sym``)."""
    if on_cpu("cfconv_fwd_sym", dist, env, x, w1, b1, w2, b2):
        return cfconv_fused_reference(dist, env, x, w1, b1, w2, b2, start,
                                      stop, num_g)
    out = _CFConv.apply(dist, env, x, w1, b1, w2, b2, start, stop, num_g,
                        True, sparse)
    cfconv_fused_sym.launches += 1
    return out


def cfconv(dist, env, x, w1, b1, w2, b2, start, stop, num_g, symmetric=False,
           sparse="auto", plain=False):
    """Dispatcher, as ``cfconv_pallas.cfconv``: the symmetric kernel pair
    whenever the caller guarantees symmetric dist/env, else the plain-mode
    pair; ``plain=True`` takes the plain version on any device (the
    counterpart of ``use_pallas=False``). The JAX package waits for N=256
    (``cfconv_pallas.sym_profitable``, its TPU tiling's first skippable
    tile); on the H100 the symmetric pair (forward + backward) is faster
    than the plain pair at every DDM bucket from N=32 and at N=512
    (``chip_smoke.py``'s ``cfconv_sym_vs_plain_kernels:`` line, PERF.md)."""
    if plain:
        return cfconv_fused_reference(dist, env, x, w1, b1, w2, b2, start,
                                      stop, num_g)
    sp = sparse_auto(dist.shape[-1], sparse)
    if symmetric:
        return cfconv_fused_sym(dist, env, x, w1, b1, w2, b2, start, stop,
                                num_g, sp)
    return cfconv_fused(dist, env, x, w1, b1, w2, b2, start, stop, num_g, sp)


@counted("schnet_stack")
def schnet_stack(dist, env, h0, stacked, start, stop, num_g, symmetric=False):
    """Node features after all interaction blocks, [B,N,F] (inference only,
    as ``schnet_stack_infer``). ``stacked`` is the 9-tuple of per-block
    weight stacks (wl1 [L,F,F], w1 [L,G,F], b1 [L,F], w2 [L,F,F], b2 [L,F],
    wa [L,F,F], ba [L,F], wb [L,F,F], bb [L,F]). The kernel skips all-zero
    env tiles; with ``symmetric`` (the caller guarantees symmetric dist/env,
    as for ``cfconv_fused_sym``) it computes one filter per unordered pair.
    Its messages are summed with atomics, in an order that varies from run
    to run (f32 rounding)."""
    b, n, _ = dist.shape
    if n > STACK_MAX_N:
        raise ValueError(f"schnet_stack: N={n} exceeds {STACK_MAX_N}; use "
                         "the per-block path")
    if on_cpu("schnet_stack", dist, env, h0, *stacked):
        return schnet_stack_reference(dist, env, h0, stacked, start, stop,
                                      num_g)
    refuse_grad("schnet_stack", "it is inference only; train through the "
                "per-block path (SchNet.forward)", dist, env, h0, *stacked)
    f = h0.shape[-1]
    n_layers = stacked[0].shape[0]
    if f != KERNEL_F or stacked[1].shape != (n_layers, num_g, f) \
            or num_g > 64:
        raise ValueError(f"schnet_stack: kernel takes F={KERNEL_F}, G <= 64 "
                         f"and W1 [L,G,F]; got h0 {tuple(h0.shape)}, W1 "
                         f"{tuple(stacked[1].shape)}")
    smem = _build.kernel_fn("schnet_stack", "schnet_stack_smem_bytes",
                            [ctypes.c_int], ctypes.c_size_t)(n)
    check_smem("schnet_stack", smem)
    ws_ints = _build.kernel_fn("schnet_stack", "schnet_stack_ws_ints",
                               [ctypes.c_int] * 2, ctypes.c_size_t)(b, n)
    fn = _build.kernel_fn(
        "schnet_stack", "schnet_stack",
        [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_void_p])
    out = torch.empty_like(h0)
    # x and the messages of every block, and the work list and grid barrier
    xbuf, mbuf = torch.empty_like(h0), torch.empty_like(h0)
    ws = torch.empty(ws_ints, dtype=torch.int32, device=dist.device)
    s0, delta, coeff = _rbf_consts(start, stop, num_g)
    err = fn(*map(ptr, (dist, env, h0, *stacked, out, xbuf, mbuf, ws)), b, n,
             f, num_g, n_layers, s0, delta, coeff, int(symmetric),
             stream(dist))
    check_launch("schnet_stack", err)
    schnet_stack.launches += 1
    return out
