#!/usr/bin/env python3
"""Smoke run of geossl_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. Card: print ``nvidia-smi`` name and power limit, build every CUDA kernel
   from ``geossl_tpu_torch/ops/csrc`` (one nvcc per source, in parallel).
2. Kernel parity: each kernel against its plain PyTorch version on the card
   (rtol 1e-4, atol 1e-5 in f32: summation order and, in the symmetric mode,
   atomics differ), on real-geometry inputs with padding and empty tiles,
   occupancy gating on and off, at the bucket sizes and at a pad that is
   no multiple of the 8-atom tile.
   The backward kernels (``cfconv_bwd``, ``ncsn_score_bwd``) and the NCSN
   forward are held to their plain versions as well: per-pair and per-node
   outputs elementwise with rtol 1e-4 and atol 1e-5 times the output's
   largest magnitude (f32 sums over up to N terms in another order: the
   error scales with the summands, not with the element), the head's du
   and each kernel's weight gradients together by relative Frobenius norm
   1e-3 and each weight gradient by 1e-2 (f32 sums over up to B*N^2 pair
   terms that cancel; du and the head's weight gradients also see relu'
   flip where a pre-activation lies within rounding of zero). ``cfconv_bwd``'s
   denv is compared on occupied 8x8 tiles and must be zero on the others
   (the occupancy contract of ``geossl_tpu/ops/pallas_utils.py``).
   ``cfconv_bwd_sym`` likewise on LBA complexes (N=256, N=512 and a pad
   of 260), ddist and denv by its placement contract: the plain version's
   true cotangents placed as ``ops/cfconv.place_sym_cotangent`` says (on
   8x8 tiles above the diagonal the sum of a cell's and its mirror's, on
   diagonal tiles the cell's own, below the diagonal and, with gating, on
   empty tiles zero), elementwise with the scaled atol; dx elementwise.
   PaiNN's kernels likewise, at full width (F=128, R=20, cutoff 5):
   ``painn_fwd`` elementwise at rtol 1e-4 / atol 1e-5; ``painn_bwd``'s
   seven per-pair and per-node cotangents elementwise (scaled atol) and
   dWk/dbk by relative norm, its five pair cotangents zero on empty tiles
   with gating on; ``painn_stack`` (scaled atol) against the per-block
   plain chain.
3. Main paths, each with the launch counters reset just before and read
   just after; every kernel of the path must have launched.
   a. Serving: ``Predictor`` at full SchNet width (F=128, L=6, G=51,
      cutoff 10, batch 128, buckets 32..512) with seeded random weights
      serves a store that spans all five buckets (``predict`` and
      ``embed``), then a ``max_neighbors=32`` Predictor serves it again.
      Outputs must be finite, and 8 molecules per bucket are held against
      the plain path on the card. Then the same for a seeded full-width
      PaiNN ``Predictor`` (F=128, 3 blocks, 20 RBF, cutoff 5, the halving
      MLP head): ``painn_stack`` up to N=128, ``painn_fwd`` above.
   b. Training: ``train.pretrain_geossl.main`` (GeoSSL-DDM at the published
      defaults: SchNet F=128, L=6, G=51, cutoff 10; batch 128, buckets
      32/64/128; NCSN sigma 10 -> 0.01 over 50 levels, anneal 2; GeoSSL
      sigma 0.3, masking 0.3; lr 5e-4) trains one epoch of a synthetic
      Molecule3D store that fills the three buckets. Every loss must be
      finite; ``model.pth`` must load into a ``Predictor`` that embeds
      finite values. Then one full-width step per bucket with kernels is
      held to the same step with the plain versions (the same injected
      noise; loss rtol 1e-4, all gradients together by relative norm 1e-3
      and each parameter's by 1e-2). A gradient must flow through the
      symmetric CFConv (``cfconv_bwd_sym``) and a second order through it
      must raise; the stack must refuse autograd. Then the same for PaiNN-DDM
      (``--model_3d painn``: ``painn_fwd``/``painn_bwd`` in the backbone,
      the clean geometry's radius graph as both views' pair mask), whose
      whole-stack kernel must refuse autograd. The comparisons run on a
      freshly seeded DDM
      model: on the trained one, which differs from run to run in its last
      digits, which pre-activations sit within rounding of a relu's kink
      changes between runs, and in one of five runs kinks crossed by one
      side only moved the head kernel's db_d2 by 1.7x its value.
   c. Fine-tunes at N=512: ``train.finetune_lba.main`` at the published
      settings (SchNet F=128, L=6, G=51, cutoff 10; batch 64, bucket 512,
      lr 1e-4, Morton sort on) for 2 epochs of a synthetic LBA store of 160
      complexes (2 training batches, 16 val and 16 test complexes) from the
      DDM-SchNet ``model.pth`` of b: ``cfconv_fwd_sym`` and
      ``cfconv_bwd_sym`` must launch, losses and metrics be finite, and the
      written ``model.pth`` must give the run's best val MSE again under
      ``--eval_only``. The same for ``train.finetune_lep.main`` at its
      defaults (batch 16, bucket 512) for 1 epoch of 64 synthetic pairs,
      and for 2 PaiNN LBA steps (``painn_fwd``/``painn_bwd`` at N=512)
      from the DDM-PaiNN ``model.pth``. Then one full-width LBA-SchNet step
      at N=512 with kernels is held to the same step with the plain
      versions (in chunks of 4 graphs; tolerances as in b) on a freshly
      seeded net. On the same batch of 64 complexes, a freshly seeded
      full-width LBA-PaiNN net (F=128, 3 blocks, 20 RBF, cutoff 5): block
      0's ``painn_fwd`` and ``painn_bwd`` against their plain versions (in
      graph chunks; tolerances as in 2), then one LBA-PaiNN step against
      the plain step (in chunks of 2 graphs; tolerances as in b).
4. Measurements: serving mol/s per bucket (steady state, synchronized) and
   one traced pass per bucket (torch.profiler: device busy time, the
   port's kernels' share, idle share); training mol/s per bucket (median of
   3 synchronized steps after a warm-up) and one traced step per bucket,
   for both backbones, and the kernels with the most device time at each
   path's largest bucket; fine-tune complexes/s (LEP: pairs/s) at N=512,
   one traced step and its top device kernels, for LBA and LEP;
   each kernel's time at the shape its path gives it, beside its plain
   version's time and its bound (f32 CUDA-core peak and HBM rate; the
   pairs with nonzero env or sel, and with symmetric dist/env each pair's
   filter once and the upper triangle read), and ptxas's registers and
   spills per kernel.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. The whole output is also written to
``runs/chip_smoke.log``.
"""

import json
import os
import shutil
import subprocess
import sys
import time

RTOL, ATOL = 1e-4, 1e-5
# weight gradients, together (each tensor: 10x): relative Frobenius norm
GRAD_RTOL = 1e-3
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


class _Tee:
    """Writes to several streams: the console and the run's log file."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def cuda_time_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn):
    """(wall s, device busy s, port kernels s) of one call of fn under
    torch.profiler; busy sums every device activity (kernels and copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) * 1e-6
    ours = sum(e.time_range.elapsed_us() for e in dev
               if "geossl::" in e.name) * 1e-6
    return wall, busy, ours


def print_top_ops(fn, model_3d, path, bucket, top=6):
    """The kernels with the most device time in one more traced call of fn
    (the path's largest bucket: where the device is busiest)."""
    from geossl_tpu_torch.utils.profiling import top_device_ops

    ops = [[name, ms, count] for name, ms, count in top_device_ops(fn, top, 0)]
    print("top_ops: " + json.dumps({"model": model_3d, "path": path,
                                    "bucket": bucket, "ops_ms_calls": ops}))


def pair_work(dist, env):
    """(ordered pairs with env != 0, pairs whose filter network the function
    needs, cells of dist and of env it must read) for this run's inputs. When
    dist and env are symmetric, one filter serves both directions of a pair
    and the upper triangle (diagonal included) holds all of dist and env."""
    import torch

    nz = env != 0
    nnz = int(nz.sum())
    b, n, _ = env.shape
    if torch.equal(env, env.transpose(1, 2)) and \
            torch.equal(dist, dist.transpose(1, 2)):
        return nnz, int(torch.triu(nz).sum()), b * n * (n + 1) // 2
    return nnz, nnz, b * n * n


# kernel -> (library, mangled-name prefix of its entry function)
KERNEL_ENTRIES = {
    "cfconv_fwd": ("cfconv_fwd", "_ZN6geossl17cfconv_fwd_kernelILb0E"),
    "cfconv_fwd_sym": ("cfconv_fwd", "_ZN6geossl17cfconv_fwd_kernelILb1E"),
    "schnet_stack": ("schnet_stack", "_ZN6geossl19schnet_stack_kernel"),
    "cfconv_bwd": ("cfconv_bwd", "_ZN6geossl17cfconv_bwd_kernelILb0E"),
    "cfconv_bwd_sym": ("cfconv_bwd", "_ZN6geossl17cfconv_bwd_kernelILb1E"),
    "ncsn_score_fwd": ("ncsn_score", "_ZN6geossl15ncsn_fwd_kernel"),
    "ncsn_score_bwd": ("ncsn_score", "_ZN6geossl15ncsn_bwd_kernel"),
    "painn_fwd": ("painn_fwd", "_ZN6geossl16painn_fwd_kernel"),
    "painn_bwd": ("painn_bwd", "_ZN6geossl16painn_bwd_kernel"),
    "painn_stack": ("painn_stack", "_ZN6geossl18painn_stack_kernel"),
}


def ptxas_usage(log, prefix):
    """{"registers", "spill_store_bytes", "spill_load_bytes"} of the entry
    function named ``prefix...`` in ``nvcc -Xptxas -v`` output (None where
    the log does not say)."""
    import re

    usage = {"registers": None, "spill_store_bytes": None,
             "spill_load_bytes": None}
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
        if m:
            current = m.group(1)
            continue
        if current is None or not current.startswith(prefix):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            usage["spill_store_bytes"] = int(m.group(1))
            usage["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage["registers"] = int(m.group(1))
    return usage


def chunked(fn, batched, rest, chunk):
    """fn over slices of the batch dimension (the plain versions materialize
    [B,N,N,F]; per-graph results are independent)."""
    import torch

    b = batched[0].shape[0]
    return torch.cat([fn(*(t[s:s + chunk] for t in batched), *rest)
                      for s in range(0, b, chunk)])


def chunked_sum(fn, batched, rest, chunk, n_cat):
    """fn over slices of the batch dimension for a function whose first
    ``n_cat`` outputs are per graph (concatenated) and the others sums over
    the batch (added up): the plain backward versions."""
    import torch

    b = batched[0].shape[0]
    parts = [fn(*(t[s:s + chunk] for t in batched), *rest)
             for s in range(0, b, chunk)]
    return tuple(torch.cat(col) if k < n_cat else sum(col)
                 for k, col in enumerate(zip(*parts)))


def tile_occupied(env, tile=8):
    """[B,N,N] bool: the cell lies in an 8x8 tile with a nonzero env."""
    import torch.nn.functional as F

    b, n, m = env.shape
    nz = F.pad((env != 0).float(), (0, -m % tile, 0, -n % tile))
    occ = nz.view(b, nz.shape[1] // tile, tile, nz.shape[2] // tile, tile)
    occ = occ.amax(dim=(2, 4)) > 0
    return occ.repeat_interleave(tile, 1).repeat_interleave(tile, 2)[:, :n, :m]


class Errors:
    """Largest |kernel - plain| seen per kernel, failing on a mismatch."""

    def __init__(self):
        self.max_abs = {}

    def _note(self, name, got, want, what):
        import torch

        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{name} {what}: shape {tuple(got.shape)} vs "
                 f"{tuple(want.shape)} or non-finite output")
        err = (got - want).abs().max().item()
        self.max_abs[name] = max(self.max_abs.get(name, 0.0), err)
        return err

    def check_scaled(self, name, got, want, what):
        """Elementwise, rtol RTOL and atol ATOL times max|want| (sums over
        up to N terms)."""
        err = self._note(name, got, want, what)
        atol = ATOL * max(1.0, want.abs().max().item())
        if not (got - want).abs().le(atol + RTOL * want.abs()).all():
            fail(f"{name} {what}: max_abs_err {err:.3e} beyond rtol {RTOL} "
                 f"atol {atol:.3e}")
        print(f"parity {name} {what}: max_abs_err {err:.3e} (atol {atol:.2e})")

    def check_norm(self, name, got, want, what, tol=GRAD_RTOL):
        """Relative Frobenius norm (sums over many pairs that cancel)."""
        err = self._note(name, got, want, what)
        rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
        if rel > tol:
            fail(f"{name} {what}: relative error {rel:.3e} beyond {tol}")
        print(f"parity {name} {what}: rel_norm {rel:.3e} max_abs_err {err:.3e}")

    def check(self, name, got, want, what):
        import torch

        err = self._note(name, got, want, what)
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"{name} {what}: max_abs_err {err:.3e} beyond rtol {RTOL} "
                 f"atol {ATOL}")
        print(f"parity {name} {what}: max_abs_err {err:.3e}")


BWD_NAMES = ("ddist", "denv", "dx", "dW1", "db1", "dW2", "db2")


def check_weight_grads(errs, kernel, got, want, names, what):
    """A kernel's weight gradients: all together by relative norm
    GRAD_RTOL, each by 10x that (a scalar bias such as db_d2 sums ~1e6
    pair terms that cancel to a few parts in 1e3 of their scale)."""
    import torch

    for name, a, w in zip(names, got, want):
        errs.check_norm(kernel, a, w, f"{what} {name}", tol=10 * GRAD_RTOL)
    errs.check_norm(kernel, torch.cat([a.flatten() for a in got]),
                    torch.cat([w.flatten() for w in want]),
                    f"{what} all weight gradients")


def check_cfconv_bwd(errs, dist, env, x, g, fw, G, cutoff, what, chunk=None):
    """cfconv_bwd against its plain version, gating off and on."""
    import torch

    from geossl_tpu_torch.ops import cfconv as K

    args = (0.0, cutoff, G)
    if chunk is None:
        want = K.cfconv_bwd_reference(dist, env, x, g, *fw, *args)
    else:
        want = chunked_sum(K.cfconv_bwd_reference, (dist, env, x, g),
                           (*fw, *args), chunk, 3)
    occ = tile_occupied(env)
    for sp in (False, True):
        got = K.cfconv_bwd(dist, env, x, g, *fw, *args, sp)
        for k, (name, a, w) in enumerate(zip(BWD_NAMES, got, want)):
            tag = f"{what} sparse={sp} {name}"
            if name == "denv" and sp:
                if (a[~occ] != 0).any():
                    fail(f"cfconv_bwd {tag}: nonzero on an empty tile")
                w = torch.where(occ, w, torch.zeros_like(w))
            if k < 3:
                errs.check_scaled("cfconv_bwd", a, w, tag)
        check_weight_grads(errs, "cfconv_bwd", got[3:], want[3:],
                           BWD_NAMES[3:], f"{what} sparse={sp}")


def check_cfconv_bwd_sym(errs, dist, env, x, g, fw, G, cutoff, what,
                         chunk=None):
    """cfconv_bwd_sym against its plain version, gating off and on: ddist
    and denv by the placement contract (``ops/cfconv.place_sym_cotangent``
    of the plain, unplaced cotangents; with gating also zero on empty 8x8
    tiles), elementwise with the scaled atol; dx elementwise; the weight
    gradients by relative norm."""
    import torch

    from geossl_tpu_torch.ops import cfconv as K

    args = (0.0, cutoff, G)
    if chunk is None:
        want = K.cfconv_bwd_sym_reference(dist, env, x, g, *fw, *args)
    else:
        want = chunked_sum(K.cfconv_bwd_sym_reference, (dist, env, x, g),
                           (*fw, *args), chunk, 3)
    want = (*(K.place_sym_cotangent(w) for w in want[:2]), *want[2:])
    occ = tile_occupied(env)
    for sp in (False, True):
        got = K.cfconv_bwd_sym(dist, env, x, g, *fw, *args, sp)
        for k, (name, a, w) in enumerate(zip(BWD_NAMES[:3], got, want)):
            tag = f"{what} sparse={sp} {name}"
            if k < 2 and sp:
                if (a[~occ] != 0).any():
                    fail(f"cfconv_bwd_sym {tag}: nonzero on an empty tile")
                w = torch.where(occ, w, torch.zeros_like(w))
            errs.check_scaled("cfconv_bwd_sym", a, w, tag)
        check_weight_grads(errs, "cfconv_bwd_sym", got[3:], want[3:],
                           BWD_NAMES[3:], f"{what} sparse={sp}")


PAINN_BWD_NAMES = ("ddist", "dgate", "ddirx", "ddiry", "ddirz", "dx", "dmu",
                   "dWk", "dbk")


def painn_inputs(m, batch, seed=SEED, pair_mask=None):
    """PaiNN's message-pass inputs on a packed batch: the five pair grids
    (dist, gate, dir x/y/z), q0, block 0's x and a seeded mu of unit scale
    (block 0's own mu is zero, which would test nothing)."""
    import torch

    with torch.no_grad():
        dist, direction, gate = m.geometry(batch.positions, batch.node_mask,
                                           pair_mask)
        q0 = m.embed(batch.atom_type).contiguous()
        x = m.interactions[0].interatomic_context_net(q0).contiguous()
    gen = torch.Generator(x.device).manual_seed(seed)
    mu = torch.randn(x.shape, generator=gen, device=x.device)
    grids = (dist.contiguous(), gate.contiguous(),
             *(direction[..., c].contiguous() for c in range(3)))
    return grids, q0, x, mu


def check_painn_bwd(errs, grids, x, mu, wk, bk, gq, gmu, cutoff, what,
                    chunk=None):
    """painn_bwd against its plain version, gating off and on: the seven
    per-pair and per-node cotangents elementwise (scaled), dWk and dbk by
    relative norm; with gating, the five pair cotangents must be zero on
    empty 8x8 tiles (dgate is compared on the occupied ones)."""
    import torch

    from geossl_tpu_torch.ops import painn as P

    def plain(d, g, a, b, c, xx, m, gq_, gmu_):
        return P.painn_bwd_reference(d, g, a, b, c, xx, m, wk, bk, gq_, gmu_,
                                     cutoff)

    want = (plain(*grids, x, mu, gq, gmu) if chunk is None else
            chunked_sum(plain, (*grids, x, mu, gq, gmu), (), chunk, 7))
    occ = tile_occupied(grids[1])
    for sp in (False, True):
        got = P.painn_bwd(*grids, x, mu, wk, bk, gq, gmu, cutoff, sp)
        for k, (name, a, w) in enumerate(zip(PAINN_BWD_NAMES[:7], got, want)):
            tag = f"{what} sparse={sp} {name}"
            if k < 5 and sp:
                if (a[~occ] != 0).any():
                    fail(f"painn_bwd {tag}: nonzero on an empty tile")
                w = torch.where(occ, w, torch.zeros_like(w))
            errs.check_scaled("painn_bwd", a, w, tag)
        check_weight_grads(errs, "painn_bwd", got[7:], want[7:],
                           PAINN_BWD_NAMES[7:], f"{what} sparse={sp}")


def measure_serving(pred, subs, model_3d):
    """Serving mol/s per bucket (median of 3 synchronized passes after a
    warm-up) and one traced pass per bucket."""
    device_profile(lambda: pred.predict(next(iter(subs.values()))))  # start-up
    for b, sub in subs.items():
        pred.predict(sub)  # warm-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred.predict(sub)  # ends in a device-to-host copy: synchronized
            times.append(time.perf_counter() - t0)
        t = sorted(times)[1]
        print("serve: " + json.dumps({"model": model_3d, "bucket": b,
                                      "molecules": len(sub),
                                      "batches": -(-len(sub) // 128),
                                      "s_per_pass": t,
                                      "mol_per_s": len(sub) / t}))
        # a separate traced pass (the profiler slows the host side)
        wall, busy, ours = device_profile(lambda: pred.predict(sub))
        print("profile: " + json.dumps({
            "model": model_3d, "bucket": b, "traced_wall_s": wall,
            "device_busy_s": busy, "port_kernels_s": ours,
            "other_device_s": busy - ours, "idle_share": 1.0 - busy / wall}))
    print_top_ops(lambda: pred.predict(sub), model_3d, "serve", b)


def measure_training(ddm, targs, batches, model_3d):
    """Training mol/s per bucket (median of 3 synchronized steps after a
    warm-up) and one traced step per bucket."""
    import torch

    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.train import pretrain_geossl as PG

    opt, sched = common.make_optimizer_from_args(targs, ddm.parameters(), 100)
    gen_t = torch.Generator(batches[0].positions.device).manual_seed(SEED)
    device_profile(lambda: PG.train_step(ddm, opt, sched, [batches[0]],
                                         targs, gen_t))  # profiler start-up
    for batch in batches:
        b = batch.max_atoms
        mols = int(batch.graph_mask.sum())

        def step():
            return PG.train_step(ddm, opt, sched, [batch], targs, gen_t)

        step()  # warm-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        t = sorted(times)[1]
        print("train: " + json.dumps({"model": model_3d, "bucket": b,
                                      "molecules": mols, "s_per_step": t,
                                      "mol_per_s": mols / t}))
        wall, busy, ours = device_profile(step)
        print("train_profile: " + json.dumps({
            "model": model_3d, "bucket": b, "traced_wall_s": wall,
            "device_busy_s": busy, "port_kernels_s": ours,
            "other_device_s": busy - ours, "idle_share": 1.0 - busy / wall}))
    print_top_ops(step, model_3d, "train", b)


def measure_finetune(net, fargs, batch, loss_fn, task, items):
    """Fine-tune throughput at N=512 (median of 3 synchronized optimizer
    steps after a warm-up: ``items`` complexes, or LEP pairs, per step),
    one traced step, and the step's top device kernels."""
    import torch

    from geossl_tpu_torch.train import common

    opt, sched = common.make_optimizer_from_args(fargs, net.parameters(), 100)

    def step():
        return common.finetune_step(net, opt, sched, [batch], loss_fn)

    device_profile(step)  # profiler start-up
    step()  # warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t = sorted(times)[1]
    model_3d = fargs.model_3d
    print("finetune: " + json.dumps({"task": task, "model": model_3d,
                                     "bucket": batch.max_atoms,
                                     "items": items, "s_per_step": t,
                                     "items_per_s": items / t}))
    wall, busy, ours = device_profile(step)
    print("finetune_profile: " + json.dumps({
        "task": task, "model": model_3d, "bucket": batch.max_atoms,
        "traced_wall_s": wall, "device_busy_s": busy, "port_kernels_s": ours,
        "other_device_s": busy - ours, "idle_share": 1.0 - busy / wall}))
    print_top_ops(step, model_3d, f"finetune_{task}", batch.max_atoms)


def ncsn_inputs(ddm, batch, targs, seed):
    """The head's kernel inputs on this batch as the training step makes
    them: (dist of the perturbed view, noise, sel, sigma, u), the ten
    weights and the anneal power."""
    import torch

    from geossl_tpu_torch.ops import geometry
    from geossl_tpu_torch.train.pretrain_geossl import batch_views

    gen = torch.Generator(batch.positions.device).manual_seed(seed)
    pos2, sel = batch_views(targs, batch, gen)
    head = ddm.NCSN_01
    with torch.no_grad():
        _, h1 = ddm.model(batch.atom_type, batch.positions, batch.node_mask)
        u = head.out0_h(h1).contiguous()
    d2, _ = geometry.pairwise_distances(pos2, batch.node_mask)
    b = d2.shape[0]
    level = torch.randint(0, head.num_noise_level, (b,), generator=gen,
                          device=d2.device)
    noise = torch.randn(d2.shape, generator=gen, device=d2.device)
    weights = [w.detach() for w in head.head_weights()]
    return ((d2.contiguous(), noise, sel.float(), head.sigmas[level], u),
            weights, head.anneal_power)


def check_ncsn(errs, grid, weights, anneal, what, chunk=None):
    """ncsn_score_fwd/_bwd against their plain versions."""
    import torch

    from geossl_tpu_torch.ops import ncsn as NS

    gen = torch.Generator(grid[0].device).manual_seed(SEED)
    g_rows = torch.randn(grid[0].shape[:2], generator=gen,
                         device=grid[0].device)
    with torch.no_grad():
        if chunk is None:
            want_rows = NS.ncsn_score_loss_reference(*grid, *weights, anneal)
            want = NS.ncsn_score_bwd_reference(*grid, g_rows, *weights,
                                               anneal=anneal)
        else:
            want_rows = chunked(NS.ncsn_score_loss_reference, grid,
                                (*weights, anneal), chunk)
            want = chunked_sum(
                lambda *a: NS.ncsn_score_bwd_reference(*a, anneal=anneal),
                (*grid, g_rows), weights, chunk, 1)
    errs.check_scaled("ncsn_score_fwd", NS.ncsn_score_fwd(
        *grid, *weights, anneal=anneal), want_rows, f"{what} rows")
    got = NS.ncsn_score_bwd(*grid, g_rows, *weights, anneal=anneal)
    # du by norm too: relu' flips where a pre-activation lies within
    # rounding of zero, and at the DDM shape (~65M relu decisions per call)
    # a few always do, each moving some du elements by a whole term
    errs.check_norm("ncsn_score_bwd", got[0], want[0], f"{what} du")
    check_weight_grads(errs, "ncsn_score_bwd", got[1:], want[1:],
                       ["d" + n for n in NS.WEIGHT_NAMES], what)
    return g_rows


def sub_batch(batch, sl):
    from dataclasses import fields, replace

    return replace(batch, **{f.name: getattr(batch, f.name)[sl]
                             for f in fields(batch)
                             if getattr(batch, f.name) is not None})


def grads_in_chunks(module, batch, loss_of, chunk=None):
    """(loss, {name: gradient}) of one step whose loss is a mean over the
    real graphs; ``loss_of(sub_batch, sl)`` is the loss of the graphs in
    slice ``sl``. ``chunk`` splits the batch into graph chunks weighted by
    their share of the real graphs, for the plain versions' memory."""
    module.zero_grad(set_to_none=True)
    gm = batch.graph_mask
    b = gm.shape[0]
    chunk = chunk or b
    count = max(int(gm.sum()), 1)
    total = 0.0
    for s in range(0, b, chunk):
        sl = slice(s, s + chunk)
        c = int(gm[sl].sum())
        if c == 0:
            continue
        loss = loss_of(sub_batch(batch, sl), sl) * (c / count)
        loss.backward()
        total += loss.item()
    return total, {n: p.grad.detach().clone()
                   for n, p in module.named_parameters()}


def ddm_grads(ddm, batch, pos2, sel, draws, chunk=None):
    """``grads_in_chunks`` of one DDM step with injected noise."""
    return grads_in_chunks(
        ddm, batch, lambda sb, sl: ddm(sb, pos2[sl], sel[sl],
                                       tuple(t[sl] for t in draws)), chunk)


def check_step_parity(what, loss_k, grads_k, loss_p, grads_p):
    """A step with kernels against the same step with the plain versions:
    loss rtol RTOL, all gradients together by relative norm GRAD_RTOL and
    each parameter's by 10x that."""
    import torch

    if not abs(loss_k - loss_p) <= RTOL * abs(loss_p):
        fail(f"{what}: loss {loss_k} (kernels) vs {loss_p} (plain)")

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    per = {n: rel(grads_k[n], grads_p[n]) for n in grads_p}
    worst = max(per, key=per.get)
    total = rel(torch.cat([g.flatten() for g in grads_k.values()]),
                torch.cat([g.flatten() for g in grads_p.values()]))
    if total > GRAD_RTOL or per[worst] > 10 * GRAD_RTOL:
        fail(f"{what}: gradients differ by relative norm {total:.3e} in all, "
             f"{per[worst]:.3e} in {worst}")
    print(f"{what}: loss {loss_k:.6f} vs {loss_p:.6f}, gradient rel_norm "
          f"{total:.3e} in all {len(per)} tensors, worst {per[worst]:.3e} "
          f"({worst})")


def step_parity(ddm, batch, targs, bucket, model_3d="SchNet"):
    """One full-width DDM step with kernels against the plain versions on
    the card, with the same injected noise."""
    import torch

    from geossl_tpu_torch.train.pretrain_geossl import batch_views

    gen = torch.Generator(batch.positions.device).manual_seed(SEED + bucket)
    pos2, sel = batch_views(targs, batch, gen)
    draws = []
    for head in (ddm.NCSN_01, ddm.NCSN_02):
        level = torch.randint(0, head.num_noise_level, (batch.batch_size,),
                              generator=gen, device=sel.device)
        draws += [head.sigmas[level],
                  torch.randn(sel.shape, generator=gen, device=sel.device)]
    loss_k, grads_k = ddm_grads(ddm, batch, pos2, sel, draws)
    ddm.plain = True
    loss_p, grads_p = ddm_grads(ddm, batch, pos2, sel, draws, chunk=16)
    ddm.plain = False
    check_step_parity(f"{model_3d} step parity bucket {bucket}", loss_k,
                      grads_k, loss_p, grads_p)


def refuses_grad(fn):
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return None


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    try:
        import geossl_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"geossl_tpu_torch is not importable ({e}); run from the repo root")
    # the whole output also goes to runs/chip_smoke.log (git-ignored), for
    # callers that keep only the end of the console output
    log_dir = os.path.join(ROOT, "runs")
    os.makedirs(log_dir, exist_ok=True)
    log = open(os.path.join(log_dir, "chip_smoke.log"), "w")
    sys.stdout = _Tee(sys.__stdout__, log)
    sys.stderr = _Tee(sys.__stderr__, log)
    import numpy as np

    import math

    from geossl_tpu_torch.config import ModelConfig
    from geossl_tpu_torch.data.bucketing import assign_buckets, pack_batch
    from geossl_tpu_torch.data.molecule3d import load_molecule3d
    from geossl_tpu_torch.data.store import MolStore
    from geossl_tpu_torch.data.synthetic import synthetic_lba, synthetic_molecule3d
    from geossl_tpu_torch.models.common import cosine_envelope
    from geossl_tpu_torch.ops import _build
    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.ops import geometry
    from geossl_tpu_torch.ops import ncsn as NS
    from geossl_tpu_torch.ops import painn as P
    from geossl_tpu_torch.ops._launch import launch_counts, reset_launch_counts
    from geossl_tpu_torch.serve import Predictor
    from geossl_tpu_torch.train import common
    from geossl_tpu_torch.data.bucketing import BucketedLoader
    from geossl_tpu_torch.train import finetune_lba as FL
    from geossl_tpu_torch.train import finetune_lep as FE
    from geossl_tpu_torch.train import pretrain_geossl as PG
    from geossl_tpu_torch.train.common import make_backbone, make_head

    # -- 1. card and build --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed ({smi.returncode})"
    print(f"card: {card}")
    dev = torch.device("cuda")
    t0 = time.time()
    reports = _build.build_all()
    print(f"build: {time.time() - t0:.1f} s for {sorted(reports) or 'cached'}")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    K.plain_precision()

    # -- data and weights -----------------------------------------------------
    mols = synthetic_molecule3d(512, seed=1, max_atoms=100)
    lba = synthetic_lba(32, seed=2, max_atoms=400)
    records = [mols.get(i) for i in range(len(mols))] + \
        [lba.get(i) for i in range(len(lba))]
    for r in records:
        r.y = None  # the two stores label differently; serving needs none
    store = MolStore.from_records(records)
    buckets = (32, 64, 128, 256, 512)
    gen = torch.Generator().manual_seed(SEED)
    cfg = ModelConfig()
    cfg_mn = ModelConfig(max_neighbors=32)
    state = {"model": make_backbone(cfg, gen).state_dict(),
             "graph_pred_linear": make_head("schnet", cfg.emb_dim, gen).state_dict(),
             "y_mean": 1.5, "y_std": 2.0}
    pred = Predictor(cfg, state, batch_size=128, bucket_sizes=buckets)
    pred_mn = Predictor(cfg_mn, state, batch_size=128, bucket_sizes=buckets)
    model, model_mn = pred.model, pred_mn.model
    sorted_store = pred._maybe_sort(store)  # as the Predictor sees it
    bucket_of = assign_buckets(sorted_store.num_atoms(), buckets)
    missing = [b for b in buckets if not (bucket_of == b).any()]
    if missing:
        fail(f"store leaves buckets {missing} empty")
    G, cutoff = cfg.schnet.num_gaussians, cfg.schnet.cutoff
    # PaiNN at its published width, seeded random weights and head
    cfg_p = ModelConfig(model_3d="painn")
    gen_p = torch.Generator().manual_seed(SEED)
    state_p = {"model": make_backbone(cfg_p, gen_p).state_dict(),
               "graph_pred_linear": make_head("painn", cfg_p.emb_dim,
                                              gen_p).state_dict(),
               "y_mean": 1.5, "y_std": 2.0}
    pred_p = Predictor(cfg_p, state_p, batch_size=128, bucket_sizes=buckets)
    model_p = pred_p.model
    cut_p = cfg_p.painn.cutoff

    @torch.inference_mode()
    def layer0_inputs(m, idx, n, batch_size=None):
        """dist, env, h0 and block 0's x for molecules idx packed at n."""
        batch = pack_batch([sorted_store.get(int(i)) for i in idx], n,
                           batch_size).to(dev)
        dist, adj = m.geometry(batch.positions, batch.node_mask)
        env = cosine_envelope(dist, m.cutoff) * adj.float()
        h0 = m.embedding(batch.atom_type)
        x = m.interactions[0].conv.lin1(h0)
        return batch, dist.contiguous(), env.contiguous(), h0.contiguous(), x.contiguous()

    def first(b, k):
        return np.nonzero(bucket_of == b)[0][:k]

    def packed(idx, n, batch_size=None):
        return pack_batch([sorted_store.get(int(i)) for i in idx], n,
                          batch_size).to(dev)

    # -- 2. kernel parity -----------------------------------------------------
    errs = Errors()
    with torch.inference_mode():
        stacked = model.stacked_weights()
        # (bucket, pad): the buckets, plus a pad that is no multiple of the
        # kernels' 8-atom tile (molecules of bucket 128 have <= 100 atoms)
        for b, n in ((32, 32), (128, 128), (128, 100)):
            _, dist, env, h0, _ = layer0_inputs(model, first(b, 8), n)
            want = K.schnet_stack_reference(dist, env, h0, stacked, 0.0, cutoff, G)
            errs.check("schnet_stack", K.schnet_stack(dist, env, h0, stacked, 0.0,
                                                      cutoff, G), want, f"B=8 N={n}")
        filt = model.interactions[0].filter_weights()
        filt_mn = model_mn.interactions[0].filter_weights()
        for name, m, fw, fn, sizes in (
                ("cfconv_fwd", model_mn, filt_mn, K.cfconv_fused,
                 ((128, 128), (256, 256), (128, 100))),
                ("cfconv_fwd_sym", model, filt, K.cfconv_fused_sym,
                 ((256, 256), (512, 512), (128, 132)))):
            for b, n in sizes:
                _, dist, env, _, x = layer0_inputs(m, first(b, 2), n)
                want = K.cfconv_fused_reference(dist, env, x, *fw, 0.0, cutoff, G)
                for sp in (False, True):
                    errs.check(name, fn(dist, env, x, *fw, 0.0, cutoff, G, sp),
                               want, f"B=2 N={n} sparse={sp}")

    # the backward kernels and the NCSN head, outside inference mode (the
    # plain versions differentiate with autograd). Every check of a kernel
    # against its plain version runs on this freshly seeded DDM model (the
    # trained one differs from run to run in its last digits), so that which
    # pre-activations sit within rounding of a relu's kink, where kernel and
    # plain version may take different sides, is the same in every run.
    targs = PG.build_parser().parse_args([])
    ddm0 = PG.make_ddm(targs, cfg, torch.Generator().manual_seed(SEED)).to(dev)
    gen_g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        filt_g = model.interactions[0].filter_weights()
    for b, n in ((32, 32), (128, 128), (128, 100)):
        _, dist, env, _, x = layer0_inputs(model, first(b, 8), n)
        dist, env, x = dist.clone(), env.clone(), x.clone()
        g = torch.randn(x.shape, generator=gen_g).to(dev)
        check_cfconv_bwd(errs, dist, env, x, g, filt_g, G, cutoff, f"B=8 N={n}")
    # the symmetric backward on LBA complexes: the buckets of its path and
    # a pad that is no multiple of the 8-atom tile
    for b, n in ((256, 256), (512, 512), (256, 260)):
        _, dist, env, _, x = layer0_inputs(model, first(b, 2), n)
        dist, env, x = dist.clone(), env.clone(), x.clone()
        g = torch.randn(x.shape, generator=gen_g).to(dev)
        check_cfconv_bwd_sym(errs, dist, env, x, g, filt_g, G, cutoff,
                             f"B=2 N={n}")
    for b in (32, 128):
        batch = pack_batch([sorted_store.get(int(i)) for i in first(b, 8)],
                           b).to(dev)
        grid, weights, anneal = ncsn_inputs(ddm0, batch, targs, SEED)
        check_ncsn(errs, grid, weights, anneal, f"B=8 N={b}")

    # PaiNN's kernels: the message pass and its backward at the buckets, a
    # pad that is no multiple of 8 and N=256 (gating on and off), the whole
    # stack against the per-block plain chain
    with torch.no_grad():
        wk_p, bk_p = model_p.filter_weights()[0]
        stacked_p = model_p.stacked_weights()
    gen_g = torch.Generator(dev).manual_seed(SEED)
    for b, n, k in ((32, 32, 8), (128, 128, 8), (128, 100, 8), (256, 256, 2)):
        grids, q0, x, mu = painn_inputs(model_p, packed(first(b, k), n))
        with torch.no_grad():
            want = P.painn_message_reference(*grids, x, mu, wk_p, bk_p, cut_p)
            for sp in (False, True):
                got = P.painn_message_fused(*grids, x, mu, wk_p, bk_p, cut_p, sp)
                for name, a, w in zip(("dq", "dmu"), got, want):
                    errs.check("painn_fwd", a, w,
                               f"B={k} N={n} sparse={sp} {name}")
        gq = torch.randn(q0.shape, generator=gen_g, device=dev)
        gmu = torch.randn(mu.shape, generator=gen_g, device=dev)
        check_painn_bwd(errs, grids, x, mu, wk_p, bk_p, gq, gmu, cut_p,
                        f"B={k} N={n}")
        if n <= P.STACK_MAX_N:
            with torch.no_grad():
                want = P.painn_stack_reference(*grids, q0, stacked_p, cut_p)
                got = P.painn_stack_infer(*grids, q0, stacked_p, cut_p)
            for name, a, w in zip(("q", "mu"), got, want):
                errs.check_scaled("painn_stack", a, w, f"B={k} N={n} {name}")

    # -- 3a. main path: serving ---------------------------------------------------
    reset_launch_counts()
    t0 = time.time()
    preds = pred.predict(store)
    emb = pred.embed(store)
    preds_mn = pred_mn.predict(store)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"main path (serving): {len(store)} molecules x 3 passes in "
          f"{time.time() - t0:.2f} s (first call); launches {launches}")
    for name in ("cfconv_fwd", "cfconv_fwd_sym", "schnet_stack"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the serving path")
    if preds.shape != (len(store),) or emb.shape != (len(store), cfg.emb_dim):
        fail(f"output shapes {preds.shape}, {emb.shape}")
    for what, arr in (("predict", preds), ("embed", emb),
                      ("predict max_neighbors=32", preds_mn)):
        if not np.isfinite(arr).all():
            fail(f"{what}: non-finite output")

    with torch.inference_mode():
        for b in buckets:
            idx = first(b, 8)
            for what, p, m, got_pred in (("default", pred, model, preds),
                                         ("max_neighbors=32", pred_mn, model_mn,
                                          preds_mn)):
                batch, *_ = layer0_inputs(m, idx, b)
                graph, _ = m(batch.atom_type, batch.positions, batch.node_mask,
                             plain=True)
                want_pred = (p.head(graph) * p.y_std + p.y_mean).cpu().numpy()
                # the store order is kept by the sort, so idx indexes both
                if not np.allclose(got_pred[idx], want_pred, rtol=RTOL, atol=ATOL):
                    fail(f"predict {what} bucket {b}: kernel path vs plain path, "
                         f"max_abs_err {np.abs(got_pred[idx] - want_pred).max():.3e}")
                if what == "default" and not np.allclose(
                        emb[idx], graph.cpu().numpy(), rtol=RTOL, atol=ATOL):
                    fail(f"embed bucket {b}: kernel path vs plain path")
            print(f"serve parity bucket {b}: {len(idx)} molecules agree with "
                  "the plain path (predict, embed, max_neighbors=32 predict)")

    # -- 3a'. main path: PaiNN serving ------------------------------------------
    reset_launch_counts()
    t0 = time.time()
    preds_p = pred_p.predict(store)
    emb_p = pred_p.embed(store)
    torch.cuda.synchronize()
    launches_p = launch_counts()
    print(f"main path (PaiNN serving): {len(store)} molecules x 2 passes in "
          f"{time.time() - t0:.2f} s (first call); launches {launches_p}")
    for name in ("painn_stack", "painn_fwd"):
        if launches_p[name] == 0:
            fail(f"kernel {name} was not launched on the PaiNN serving path")
    if preds_p.shape != (len(store),) or \
            emb_p.shape != (len(store), cfg_p.emb_dim):
        fail(f"PaiNN output shapes {preds_p.shape}, {emb_p.shape}")
    if not (np.isfinite(preds_p).all() and np.isfinite(emb_p).all()):
        fail("PaiNN serving: non-finite output")
    with torch.inference_mode():
        for b in buckets:
            idx = first(b, 8)
            batch = packed(idx, b)
            graph, _ = model_p(batch.atom_type, batch.positions,
                               batch.node_mask, plain=True)
            want_pred = (pred_p.head(graph) * pred_p.y_std
                         + pred_p.y_mean).cpu().numpy()
            graph = graph.cpu().numpy()
            for what, got, want in (("predict", preds_p[idx], want_pred),
                                    ("embed", emb_p[idx], graph)):
                if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
                    fail(f"PaiNN {what} bucket {b}: kernel path vs plain "
                         f"path, max_abs_err {np.abs(got - want).max():.3e}")
            print(f"PaiNN serve parity bucket {b}: {len(idx)} molecules agree "
                  "with the plain path (predict, embed)")

    # -- 3b. main path: DDM pretraining ----------------------------------------------
    out_dir = os.path.join(ROOT, "runs", "chip_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    train_argv = ["--synthetic", "--synthetic_size", "1024",
                  "--synthetic_max_atoms", "100", "--epochs", "1",
                  "--output_model_dir", out_dir]
    reset_launch_counts()
    t0 = time.time()
    ddm, losses = PG.main(train_argv)
    torch.cuda.synchronize()
    train_launches = launch_counts()
    print(f"main path (training): {len(losses)} steps of one epoch in "
          f"{time.time() - t0:.2f} s (first call); launches {train_launches}")
    for name in ("cfconv_fwd", "cfconv_bwd", "ncsn_score_fwd", "ncsn_score_bwd"):
        if train_launches[name] == 0:
            fail(f"kernel {name} was not launched on the training path")
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"training losses {losses}")
    print(f"training losses: {losses}")
    train_store = load_molecule3d("", synthetic=True, synthetic_size=1024,
                                  synthetic_max_atoms=100)
    train_buckets = (32, 64, 128)
    tbucket = assign_buckets(train_store.num_atoms(), train_buckets)
    if not all((tbucket == b).any() for b in train_buckets):
        fail("the training store leaves a bucket empty")
    emb_t = Predictor.from_checkpoint(
        os.path.join(out_dir, "model.pth"), batch_size=128,
        bucket_sizes=train_buckets).embed(train_store)
    if emb_t.shape != (len(train_store), cfg.emb_dim) or \
            not np.isfinite(emb_t).all():
        fail(f"Predictor on model.pth: shape {emb_t.shape} or non-finite")
    print(f"model.pth loads into a Predictor: {emb_t.shape[0]} finite embeddings")

    def train_batch(b):
        idx = np.nonzero(tbucket == b)[0][:128]
        return pack_batch([train_store.get(int(i)) for i in idx], b, 128).to(dev)

    for b in train_buckets:
        step_parity(ddm0, train_batch(b), targs, b)
    # the symmetric CFConv is differentiable on the card: a gradient flows
    # through cfconv_bwd_sym to x and the filter weights; a second order
    # raises
    _, d256, e256, _, x256 = layer0_inputs(model, first(256, 2), 256)
    d256, e256 = d256.clone(), e256.clone()
    ins = [x256.clone().requires_grad_(True)] + \
        [w.detach().clone().requires_grad_(True) for w in filt_g]
    before = K.cfconv_bwd_sym.launches
    K.cfconv_fused_sym(d256, e256, *ins, 0.0, cutoff, G,
                       True).square().sum().backward()
    torch.cuda.synchronize()
    if K.cfconv_bwd_sym.launches != before + 1 or not all(
            t.grad is not None and torch.isfinite(t.grad).all()
            and t.grad.abs().sum() > 0 for t in ins):
        fail("cfconv_fused_sym under autograd on CUDA: no finite nonzero "
             "gradient through cfconv_bwd_sym")
    print("gradient flows through cfconv_fwd_sym: cfconv_bwd_sym launched, "
          "x and the filter weights get finite nonzero gradients")

    def sym_double_backward():
        xx = x256.clone().requires_grad_(True)
        out = K.cfconv_fused_sym(d256, e256, xx, *filt_g, 0.0, cutoff, G, True)
        (gx,) = torch.autograd.grad(out.square().sum(), xx, create_graph=True)
        gx.sum().backward()

    msg = refuses_grad(sym_double_backward)
    if msg is None:
        fail("a double backward through cfconv_fwd_sym on CUDA did not raise")
    print(f"grad guard cfconv_bwd_sym (second order): {msg}")
    with torch.no_grad():
        stack_w = [t.clone().requires_grad_(True) for t in model.stacked_weights()]
    _, d128, e128, h128, _ = layer0_inputs(model, first(128, 2), 128)
    msg = refuses_grad(lambda: K.schnet_stack(
        d128.clone(), e128.clone(), h128.clone(), stack_w, 0.0, cutoff, G))
    if msg is None:
        fail("schnet_stack under autograd on CUDA did not raise")
    print(f"grad guard schnet_stack: {msg}")

    # -- 3b'. main path: PaiNN-DDM pretraining -----------------------------------------
    out_dir_p = os.path.join(ROOT, "runs", "chip_smoke_painn")
    shutil.rmtree(out_dir_p, ignore_errors=True)
    painn_argv = ["--model_3d", "painn"]
    reset_launch_counts()
    t0 = time.time()
    ddm_p, losses_p = PG.main(train_argv[:-1] + [out_dir_p] + painn_argv)
    torch.cuda.synchronize()
    train_launches_p = launch_counts()
    print(f"main path (PaiNN training): {len(losses_p)} steps of one epoch in "
          f"{time.time() - t0:.2f} s (first call); launches {train_launches_p}")
    for name in ("painn_fwd", "painn_bwd", "ncsn_score_fwd", "ncsn_score_bwd"):
        if train_launches_p[name] == 0:
            fail(f"kernel {name} was not launched on the PaiNN training path")
    if not losses_p or not all(math.isfinite(v) for v in losses_p):
        fail(f"PaiNN training losses {losses_p}")
    print(f"PaiNN training losses: {losses_p}")
    emb_tp = Predictor.from_checkpoint(
        os.path.join(out_dir_p, "model.pth"), cfg_p, batch_size=128,
        bucket_sizes=train_buckets).embed(train_store)
    if emb_tp.shape != (len(train_store), cfg_p.emb_dim) or \
            not np.isfinite(emb_tp).all():
        fail(f"PaiNN Predictor on model.pth: shape {emb_tp.shape} or non-finite")
    print(f"PaiNN model.pth loads into a Predictor: {emb_tp.shape[0]} finite "
          "embeddings")
    targs_p = PG.build_parser().parse_args(painn_argv)
    ddm0_p = PG.make_ddm(targs_p, common.model_config_from_args(targs_p),
                         torch.Generator().manual_seed(SEED)).to(dev)
    for b in train_buckets:
        step_parity(ddm0_p, train_batch(b), targs_p, b, "PaiNN")
    with torch.no_grad():
        stack_wp = [t.clone().requires_grad_(True)
                    for t in model_p.stacked_weights()]
    grids128, q128, _, _ = painn_inputs(model_p, packed(first(128, 2), 128))
    msg = refuses_grad(lambda: P.painn_stack_infer(
        *grids128, q128, stack_wp, cut_p))
    if msg is None:
        fail("painn_stack under autograd on CUDA did not raise")
    print(f"grad guard painn_stack: {msg}")
    x_g = torch.randn(2, 128, 3 * 128, device=dev, requires_grad=True)
    mu_g = torch.randn(2, 128, 3 * 128, device=dev)
    wk_g, bk_g = (t.detach() for t in model_p.filter_weights()[0])

    def double_backward():
        dq, _ = P.painn_message_fused(*grids128, x_g, mu_g, wk_g, bk_g, cut_p)
        (gx,) = torch.autograd.grad(dq.sum(), x_g, create_graph=True)
        gx.sum().backward()

    msg = refuses_grad(double_backward)
    if msg is None:
        fail("a double backward through painn_fwd on CUDA did not raise")
    print(f"grad guard painn_bwd (second order): {msg}")

    # -- 3c. main path: the Atom3D fine-tunes at N=512 --------------------------
    pretrained = os.path.join(out_dir, "model.pth")  # DDM-SchNet, phase 3b
    lba_flags = ["--synthetic", "--synthetic_size", "160"]
    lep_flags = ["--synthetic", "--synthetic_size", "64"]

    def finetune_path(driver, task, flags, kernels, model_3d="schnet",
                      pre=pretrained):
        """driver.main from the pretrained model.pth (launch counts,
        finite losses and metrics), then its model.pth under --eval_only."""
        run_dir = os.path.join(ROOT, "runs", f"chip_smoke_{task}_{model_3d}")
        shutil.rmtree(run_dir, ignore_errors=True)
        reset_launch_counts()
        t0 = time.time()
        _, best, test, losses = driver.main(
            flags + ["--model_3d", model_3d, "--input_model_file", pre,
                     "--output_model_dir", run_dir])
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"main path ({task} fine-tune, {model_3d}): {len(losses)} steps "
              f"in {time.time() - t0:.2f} s (first call); launches {counts}")
        for name in kernels:
            if counts[name] == 0:
                fail(f"kernel {name} was not launched on the {task} path")
        if not losses or not all(math.isfinite(v) for v in losses) or \
                not math.isfinite(best) or \
                not all(math.isfinite(v) for v in test.values()):
            fail(f"{task} {model_3d}: losses {losses}, best val {best}, "
                 f"test {test}")
        print(f"{task} {model_3d} losses: {losses}; best val {best}; test at "
              f"best {test}")
        _, val_e, _, _ = driver.main(
            flags + ["--model_3d", model_3d, "--eval_only",
                     "--input_model_file", os.path.join(run_dir, "model.pth")])
        if not abs(val_e - best) <= RTOL * abs(best):
            fail(f"{task} {model_3d}: model.pth under --eval_only reads val "
                 f"{val_e}, the run's best was {best}")
        print(f"{task} {model_3d}: model.pth reloads under --eval_only (val "
              f"{val_e})")
        return counts

    lba_launches = finetune_path(FL, "lba", lba_flags + ["--epochs", "2"],
                                 ("cfconv_fwd_sym", "cfconv_bwd_sym"))
    finetune_path(FE, "lep", lep_flags + ["--epochs", "1"],
                  ("cfconv_fwd_sym", "cfconv_bwd_sym"))
    # PaiNN at N=512 from the DDM-PaiNN model.pth: painn_fwd/painn_bwd at a
    # shape the DDM path does not give them
    finetune_path(FL, "lba", lba_flags + ["--epochs", "1"],
                  ("painn_fwd", "painn_bwd"), "painn",
                  os.path.join(out_dir_p, "model.pth"))

    # one full-width LBA-SchNet step at N=512 with kernels against the same
    # step with the plain versions (in graph chunks), on a freshly seeded net
    lba_args = FL.build_parser().parse_args(lba_flags)
    lba_batch = next(iter(BucketedLoader(FL.load_splits(lba_args)[0], 64,
                                         (512,), seed=SEED).epoch(1))).to(dev)
    net0 = FL.make_net(lba_args, common.model_config_from_args(lba_args),
                       torch.Generator().manual_seed(SEED)).to(dev)

    def lba_loss(sb, sl):
        return FL.loss_fn(net0, sb)

    loss_k, grads_k = grads_in_chunks(net0, lba_batch, lba_loss)
    net0.plain = True
    loss_p, grads_p = grads_in_chunks(net0, lba_batch, lba_loss, chunk=4)
    net0.plain = False
    check_step_parity("LBA-SchNet step parity bucket 512", loss_k, grads_k,
                      loss_p, grads_p)

    # PaiNN at the same batch (B=64, N=512), a shape the DDM path does not
    # give its kernels: painn_fwd/painn_bwd against their plain versions on
    # block 0's inputs, then one LBA-PaiNN step against the plain step, on a
    # freshly seeded net
    lba_args_p = FL.build_parser().parse_args(lba_flags + ["--model_3d",
                                                           "painn"])
    cfg_lp = common.model_config_from_args(lba_args_p)
    net0_p = FL.make_net(lba_args_p, cfg_lp,
                         torch.Generator().manual_seed(SEED)).to(dev)
    cut_lp = cfg_lp.painn.cutoff
    grids, q0, x, mu = painn_inputs(net0_p.model, lba_batch)
    with torch.no_grad():
        wk0, bk0 = net0_p.model.filter_weights()[0]
        want = chunked(lambda *a: torch.cat(P.painn_message_reference(
            *a, wk0, bk0, cut_lp), dim=-1), (*grids, x, mu), (), 4)
        for sp in (False, True):
            errs.check("painn_fwd", torch.cat(P.painn_message_fused(
                *grids, x, mu, wk0, bk0, cut_lp, sp), dim=-1), want,
                f"LBA B=64 N=512 sparse={sp}")
    gen_l = torch.Generator(dev).manual_seed(SEED)
    gq = torch.randn(q0.shape, generator=gen_l, device=dev)
    gmu = torch.randn(mu.shape, generator=gen_l, device=dev)
    check_painn_bwd(errs, grids, x, mu, wk0, bk0, gq, gmu, cut_lp,
                    "LBA B=64 N=512", chunk=2)

    def lba_loss_p(sb, sl):
        return FL.loss_fn(net0_p, sb)

    loss_k, grads_k = grads_in_chunks(net0_p, lba_batch, lba_loss_p)
    net0_p.plain = True
    loss_p, grads_p = grads_in_chunks(net0_p, lba_batch, lba_loss_p, chunk=2)
    net0_p.plain = False
    check_step_parity("LBA-PaiNN step parity bucket 512", loss_k, grads_k,
                      loss_p, grads_p)

    # -- 4. measurements -----------------------------------------------------------
    subs = {b: MolStore.from_records([sorted_store.get(int(i))
                                      for i in np.nonzero(bucket_of == b)[0]])
            for b in buckets}
    measure_serving(pred, subs, "schnet")
    measure_serving(pred_p, subs, "painn")

    flop_pair = 2 * G * 128 + 2 * 128 * 128 + 2 * 128
    kernels = []
    with torch.inference_mode():
        def serving_batch(m, b):
            """The bucket's first batch as the Predictor packs it."""
            return layer0_inputs(m, first(b, 128), b, batch_size=128)

        # schnet_stack at the N=128 bucket's first batch, padded to 128 slots
        batch, dist, env, h0, _ = serving_batch(model, 128)
        L = stacked[0].shape[0]
        got = K.schnet_stack(dist, env, h0, stacked, 0.0, cutoff, G)
        want = chunked(K.schnet_stack_reference, (dist, env, h0),
                       (stacked, 0.0, cutoff, G), 32)
        errs.check("schnet_stack", got, want, f"serving B={dist.shape[0]} N=128")
        ms = cuda_time_ms(lambda: K.schnet_stack(dist, env, h0, stacked, 0.0,
                                                 cutoff, G))
        plain_ms = cuda_time_ms(lambda: chunked(
            K.schnet_stack_reference, (dist, env, h0), (stacked, 0.0, cutoff, G),
            32), reps=3, warmup=1)
        nnz, filt_pairs, cells = pair_work(dist, env)
        atoms = int(batch.node_mask.sum())
        flops = L * (filt_pairs * (flop_pair - 2 * 128) + nnz * 2 * 128
                     + atoms * 3 * 2 * 128 * 128)
        nbytes = 4 * (2 * cells + 2 * h0.numel()
                      + sum(t.numel() for t in stacked))
        kernels.append(("schnet_stack", "geossl_tpu_torch/ops/csrc/schnet_stack.cu",
                        "geossl_tpu/ops/cfconv_pallas.py:712", ms, plain_ms,
                        flops, nbytes))

        for name, m, fw, fn, b, sym in (
                ("cfconv_fwd", model_mn, filt_mn, K.cfconv_fused, 256, False),
                ("cfconv_fwd_sym", model, filt, K.cfconv_fused_sym, 512, True)):
            batch, dist, env, _, x = serving_batch(m, b)
            got = fn(dist, env, x, *fw, 0.0, cutoff, G, True)
            want = chunked(K.cfconv_fused_reference, (dist, env, x),
                           (*fw, 0.0, cutoff, G), 4)
            errs.check(name, got, want, f"serving B={dist.shape[0]} N={b}")
            ms = cuda_time_ms(lambda: fn(dist, env, x, *fw, 0.0, cutoff, G, True))
            plain_ms = cuda_time_ms(lambda: chunked(
                K.cfconv_fused_reference, (dist, env, x), (*fw, 0.0, cutoff, G),
                4), reps=3, warmup=1)
            nnz, filt_pairs, cells = pair_work(dist, env)
            if sym and cells == dist.numel():
                fail(f"{name}: serving dist/env are not symmetric")
            flops = filt_pairs * (flop_pair - 2 * 128) + nnz * 2 * 128
            nbytes = 4 * (2 * cells + 2 * x.numel()
                          + sum(t.numel() for t in fw))
            kernels.append((name, "geossl_tpu_torch/ops/csrc/cfconv_fwd.cu",
                            "geossl_tpu/ops/cfconv_pallas.py:382" if sym
                            else "geossl_tpu/ops/cfconv_pallas.py:92",
                            ms, plain_ms, flops, nbytes))

    kernels = [(*k, launches[k[0]]) for k in kernels]

    tbatches = [train_batch(b) for b in train_buckets]
    measure_training(ddm, targs, tbatches, "schnet")
    measure_training(ddm_p, targs_p, tbatches, "painn")
    measure_finetune(net0, lba_args, lba_batch, FL.loss_fn, "lba",
                     int(lba_batch.graph_mask.sum()))
    lep_args = FE.build_parser().parse_args(lep_flags)
    lep_batch = next(iter(FE.DualLoader(
        *FE.load_splits(lep_args)["train"], 16, (512,), shuffle=True,
        seed=SEED).epoch(1))).to(dev)
    lep_net = FE.make_net(lep_args, common.model_config_from_args(lep_args),
                          torch.Generator().manual_seed(SEED)).to(dev)
    measure_finetune(lep_net, lep_args, lep_batch, FE.loss_fn, "lep",
                     int(lep_batch.active.graph_mask.sum()))

    # the three training kernels at the DDM shape (B=128, N=128)
    batch = train_batch(128)
    F_, E_, H_ = 128, 128, 64
    with torch.no_grad():
        dist, adj = ddm0.model.geometry(batch.positions, batch.node_mask)
        dist = dist.contiguous()
        env = (cosine_envelope(dist, cutoff) * adj.float()).contiguous()
        blk = ddm0.model.interactions[0]
        x = blk.conv.lin1(ddm0.model.embedding(batch.atom_type)).contiguous()
        fw = blk.filter_weights()
    g = torch.randn(x.shape, generator=torch.Generator(dev).manual_seed(SEED),
                    device=dev)
    check_cfconv_bwd(errs, dist, env, x, g, fw, G, cutoff, "DDM B=128 N=128",
                     chunk=4)
    ms = cuda_time_ms(lambda: K.cfconv_bwd(dist, env, x, g, *fw, 0.0, cutoff,
                                           G, True))
    plain_ms = cuda_time_ms(lambda: chunked_sum(
        K.cfconv_bwd_reference, (dist, env, x, g), (*fw, 0.0, cutoff, G), 4, 3),
        reps=3, warmup=1)
    nnz, filt_pairs, cells = pair_work(dist, env)
    # filter recomputed once per needed pair; dW2, dh (2F^2 each), dW1,
    # drbf (2GF each) and the elementwise qe/denv/dx terms per ordered pair
    flops = filt_pairs * (2 * G * F_ + 2 * F_ * F_) \
        + nnz * (4 * F_ * F_ + 4 * G * F_ + 6 * F_)
    wsize = G * F_ + 2 * F_ + F_ * F_
    nbytes = 4 * (2 * cells + 2 * dist.numel() + 3 * x.numel() + 2 * wsize)
    kernels.append(("cfconv_bwd", "geossl_tpu_torch/ops/csrc/cfconv_bwd.cu",
                    "geossl_tpu/ops/cfconv_pallas.py:150", ms, plain_ms, flops,
                    nbytes, train_launches["cfconv_bwd"]))

    # the symmetric backward at the LBA shape (B=64, N=512, block 0 of a
    # freshly seeded net)
    with torch.no_grad():
        m = net0.model
        dist, adj = m.geometry(lba_batch.positions, lba_batch.node_mask)
        dist = dist.contiguous()
        env = (cosine_envelope(dist, cutoff) * adj.float()).contiguous()
        blk = m.interactions[0]
        x = blk.conv.lin1(m.embedding(lba_batch.atom_type)).contiguous()
        fw = blk.filter_weights()
    g = torch.randn(x.shape, generator=torch.Generator(dev).manual_seed(SEED),
                    device=dev)
    check_cfconv_bwd_sym(errs, dist, env, x, g, fw, G, cutoff,
                         "LBA B=64 N=512", chunk=4)
    ms = cuda_time_ms(lambda: K.cfconv_bwd_sym(dist, env, x, g, *fw, 0.0,
                                               cutoff, G, True))
    plain_ms = cuda_time_ms(lambda: chunked_sum(
        K.cfconv_bwd_sym_reference, (dist, env, x, g), (*fw, 0.0, cutoff, G),
        4, 3), reps=3, warmup=1)
    # the kernel header's claim: all but dx (atomics) repeat bitwise
    again = [K.cfconv_bwd_sym(dist, env, x, g, *fw, 0.0, cutoff, G, True)
             for _ in range(2)]
    print("cfconv_bwd_sym repeats bitwise: " + json.dumps(
        {n: torch.equal(a, b) for n, a, b in zip(BWD_NAMES, *again)}))
    nnz, filt_pairs, cells = pair_work(dist, env)
    if cells == dist.numel():
        fail("cfconv_bwd_sym: the LBA dist/env are not symmetric")
    # per pair with env != 0 counted once (one triangle): the filter, dW2,
    # dh, dW1 and drbf on the combined cotangent; per ordered pair the
    # elementwise q/denv/dx terms
    flops = filt_pairs * (6 * G * F_ + 6 * F_ * F_) + nnz * 6 * F_
    nbytes = 4 * (2 * cells + 2 * dist.numel() + 3 * x.numel() + 2 * wsize)
    kernels.append(("cfconv_bwd_sym", "geossl_tpu_torch/ops/csrc/cfconv_bwd.cu",
                    "geossl_tpu/ops/cfconv_pallas.py:464", ms, plain_ms, flops,
                    nbytes, lba_launches["cfconv_bwd_sym"]))

    grid, weights, anneal = ncsn_inputs(ddm0, batch, targs, SEED)
    g_rows = check_ncsn(errs, grid, weights, anneal, "DDM B=128 N=128", chunk=16)
    sel_pairs = int((grid[2] != 0).sum())
    bsz, n = grid[0].shape[:2]
    head_w = sum(w.numel() for w in weights)
    fwd_pair = 2 * E_ * H_ + 8 * E_ + 2 * H_ + 10
    for name, fn, plain, flops, nbytes, line in (
            ("ncsn_score_fwd",
             lambda: NS.ncsn_score_fwd(*grid, *weights, anneal=anneal),
             lambda: chunked(NS.ncsn_score_loss_reference, grid,
                             (*weights, anneal), 16),
             sel_pairs * fwd_pair,
             4 * (3 * grid[0].numel() + grid[4].numel() + bsz + head_w
                  + bsz * n), 67),
            ("ncsn_score_bwd",
             lambda: NS.ncsn_score_bwd(*grid, g_rows, *weights, anneal=anneal),
             lambda: chunked_sum(
                 lambda *a: NS.ncsn_score_bwd_reference(*a, anneal=anneal),
                 (*grid, g_rows), weights, 16, 1),
             sel_pairs * (fwd_pair + 4 * E_ * H_ + 12 * E_ + 4 * H_),
             4 * (3 * grid[0].numel() + 2 * grid[4].numel() + bsz
                  + bsz * n + 2 * head_w), 135)):
        kernels.append((name, "geossl_tpu_torch/ops/csrc/ncsn_score.cu",
                        f"geossl_tpu/ops/ncsn_pallas.py:{line}",
                        cuda_time_ms(fn), cuda_time_ms(plain, reps=3, warmup=1),
                        flops, nbytes, train_launches[name]))

    # PaiNN: the stack at the N=128 serving bucket's first batch, the message
    # pass and its backward at the DDM shape (B=128 of the N=128 bucket,
    # the clean graph of view 1)
    R_, L_ = cfg_p.painn.n_rbf, cfg_p.painn.n_interactions
    # filter 2R*3F, message sums (dq 2F, dmu 12F), gating 3F
    fwd_pair, fwd_elem = 2 * R_ * 3 * F_, 17 * F_
    with torch.inference_mode():
        batch = packed(first(128, 128), 128, 128)
        grids, q0, _, _ = painn_inputs(model_p, batch)
        got = P.painn_stack_infer(*grids, q0, stacked_p, cut_p)
        want = chunked_sum(lambda *a: P.painn_stack_reference(
            *a, stacked_p, cut_p), (*grids, q0), (), 32, 2)
        for name, a, w in zip(("q", "mu"), got, want):
            errs.check_scaled("painn_stack", a, w,
                              f"serving B={q0.shape[0]} N=128 {name}")
        ms = cuda_time_ms(lambda: P.painn_stack_infer(*grids, q0, stacked_p,
                                                      cut_p))
        plain_ms = cuda_time_ms(lambda: chunked_sum(
            lambda *a: P.painn_stack_reference(*a, stacked_p, cut_p),
            (*grids, q0), (), 32, 2), reps=3, warmup=1)
        nnz, filt_pairs, cells = pair_work(grids[0], grids[1])
        atoms = int(batch.node_mask.sum())
        # per block: x-MLP 8F^2, mixing 12F^2, context MLP 10F^2 per atom
        flops = L_ * (filt_pairs * fwd_pair + nnz * fwd_elem
                      + atoms * 30 * F_ * F_)
        nbytes = 4 * (5 * cells + q0.numel() + 4 * q0.numel()
                      + sum(t.numel() for t in stacked_p))
        kernels.append(("painn_stack", "geossl_tpu_torch/ops/csrc/painn_stack.cu",
                        "geossl_tpu/ops/painn_pallas.py:829", ms, plain_ms,
                        flops, nbytes, launches_p["painn_stack"]))

    batch = train_batch(128)
    m0 = ddm0_p.model
    with torch.no_grad():
        d1, pm = geometry.pairwise_distances(batch.positions, batch.node_mask)
        clean = geometry.radius_adjacency(d1, pm, cut_p)
        wk0, bk0 = m0.filter_weights()[0]
    grids, q0, x, mu = painn_inputs(m0, batch, pair_mask=clean)
    gen_d = torch.Generator(dev).manual_seed(SEED)
    gq = torch.randn(q0.shape, generator=gen_d, device=dev)
    gmu = torch.randn(mu.shape, generator=gen_d, device=dev)
    check_painn_bwd(errs, grids, x, mu, wk0, bk0, gq, gmu, cut_p,
                    "DDM B=128 N=128", chunk=8)
    nnz, filt_pairs, cells = pair_work(grids[0], grids[1])
    f3 = 3 * F_
    with torch.no_grad():
        fwd_args = (*grids, x, mu, wk0, bk0, cut_p, True)
        want = chunked(lambda *a: torch.cat(P.painn_message_reference(
            *a, wk0, bk0, cut_p), dim=-1), (*grids, x, mu), (), 16)
        errs.check("painn_fwd", torch.cat(P.painn_message_fused(*fwd_args),
                                          dim=-1), want, "DDM B=128 N=128")
        for name, fn, plain, flops, nbytes, line in (
                ("painn_fwd", lambda: P.painn_message_fused(*fwd_args),
                 lambda: chunked(lambda *a: torch.cat(
                     P.painn_message_reference(*a, wk0, bk0, cut_p), dim=-1),
                     (*grids, x, mu), (), 16),
                 filt_pairs * fwd_pair + nnz * fwd_elem,
                 4 * (5 * cells + 2 * x.numel() + (R_ + 1) * f3
                      + q0.numel() + mu.numel()), 86),
                # filter recomputed and dWk/dbk once per needed pair (both
                # directions' dwg summed first); dphi = dwg Wk^T, which
                # ddist needs in each direction, and the elementwise D, M,
                # dw, dx, dmu, ddir, dgate terms (~40F) per ordered pair
                ("painn_bwd",
                 lambda: P.painn_bwd(*grids, x, mu, wk0, bk0, gq, gmu, cut_p,
                                     True),
                 lambda: chunked_sum(
                     lambda d, g, a, b_, c, xx, m, gq_, gmu_:
                     P.painn_bwd_reference(d, g, a, b_, c, xx, m, wk0, bk0,
                                           gq_, gmu_, cut_p),
                     (*grids, x, mu, gq, gmu), (), 8, 7),
                 filt_pairs * (2 * R_ * f3 + 2 * (R_ + 1) * f3)
                 + nnz * (2 * R_ * f3 + 40 * F_),
                 4 * (5 * cells + 5 * grids[0].numel() + 4 * x.numel()
                      + q0.numel() + 2 * (R_ + 1) * f3), 164)):
            kernels.append((name, f"geossl_tpu_torch/ops/csrc/{name}.cu",
                            f"geossl_tpu/ops/painn_pallas.py:{line}",
                            cuda_time_ms(fn), cuda_time_ms(plain, reps=3,
                                                           warmup=1),
                            flops, nbytes, train_launches_p[name]))

    table = []
    for name, src, replaces, ms, plain_ms, flops, nbytes, count in kernels:
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        lib, entry = KERNEL_ENTRIES[name]
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": count, "max_abs_err": errs.max_abs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "flop": flops, "bytes": nbytes,
            "ptxas": ptxas_usage(_build.build_log(lib), entry)})
        print(f"kernel {name}: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
              f"{max(t_ops, t_bytes):.3f} ms) at its path's shape")
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
