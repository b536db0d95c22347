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
3. Main path: ``Predictor`` at full SchNet width (F=128, L=6, G=51,
   cutoff 10, batch 128, buckets 32..512) with seeded random weights serves
   a store that spans all five buckets (``predict`` and ``embed``), then a
   ``max_neighbors=32`` Predictor serves it again. Launch counters are reset
   just before and read just after; every kernel must have launched.
   Outputs must be finite, and 8 molecules per bucket are held against the
   plain path on the card.
4. Measurements: mol/s per bucket (steady state, synchronized), then one
   traced pass per bucket (torch.profiler: device busy time, the port's
   kernels' share, idle share), and each kernel's time at the shape the
   main path gives it, beside its plain version's time and its bound (f32
   CUDA-core peak and HBM rate; the pairs with nonzero env, and with
   symmetric dist/env each pair's filter once and the upper triangle read),
   and ptxas's registers and spills per kernel.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

RTOL, ATOL = 1e-4, 1e-5
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SEED = 0


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


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


class Errors:
    """Largest |kernel - plain| seen per kernel, failing on a mismatch."""

    def __init__(self):
        self.max_abs = {}

    def check(self, name, got, want, what):
        import torch

        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{name} {what}: shape {tuple(got.shape)} vs "
                 f"{tuple(want.shape)} or non-finite output")
        err = (got - want).abs().max().item()
        self.max_abs[name] = max(self.max_abs.get(name, 0.0), err)
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"{name} {what}: max_abs_err {err:.3e} beyond rtol {RTOL} "
                 f"atol {ATOL}")
        print(f"parity {name} {what}: max_abs_err {err:.3e}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    try:
        import geossl_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"geossl_tpu_torch is not importable ({e}); run from the repo root")
    import numpy as np

    from geossl_tpu_torch.config import ModelConfig
    from geossl_tpu_torch.data.bucketing import assign_buckets, pack_batch
    from geossl_tpu_torch.data.store import MolStore
    from geossl_tpu_torch.data.synthetic import synthetic_lba, synthetic_molecule3d
    from geossl_tpu_torch.models.common import cosine_envelope
    from geossl_tpu_torch.ops import _build
    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.serve import Predictor
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

    # -- 3. main path -----------------------------------------------------------
    K.reset_launch_counts()
    t0 = time.time()
    preds = pred.predict(store)
    emb = pred.embed(store)
    preds_mn = pred_mn.predict(store)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"main path: {len(store)} molecules x 3 passes in "
          f"{time.time() - t0:.2f} s (first call); launches {launches}")
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the main path")
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

    # -- 4. measurements -----------------------------------------------------------
    subs = {b: MolStore.from_records([sorted_store.get(int(i))
                                      for i in np.nonzero(bucket_of == b)[0]])
            for b in buckets}
    device_profile(lambda: pred.predict(subs[32]))  # profiler start-up
    for b, sub in subs.items():
        pred.predict(sub)  # warm-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred.predict(sub)  # ends in a device-to-host copy: synchronized
            times.append(time.perf_counter() - t0)
        t = sorted(times)[1]
        print("serve: " + json.dumps({"bucket": b, "molecules": len(sub),
                                      "batches": -(-len(sub) // 128),
                                      "s_per_pass": t,
                                      "mol_per_s": len(sub) / t}))
        # a separate traced pass (the profiler slows the host side)
        wall, busy, ours = device_profile(lambda: pred.predict(sub))
        print("profile: " + json.dumps({
            "bucket": b, "traced_wall_s": wall, "device_busy_s": busy,
            "port_kernels_s": ours, "other_device_s": busy - ours,
            "idle_share": 1.0 - busy / wall}))

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

    table = []
    for name, src, replaces, ms, plain_ms, flops, nbytes in kernels:
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        lib, entry = KERNEL_ENTRIES[name]
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs.max_abs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "flop": flops, "bytes": nbytes,
            "ptxas": ptxas_usage(_build.build_log(lib), entry)})
        print(f"kernel {name}: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
              f"{max(t_ops, t_bytes):.3f} ms) at the serving shape")
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
