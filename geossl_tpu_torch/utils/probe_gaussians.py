"""Time SchNet's CFConv kernels (#1-#5) and the DDM head's kernels (#6/#7)
at their paths' shapes for lists of Gaussian counts and widths (emb_dim =
num_filters), or with ``--model_3d painn`` PaiNN's kernels (#8-#12) for
lists of RBF counts and widths (emb_dim = n_atom_basis), on the card, for
the tree first on ``PYTHONPATH``.

    env PYTHONPATH=<tree> python geossl_tpu_torch/utils/probe_gaussians.py \\
        --tag T [--g 51 100 300] [--width 128 256 96]
    env PYTHONPATH=<tree> python geossl_tpu_torch/utils/probe_gaussians.py \\
        --tag T --model_3d painn [--rbf 20 64] [--width 128 256 96]

Run it by path, with an earlier tree unpacked under ``_local/`` first on
``PYTHONPATH`` to time that tree, in turns with the current one (parent,
change, change, parent) in one call. Prints the card's name and power
limit, then one JSON line per (Gaussian count, width): each kernel's ms
(the median of 3 runs of 10 launches after a warm-up) at the shapes
``chip_smoke.py`` times: #1 at serving's N=256 (the max_neighbors=32 graph)
and on the DDM max_num_neighbors batch (B=128, N=128), #2 on that batch,
#3 on the DDM batch and at serving's N=512, #4 at the LBA shape (B=64,
N=512), #5 at serving's N=128, gating on; #6/#7 on the DDM batch of bucket
128 (a seeded DDM's view-1 head inputs, ``chip_smoke.ncsn_inputs``'
recipe); ``null`` where the tree's wrapper refuses the setting (a tree
before any G or width was taken). Beside them ``host_us``: the host
microseconds per call of #1 and #3 on one graph of 32 atoms, issued back
to back (the wrapper's own cost: a device time of a few microseconds), the
median of 5 rounds of 400; and ``tile_list``: of #3's device time
on the DDM batch (above F = 128 its k^2 launches, each making its own
device tile list), the ``worklist.cuh`` kernels' ms, all of the port's
kernels' ms and the worklist launches, from one call traced after a
warm-up. Inputs are seeded synthetic molecules and complexes and seeded
weights (6 blocks, cutoff 10).

PaiNN (3 blocks, cutoff 5): #8 and #9 on the DDM batch (B=128, N=128,
the clean graph, gating on), #10 and #11 at the LBA shape (B=64, N=512),
#12 at serving's N=32 and N=128, block 0's inputs of a seeded model (x
from its x-MLP, a seeded mu of unit scale, seeded cotangents), each the
median of 3 runs of 10 launches; ``host_us``: #8 on one graph of 32 atoms.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import statistics
import subprocess
import time

import numpy as np
import torch

SEED = 0


def _ms(fn, reps=10):
    try:
        fn()
    except ValueError:  # the wrapper refuses this G
        return None
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return statistics.median(runs)


def _host_us(fn, rounds=5, reps=400):
    """Host microseconds per call of fn issued back to back, the median of
    ``rounds`` rounds of ``reps`` calls (``None`` where the wrapper
    refuses)."""
    try:
        fn()
    except ValueError:
        return None
    for _ in range(20):
        fn()
    runs = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        runs.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return statistics.median(runs)


# the worklist.cuh kernels that make a launch's device tile list
TILE_LIST_KERNELS = ("tile_occ_kernel", "row_occ_kernel", "tile_scan_kernel",
                     "tile_list_kernel")


def _tile_list(fn):
    """{"ms", "of_ms", "launches"}: the worklist kernels' device ms, all the
    port's kernels' device ms and the worklist launches in one call of fn
    traced after a warm-up (``None`` where the wrapper refuses)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        fn()
    except ValueError:
        return None
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ours = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
            and not ev.is_user_annotation and "geossl::" in ev.name]
    mine = [ev for ev in ours if any(k in ev.name for k in TILE_LIST_KERNELS)]
    return {"ms": sum(ev.time_range.elapsed_us() for ev in mine) * 1e-3,
            "of_ms": sum(ev.time_range.elapsed_us() for ev in ours) * 1e-3,
            "launches": len(mine)}


def _head_inputs(ddm, batch, targs):
    """(dist of the perturbed view, noise, sel, sigma, u), the ten head
    weights and the anneal power of NCSN_01 on ``batch``."""
    from geossl_tpu_torch.ops import geometry
    from geossl_tpu_torch.train.pretrain_geossl import batch_views

    gen = torch.Generator(batch.positions.device).manual_seed(SEED)
    pos2, sel = batch_views(targs, batch, gen)
    head = ddm.NCSN_01
    with torch.no_grad():
        _, h1 = ddm.model(batch.atom_type, batch.positions, batch.node_mask)
        u = head.out0_h(h1).contiguous()
    d2, _ = geometry.pairwise_distances(pos2, batch.node_mask)
    level = torch.randint(0, head.num_noise_level, (d2.shape[0],),
                          generator=gen, device=d2.device)
    noise = torch.randn(d2.shape, generator=gen, device=d2.device)
    weights = [w.detach() for w in head.head_weights()]
    return ((d2.contiguous(), noise, sel.float(), head.sigmas[level], u),
            weights, head.anneal_power)


@torch.no_grad()
def _inputs(model, batch):
    dist, adj = model.geometry(batch.positions, batch.node_mask)
    env = model.envelope(dist, adj).contiguous()
    h0 = model.embedding(batch.atom_type).contiguous()
    x = model.interactions[0].conv.lin1(h0).contiguous()
    return dist.contiguous(), env, h0, x


def main(argv=None):
    from geossl_tpu_torch.config import ModelConfig
    from geossl_tpu_torch.data.bucketing import (
        BucketedLoader,
        assign_buckets,
        pack_batch,
    )
    from geossl_tpu_torch.data.molecule3d import load_molecule3d
    from geossl_tpu_torch.data.store import MolStore
    from geossl_tpu_torch.data.synthetic import (
        synthetic_lba,
        synthetic_molecule3d,
    )
    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.ops import ncsn as NS
    from geossl_tpu_torch.train import finetune_lba as FL
    from geossl_tpu_torch.train import pretrain_geossl as PG
    from geossl_tpu_torch.train.common import make_backbone

    p = argparse.ArgumentParser()
    p.add_argument("--tag", required=True)
    p.add_argument("--g", type=int, nargs="+", default=[51])
    p.add_argument("--width", type=int, nargs="+", default=[128])
    p.add_argument("--model_3d", choices=("schnet", "painn"),
                   default="schnet")
    p.add_argument("--rbf", type=int, nargs="+", default=[20],
                   help="PaiNN's RBF counts (--model_3d painn)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_gaussians times the card's kernels: no card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")
    K.plain_precision()
    dev = torch.device("cuda")

    # chip_smoke.py's serving store: 512 molecules and 32 complexes
    mols = synthetic_molecule3d(512, seed=1, max_atoms=100)
    lba = synthetic_lba(32, seed=2, max_atoms=400)
    records = [mols.get(i) for i in range(len(mols))] + \
        [lba.get(i) for i in range(len(lba))]
    for r in records:
        r.y = None  # the two stores label differently
    store = MolStore.from_records(records)
    bucket = assign_buckets(store.num_atoms(), (32, 64, 128, 256, 512))

    def serving(b):
        idx = np.nonzero(bucket == b)[0][:128]
        return pack_batch([store.get(int(i)) for i in idx], b, 128).to(dev)

    train = load_molecule3d("", synthetic=True, synthetic_size=1024,
                            synthetic_max_atoms=100)
    tb = assign_buckets(train.num_atoms(), (32, 64, 128))
    ddm = pack_batch([train.get(int(i)) for i in np.nonzero(tb == 128)[0][:128]],
                     128, 128).to(dev)
    lba_args = FL.build_parser().parse_args(["--synthetic", "--synthetic_size",
                                             "160"])
    lba_batch = next(iter(BucketedLoader(FL.load_splits(lba_args)[0], 64,
                                         (512,), seed=SEED).epoch(1))).to(dev)

    if args.model_3d == "painn":
        _painn(args, store, serving, ddm, lba_batch, dev)
        return
    base = ModelConfig()
    for g, w in itertools.product(args.g, args.width):
        cfg = dataclasses.replace(base, emb_dim=w, schnet=dataclasses.replace(
            base.schnet, num_gaussians=g, hidden_channels=w, num_filters=w))
        sym = make_backbone(cfg, torch.Generator().manual_seed(SEED)).to(dev)
        mn = make_backbone(dataclasses.replace(cfg, max_neighbors=32),
                           torch.Generator().manual_seed(SEED)).to(dev)
        with torch.no_grad():
            fw = [t.contiguous() for t in sym.interactions[0].filter_weights()]
            stacked = sym.stacked_weights()
        a = (0.0, cfg.schnet.cutoff, g)
        gen = torch.Generator(dev).manual_seed(SEED)
        ms = {}
        with torch.no_grad():
            d, e, _, x = _inputs(mn, serving(256))
            ms["cfconv_fwd serving N=256"] = _ms(
                lambda: K.cfconv_fused(d, e, x, *fw, *a, True))
            d, e, _, x = _inputs(mn, ddm)
            ct = torch.randn(x.shape, generator=gen, device=dev)
            ms["cfconv_fwd DDM mn N=128"] = _ms(
                lambda: K.cfconv_fused(d, e, x, *fw, *a, True))
        ms["cfconv_bwd DDM mn N=128"] = _ms(
            lambda: K.cfconv_bwd(d, e, x, ct, *fw, *a, True))
        with torch.no_grad():
            d, e, _, x = _inputs(sym, ddm)
            ms["cfconv_fwd_sym DDM N=128"] = _ms(
                lambda: K.cfconv_fused_sym(d, e, x, *fw, *a, True))
            tile = _tile_list(lambda: K.cfconv_fused_sym(d, e, x, *fw, *a,
                                                         True))
            d, e, _, x = _inputs(sym, serving(512))
            ms["cfconv_fwd_sym serving N=512"] = _ms(
                lambda: K.cfconv_fused_sym(d, e, x, *fw, *a, True))
            d, e, _, x = _inputs(sym, lba_batch)
            ct = torch.randn(x.shape, generator=gen, device=dev)
        ms["cfconv_bwd_sym LBA N=512"] = _ms(
            lambda: K.cfconv_bwd_sym(d, e, x, ct, *fw, *a, True))
        with torch.no_grad():
            d, e, h0, _ = _inputs(sym, serving(128))
            ms["schnet_stack serving N=128"] = _ms(
                lambda: K.schnet_stack(d, e, h0, stacked, *a, True))
        host = {}
        with torch.no_grad():
            one = pack_batch([store.get(int(np.nonzero(bucket == 32)[0][0]))],
                             32, 1).to(dev)
            d, e, _, x = _inputs(sym, one)
            host["cfconv_fwd B=1 N=32"] = _host_us(
                lambda: K.cfconv_fused(d, e, x, *fw, *a, False))
            host["cfconv_fwd_sym B=1 N=32"] = _host_us(
                lambda: K.cfconv_fused_sym(d, e, x, *fw, *a, False))
        targs = PG.build_parser().parse_args([
            "--emb_dim", str(w), "--num_filters", str(w), "--num_gaussians",
            str(g)])
        head = PG.make_ddm(targs, cfg, torch.Generator().manual_seed(SEED)).to(dev)
        grid, weights, anneal = _head_inputs(head, ddm, targs)
        g_rows = torch.randn(grid[0].shape[:2], generator=gen, device=dev)
        ms["ncsn_score_fwd DDM N=128"] = _ms(
            lambda: NS.ncsn_score_fwd(*grid, *weights, anneal=anneal))
        ms["ncsn_score_bwd DDM N=128"] = _ms(
            lambda: NS.ncsn_score_bwd(*grid, g_rows, *weights, anneal=anneal))
        print("probe_gaussians: " + json.dumps({
            "tag": args.tag, "G": g, "width": w, "ms": ms, "host_us": host,
            "tile_list": tile}), flush=True)

@torch.no_grad()
def _painn_inputs(model, batch, pair_mask=None):
    """The five pair grids, q0, block 0's x and a seeded mu of unit scale
    (``chip_smoke.painn_inputs``' recipe)."""
    dist, direction, gate = model.geometry(batch.positions, batch.node_mask,
                                           pair_mask)
    q0 = model.embed(batch.atom_type).contiguous()
    x = model.interactions[0].interatomic_context_net(q0).contiguous()
    gen = torch.Generator(x.device).manual_seed(SEED)
    mu = torch.randn(x.shape, generator=gen, device=x.device)
    grids = (dist.contiguous(), gate.contiguous(),
             *(direction[..., c].contiguous() for c in range(3)))
    return grids, q0, x, mu


def _painn(args, store, serving, ddm, lba_batch, dev):
    """PaiNN's kernels #8-#12 per (RBF count, width): one JSON line each."""
    from geossl_tpu_torch.config import ModelConfig
    from geossl_tpu_torch.data.bucketing import assign_buckets, pack_batch
    from geossl_tpu_torch.ops import geometry
    from geossl_tpu_torch.ops import painn as P
    from geossl_tpu_torch.train.common import make_backbone

    base = ModelConfig(model_3d="painn")
    bucket = assign_buckets(store.num_atoms(), (32, 64, 128, 256, 512))
    for r, w in itertools.product(args.rbf, args.width):
        cfg = dataclasses.replace(base, emb_dim=w, painn=dataclasses.replace(
            base.painn, n_atom_basis=w, n_rbf=r))
        m = make_backbone(cfg, torch.Generator().manual_seed(SEED)).to(dev)
        cut = cfg.painn.cutoff
        gen = torch.Generator(dev).manual_seed(SEED)
        with torch.no_grad():
            wk, bk = (t.contiguous() for t in m.filter_weights()[0])
            stacked = [t.contiguous() for t in m.stacked_weights()]
            d1, pm = geometry.pairwise_distances(ddm.positions, ddm.node_mask)
            clean = geometry.radius_adjacency(d1, pm, cut)
        ms = {}
        grids, q0, x, mu = _painn_inputs(m, ddm, clean)
        gq = torch.randn(q0.shape, generator=gen, device=dev)
        gmu = torch.randn(mu.shape, generator=gen, device=dev)
        with torch.no_grad():
            ms["painn_fwd DDM N=128"] = _ms(lambda: P.painn_message_fused(
                *grids, x, mu, wk, bk, cut, True))
            ms["painn_bwd DDM N=128"] = _ms(lambda: P.painn_bwd(
                *grids, x, mu, wk, bk, gq, gmu, cut, True))
            grids, q0, x, mu = _painn_inputs(m, lba_batch)
            gq = torch.randn(q0.shape, generator=gen, device=dev)
            gmu = torch.randn(mu.shape, generator=gen, device=dev)
            ms["painn_fwd_sym LBA N=512"] = _ms(
                lambda: P.painn_message_fused_sym(*grids, x, mu, wk, bk, cut,
                                                  True))
            ms["painn_bwd_sym LBA N=512"] = _ms(lambda: P.painn_bwd_sym(
                *grids, x, mu, wk, bk, gq, gmu, cut, True))
            for n in (32, 128):
                grids, q0, _, _ = _painn_inputs(m, serving(n))
                ms[f"painn_stack serving N={n}"] = _ms(
                    lambda: P.painn_stack_infer(*grids, q0, stacked, cut))
            one = pack_batch([store.get(int(np.nonzero(bucket == 32)[0][0]))],
                             32, 1).to(dev)
            grids, _, x, mu = _painn_inputs(m, one)
            host = {"painn_fwd B=1 N=32": _host_us(
                lambda: P.painn_message_fused(*grids, x, mu, wk, bk, cut,
                                              False))}
        print("probe_gaussians: " + json.dumps({
            "tag": args.tag, "model_3d": "painn", "R": r, "width": w,
            "ms": ms, "host_us": host}), flush=True)


if __name__ == "__main__":
    main()
