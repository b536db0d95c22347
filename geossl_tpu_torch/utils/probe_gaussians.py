"""Time SchNet's CFConv kernels (#1-#5) at their paths' shapes for a list
of Gaussian counts, on the card, for the tree first on ``PYTHONPATH``.

    env PYTHONPATH=<tree> python geossl_tpu_torch/utils/probe_gaussians.py \\
        --tag T [--g 51 100 300]

Run it by path, with an earlier tree unpacked under ``_local/`` first on
``PYTHONPATH`` to time that tree, in turns with the current one (parent,
change, change, parent) in one call. Prints the card's name and power
limit, then one JSON line per Gaussian count: each kernel's ms (the median
of 3 runs of 10 launches after a warm-up) at the shapes ``chip_smoke.py``
times: #1 at serving's N=256 (the max_neighbors=32 graph) and on the DDM
max_num_neighbors batch (B=128, N=128), #2 on that batch, #3 on the DDM
batch and at serving's N=512, #4 at the LBA shape (B=64, N=512), #5 at
serving's N=128, gating on; ``null`` where the tree's wrapper refuses
the Gaussian count (a tree before any G was taken). Inputs are seeded
synthetic molecules and complexes and seeded full-width weights (F=128, 6
blocks, cutoff 10).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess

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
    from geossl_tpu_torch.train import finetune_lba as FL
    from geossl_tpu_torch.train.common import make_backbone

    p = argparse.ArgumentParser()
    p.add_argument("--tag", required=True)
    p.add_argument("--g", type=int, nargs="+", default=[51])
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

    base = ModelConfig()
    for g in args.g:
        cfg = dataclasses.replace(base, schnet=dataclasses.replace(
            base.schnet, num_gaussians=g))
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
        print("probe_gaussians: " + json.dumps({"tag": args.tag, "G": g,
                                                "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
