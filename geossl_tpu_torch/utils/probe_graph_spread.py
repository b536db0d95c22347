"""Where the run-to-run spread of a DDM-SchNet step enters, and how steps
replayed through CUDA graphs compare with eager steps over repeated runs,
on one card.

    env PYTHONPATH=. python geossl_tpu_torch/utils/probe_graph_spread.py [--pairs 5]

1. ``spread_step:`` one DDM-SchNet step at bucket 32 (B=128, full width,
   ``chip_smoke.host_path``), eager, twice from the same weights, batch and
   generator seed: per module, in call order, whether the two forwards'
   outputs agree bitwise (the first module that differs is where the
   spread enters the forward), and per parameter whether the gradients
   agree bitwise and the relative norm of their difference.
2. ``spread_runs:`` ``chip_smoke.graph_parity_path``'s comparison
   repeated: ``--pairs`` pairs of eager runs (Adam made capturable, as
   graph_parity's reference side) and as many pairs of graph-replayed runs
   (``train/common.ChainStep``, HOST_K steps a replay) of 2·HOST_K steps
   from the same weights on the same batches. Per parameter the relative
   norm of eager against eager, graph against graph and graph against
   eager, over every pair; once in one process and once in an NCCL group
   of one rank (the gradient all_reduce in every step, captured in the
   graphs), as ``parallel nccl_graph_parity`` runs it.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

import chip_smoke as CS

NAME = "DDM-SchNet"


def _outputs(out):
    if isinstance(out, torch.Tensor):
        return [out.detach().clone()]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _outputs(o)]
    return []


def spread_step(dev, card):
    net, opt, sched, body, gen, make_loader = CS.host_path(dev, NAME)
    batch = next(iter(make_loader(True).epoch(1))).to(dev)
    init = CS.snapshot(net)
    runs = []
    for _ in range(2):
        net.load_state_dict(init)
        gen.manual_seed(CS.SEED + 11)
        seen = []
        hooks = [m.register_forward_hook(
            lambda m, i, o, name=name: seen.append((name, _outputs(o))))
            for name, m in net.named_modules() if name]
        opt.zero_grad(set_to_none=True)
        body([batch])
        for h in hooks:
            h.remove()
        torch.cuda.synchronize()
        grads = {k: p.grad.detach().clone()
                 for k, p in net.named_parameters() if p.grad is not None}
        runs.append((seen, grads))
    (seen_a, grads_a), (seen_b, grads_b) = runs
    differ = [name for (name, a), (_, b) in zip(seen_a, seen_b)
              if len(a) != len(b) or not all(torch.equal(x, y)
                                             for x, y in zip(a, b))]
    grad_rows = {k: {"bitwise": torch.equal(grads_a[k], grads_b[k]),
                     "rel_norm": CS.rel_norm(grads_b[k], grads_a[k]),
                     "norm": grads_a[k].norm().item()}
                 for k in grads_a}
    print("spread_step: " + json.dumps({
        "path": NAME, "modules_called": len(seen_a),
        "first_module_differing": differ[:1], "modules_differing": differ,
        "grads_bitwise": sorted(k for k, r in grad_rows.items()
                                if r["bitwise"]),
        "grads_differing": {k: r for k, r in grad_rows.items()
                            if not r["bitwise"]},
        "card": card}))


def _run(dev, graphs, batches, init):
    """Final parameters after 2·HOST_K steps from ``init`` (a fresh side)."""
    from geossl_tpu_torch.train import common, optim

    net, opt, sched, body, gen, _ = CS.host_path(dev, NAME)
    net.load_state_dict(init)
    gen.manual_seed(CS.SEED + 11)
    if graphs:
        chain = common.ChainStep(opt, sched, body, dev, [net], gen)
        for s in range(0, len(batches), CS.HOST_K):
            chain(batches[s:s + CS.HOST_K])
    else:
        optim.make_capturable(opt)
        for b in batches:
            common.optimizer_step(opt, sched, body, [b])
    torch.cuda.synchronize()
    return {k: p.detach().clone() for k, p in net.named_parameters()}


def spread_runs(dev, card, pairs, label):
    net, _, _, _, _, make_loader = CS.host_path(dev, NAME)
    init = CS.snapshot(net)
    batches = [b.to(dev) for b in make_loader(True).epoch(1)][:2 * CS.HOST_K]
    eager = [_run(dev, False, batches, init) for _ in range(2 * pairs)]
    graph = [_run(dev, True, batches, init) for _ in range(2 * pairs)]

    def rel(a, b):
        return {k: CS.rel_norm(b[k], a[k]) for k in a}

    sets = {"eager_vs_eager": [rel(eager[2 * i], eager[2 * i + 1])
                               for i in range(pairs)],
            "graph_vs_graph": [rel(graph[2 * i], graph[2 * i + 1])
                               for i in range(pairs)],
            "graph_vs_eager": [rel(e, g) for e in eager for g in graph]}
    worst = {what: max((max(r, key=r.get) for r in rows),
                       key=lambda k: max(r[k] for r in rows))
             for what, rows in sets.items()}
    watch = sorted(set(worst.values()) | {"NCSN_02.b2", "NCSN_01.b2"})
    print("spread_runs: " + json.dumps({
        "path": NAME, "group": label, "pairs": pairs,
        "steps": len(batches), "k": CS.HOST_K,
        "worst": worst,
        "params": {k: {what: sorted(r[k] for r in rows)
                       for what, rows in sets.items()} for k in watch},
        "total_max": {what: max(max(r.values()) for r in rows)
                      for what, rows in sets.items()},
        "card": card}))


def _nccl_rank(rank, port, pairs, card):
    from geossl_tpu_torch.ops import cfconv as K
    from geossl_tpu_torch.parallel import mesh as pmesh
    from geossl_tpu_torch.parallel import multihost

    dev = torch.device("cuda", 0)
    K.plain_precision()
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, device=dev)
    if pmesh.make_mesh(1, dev) is None:
        CS.fail("probe: no NCCL mesh of one rank")
    spread_runs(dev, card, pairs, "nccl_world1")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pairs", type=int, default=5)
    args = p.parse_args(argv)
    from geossl_tpu_torch.ops import _build
    from geossl_tpu_torch.ops import cfconv as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(f"card: {card}")
    _build.build_all()
    K.plain_precision()
    dev = torch.device("cuda")
    spread_step(dev, card)
    spread_runs(dev, card, args.pairs, "one_process")
    CS.spawn(_nccl_rank, 1, CS.free_port(), args.pairs, card)


if __name__ == "__main__":
    main()
