"""MD17 fine-tuning: energy and force regression (counterpart of
``geossl_tpu/train/finetune_md17.py``; reference ``examples/finetune_md17.py``).

Forces are the negative gradient of the predicted energy with respect to
the positions, taken through the model with ``create_graph=True``
(``finetune_md17.py:46``), so training backpropagates through a gradient: a
double backward. The JAX driver's flags, defaults and behaviour: the loss
``0.05 L1(E) + 0.95 L1(F)`` (``:51``), the energy L1 over the real graphs
and the force L1 over the real atoms' three components; the split
``md17_split`` (shuffled 1000 train / 1000 valid / the rest test); the E and
F MAEs on val and test every epoch, predicted forces with a NaN left out
(``:101-107``); ``model.pth`` at the best val FORCE MAE (``:297-301``) and
``model_final.pth`` at the end; train batch 5, eval batch 128, lr 5e-4,
1000 epochs (``submit_finetune_md17_schnet.sh:9-17``).

MD17's molecules fit bucket 32. On the card every training step runs the
forward kernels and their first-order backward kernels twice per block
(once for the energy term, once inside the force graph's replay) and the
second order as PyTorch autograd over the plain backward: SchNet through
``cfconv_fwd_sym``/``cfconv_bwd_sym`` (the plain-mode pair with
``--max_num_neighbors``), PaiNN (``--model_3d painn``) through
``painn_fwd``/``painn_bwd``. ``--input_model_file`` takes the ``model.pth``
that ``pretrain_geossl`` writes (backbone only) or a fine-tuned one (with
its head); ``--eval_only`` evaluates a fine-tuned one. The net is the LBA
driver's (``LBANet``: the backbone and its head, here predicting the
energy). On CUDA by default; ``--device cpu`` takes the plain versions.
``--steps_per_call k`` runs k optimizer steps per call, as one CUDA graph
replay on the card (``common.ChainStep``: the double backward's small
launches replayed, not dispatched one by one).

Run: ``python -m geossl_tpu_torch.train.finetune_md17 --synthetic --epochs 3``
"""

from __future__ import annotations

import argparse
import os
from dataclasses import replace

import numpy as np
import torch

from geossl_tpu_torch.data.bucketing import BucketedLoader
from geossl_tpu_torch.data.md17 import MD17_TASKS, load_md17
from geossl_tpu_torch.data.splitters import md17_split
from geossl_tpu_torch.parallel import mesh as pmesh
from geossl_tpu_torch.parallel.mesh import prefetch
from geossl_tpu_torch.train import checkpoints, common
from geossl_tpu_torch.train.finetune_lba import LBANet, make_net


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    p.add_argument("--task", default="aspirin", choices=MD17_TASKS)
    p.add_argument("--md17_energy_coeff", type=float, default=0.05)
    p.add_argument("--md17_force_coeff", type=float, default=0.95)
    p.add_argument("--MD17_train_batch_size", type=int, default=5)
    p.add_argument("--eval_batch_size", type=int, default=128)
    p.add_argument("--eval_only", action="store_true",
                   help="skip training: evaluate --input_model_file (a "
                        "fine-tuned checkpoint with its head) on the val and "
                        "test splits and exit")
    p.set_defaults(lr=5e-4, epochs=1000)
    return p


def energy_and_force(net: LBANet, batch, create_graph: bool = False):
    """(E [B], F [B,N,3] = -dE/dpos) of a (global) batch; padded atoms get
    a zero force. ``create_graph`` keeps F differentiable (training's double
    backward). On a mesh each rank computes its rows' and both are
    gathered (``parallel/mesh.sharded``)."""
    def rows(batch):
        pos = batch.positions.detach().requires_grad_(True)
        e = net.rows_forward(replace(batch, positions=pos))
        (grad,) = torch.autograd.grad(e.sum(), pos, create_graph=create_graph)
        return e, -grad
    return pmesh.sharded(rows, batch)


def make_loss_fn(e_coeff: float, f_coeff: float):
    """The JAX driver's loss (``finetune_md17.py:66-78``): the energy L1
    over the real graphs, the force L1 over the real atoms' 3 components."""
    def loss_fn(net: LBANet, batch) -> torch.Tensor:
        e, f = energy_and_force(net, batch, create_graph=True)
        e_loss = common.graph_masked_mean((e - batch.y[:, 0]).abs(),
                                          batch.graph_mask)
        nm = batch.node_mask.to(f.dtype)[..., None]
        f_loss = torch.sum((f - batch.forces).abs() * nm) / torch.clamp(
            3.0 * nm.sum(), min=1.0)
        return e_coeff * e_loss + f_coeff * f_loss
    return loss_fn


def make_evaluate(device):
    """``evaluate(net, loader)`` -> {"e_mae", "f_mae"} over the loader's
    real graphs and atoms (``finetune_md17.py:91-115``), predicted forces
    with a NaN component left out."""
    def evaluate(net: LBANet, loader) -> dict:
        e_err, f_err = [], []
        for batch in prefetch(loader.epoch(0), device):
            e, f = energy_and_force(net, batch)
            gm = batch.graph_mask
            nm = batch.node_mask & gm[:, None]
            f, ft = f.detach()[nm], batch.forces[nm]
            ok = ~torch.isnan(f).any(dim=-1)
            e_err.append(e.detach()[gm] - batch.y[gm, 0])
            f_err.append(f[ok] - ft[ok])
        e_err, f_err = (torch.cat(t).cpu().numpy() for t in (e_err, f_err))
        return {"e_mae": float(np.mean(np.abs(e_err))),
                "f_mae": float(np.mean(np.abs(f_err)))}
    return evaluate


def describe(val: dict, test: dict) -> str:
    return (f"val E/F MAE: {val['e_mae']:.5f}/{val['f_mae']:.5f}\ttest E/F "
            f"MAE: {test['e_mae']:.5f}/{test['f_mae']:.5f}")


def load_splits(args):
    """(train, val, test) stores of ``md17_split``."""
    store = load_md17(args.data_root, args.task, synthetic=args.synthetic,
                      synthetic_size=args.synthetic_size)
    return [store.select(i) for i in md17_split(len(store), seed=args.seed)]


def main(argv=None):
    """Fine-tune (or, with ``--eval_only``, evaluate); returns (the net,
    the best val force MAE, the test (E, F) MAEs at the best epoch, every
    step's loss). Under ``--eval_only``: (net, val F MAE, test (E, F) MAEs,
    []). None in a launcher that started the ranks
    (``common.start_ranks``)."""
    args = build_parser().parse_args(argv)
    common.check_ported_args(args)
    if common.start_ranks(args, argv,
                          "geossl_tpu_torch.train.finetune_md17"):
        return None
    mesh, device = common.setup_platform(args)
    cfg = common.model_config_from_args(args)
    # evaluation takes forces too: the backward kernels run either way
    if common.use_kernels(args):
        common.check_kernel_limits(cfg, device, backward=True)
    splits = load_splits(args)
    net = make_net(args, cfg, torch.Generator().manual_seed(args.seed))
    common.load_input_model(args, net)
    pmesh.put_replicated(mesh, net.to(device))
    buckets = common.buckets(args)
    # every rank gets at least one row (the JAX driver's sizes)
    train_bs = common.round_batch_to_mesh(
        max(args.MD17_train_batch_size, 1 if mesh is None else mesh.size),
        mesh)
    eval_bs = common.round_batch_to_mesh(args.eval_batch_size, mesh)
    loaders = [BucketedLoader(splits[0], train_bs, buckets,
                              seed=args.seed, with_forces=True)]
    loaders += [BucketedLoader(s, eval_bs, buckets,
                               shuffle=False, with_forces=True)
                for s in splits[1:]]
    evaluate = make_evaluate(device)
    if args.eval_only:
        val, test = evaluate(net, loaders[1]), evaluate(net, loaders[2])
        print(f"eval-only ({args.task})\t{describe(val, test)}")
        return net, val["f_mae"], (test["e_mae"], test["f_mae"]), []
    out = common.run_finetune(
        args, net, loaders,
        make_loss_fn(args.md17_energy_coeff, args.md17_force_coeff),
        evaluate, "f_mae", False, describe, device)
    test_at_best = (out["best_test"].get("e_mae", float("nan")),
                    out["best_test"].get("f_mae", float("nan")))
    print(f"best val force MAE: {out['best']:.5f} (epoch "
          f"{out['best_epoch']})\ttest E/F MAE @ best: "
          f"{test_at_best[0]:.5f}/{test_at_best[1]:.5f}")
    if args.output_model_dir:
        checkpoints.save_checkpoint(
            os.path.join(args.output_model_dir, "model_final.pth"),
            common.model_tree(net))
    return net, out["best"], test_at_best, out["losses"]


if __name__ == "__main__":
    main()
