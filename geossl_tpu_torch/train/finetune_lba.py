"""Atom3D LBA fine-tuning: binding-affinity (logKd) regression (counterpart
of ``geossl_tpu/train/finetune_lba.py``; reference ``examples/finetune_lba.py``).

The JAX driver's flags, defaults and behaviour: MSE train loss
(``finetune_lba.py:244``) averaged over the real graphs; RMSE, Pearson and
Spearman on val and test every epoch (``:98-101``); ``model.pth`` (the
backbone as ``model``, the head as ``graph_pred_linear``) at the best val
MSE; the random split or the identity-30 split from the downloaded index
files (``splitters.py:361-388``); batch 64, lr 1e-4, 300 epochs
(``submit_finetune_lba_lep_schnet.sh:10-33``). Complexes have up to ~500
atoms, so the bucket is 512: SchNet runs the symmetric CFConv kernels
(``cfconv_fwd_sym``/``cfconv_bwd_sym``), PaiNN (``--model_3d painn``) its
message-pass kernels. ``--input_model_file`` takes the ``model.pth`` that
``pretrain_geossl`` writes (backbone only) or a fine-tuned one (with its
head). On CUDA by default; ``--device cpu`` takes the plain versions.
``--steps_per_call k`` runs k optimizer steps per call, as one CUDA graph
replay on the card (``common.ChainStep``).

Run: ``python -m geossl_tpu_torch.train.finetune_lba --synthetic --epochs 3``
"""

from __future__ import annotations

import argparse
import dataclasses

import torch
from torch import nn

from geossl_tpu_torch.data.bucketing import BucketedLoader
from geossl_tpu_torch.data.lba import load_lba
from geossl_tpu_torch.data.splitters import atom3d_lba_split, random_split
from geossl_tpu_torch.data.synthetic import synthetic_lba
from geossl_tpu_torch.data.transforms import spatial_sort_store
from geossl_tpu_torch.parallel import mesh as pmesh
from geossl_tpu_torch.parallel.mesh import prefetch
from geossl_tpu_torch.parallel.pair_parallel import PAIR_AXIS
from geossl_tpu_torch.train import common
from geossl_tpu_torch.utils import metrics


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    p.add_argument("--LBA_year", type=int, default=2020)
    p.add_argument("--split", default="random",
                   choices=["random", "atom3d_lba_split30"])
    common.add_finetune_args(p)
    p.add_argument("--pair_devices", type=int, default=1,
                   help="shard the [B,N,N] pair grid over this many devices "
                        "per data-parallel replica (pair-grid model "
                        "parallelism, parallel/pair_parallel.py): "
                        "num_devices*pair_devices ranks and bucket %% "
                        "pair_devices == 0; the stripes run the plain-mode "
                        "kernels")
    p.set_defaults(lr=1e-4, epochs=300, batch_size=64, bucket=[512])
    return p


class LBANet(nn.Module):
    """The backbone and its per-backbone head under the JAX package's
    top-level names (``model``, ``graph_pred_linear``); ``forward(batch)``
    -> the predicted logKd [B] of a (global) batch: on a mesh each rank
    predicts its rows (:meth:`rows_forward`) and the predictions are
    gathered (``parallel/mesh.sharded``). ``plain`` runs the plain
    versions."""

    def __init__(self, model: nn.Module, head: nn.Module, plain: bool = False):
        super().__init__()
        self.model = model
        self.graph_pred_linear = head
        self.plain = plain

    def forward(self, batch):
        return pmesh.sharded(self.rows_forward, batch)

    def rows_forward(self, batch):
        graph, _ = self.model(batch.atom_type, batch.positions,
                              batch.node_mask, plain=self.plain)
        return self.graph_pred_linear(graph)


def make_net(args, cfg, generator: torch.Generator) -> LBANet:
    return LBANet(common.make_backbone(cfg, generator),
                  common.make_head(args.model_3d, args.emb_dim, generator),
                  plain=not common.use_kernels(args))


def loss_fn(net: LBANet, batch) -> torch.Tensor:
    per = (net(batch) - batch.y[:, 0]) ** 2  # MSE (finetune_lba.py:244)
    return common.graph_masked_mean(per, batch.graph_mask)


def make_evaluate(device):
    @torch.no_grad()
    def evaluate(net: LBANet, loader) -> dict:
        preds, trues, masks = [], [], []
        for batch in prefetch(loader.epoch(0), device):
            preds.append(net(batch))
            trues.append(batch.y[:, 0])
            masks.append(batch.graph_mask)
        gm = torch.cat(masks).cpu().numpy()
        p = torch.cat(preds).cpu().numpy()[gm]
        t = torch.cat(trues).cpu().numpy()[gm]
        return {"mse": metrics.mse(t, p), "rmse": metrics.rmse(t, p),
                "pearson": metrics.pearson(t, p),
                "spearman": metrics.spearman(t, p)}
    return evaluate


def describe(val: dict, test: dict) -> str:
    return (f"val RMSE: {val['rmse']:.5f} P: {val['pearson']:.4f} "
            f"S: {val['spearman']:.4f}\ttest RMSE: {test['rmse']:.5f}")


def load_splits(args):
    """(train, val, test) stores, Morton-sorted under ``--spatial_sort``."""
    if args.synthetic:
        store = synthetic_lba(args.synthetic_size,
                              max_atoms=min(400, common.buckets(args)[-1] - 16))
    else:
        store = load_lba(args.data_root, year=args.LBA_year)
    if args.spatial_sort == "on":
        store = spatial_sort_store(store)
    if args.split == "atom3d_lba_split30" and not args.synthetic:
        idx = atom3d_lba_split(args.data_root, args.LBA_year)
    else:
        idx = random_split(len(store), seed=args.seed)
    return [store.select(i) for i in idx]


def main(argv=None):
    """Fine-tune (or, with ``--eval_only``, evaluate); returns (the net,
    the best val MSE, the test metrics at the best epoch, every step's
    loss). Under ``--eval_only``: (net, val MSE, test metrics, []). None
    in a launcher that started the ranks (``common.start_ranks``).

    ``--pair_devices K``: a ``(data, pair)`` mesh of ``num_devices`` x K
    ranks, the backbone built with ``pair_axis`` (each rank's message
    passes on its j-stripe of the pair grid)."""
    args = build_parser().parse_args(argv)
    common.check_ported_args(args)
    if args.pair_devices < 1:
        raise ValueError(f"--pair_devices must be >= 1, got "
                         f"{args.pair_devices}")
    for n in common.buckets(args):
        if n % args.pair_devices:
            raise ValueError(
                f"--pair_devices {args.pair_devices}: pair_axis sharding "
                f"needs N % axis_size == 0; got N={n}, axis {PAIR_AXIS!r} "
                f"size {args.pair_devices}")
    if common.start_ranks(args, argv, "geossl_tpu_torch.train.finetune_lba"):
        return None
    mesh, device = common.setup_platform(args)
    cfg = common.model_config_from_args(args)
    if args.pair_devices > 1:
        cfg = dataclasses.replace(cfg, pair_axis=PAIR_AXIS)
    common.check_driver_limits(args, cfg, device)
    splits = load_splits(args)
    net = make_net(args, cfg, torch.Generator().manual_seed(args.seed))
    common.load_input_model(args, net)
    pmesh.put_replicated(mesh, net.to(device))
    bs = common.round_batch_to_mesh(args.batch_size, mesh)
    loaders = [BucketedLoader(s, bs, common.buckets(args),
                              seed=args.seed, shuffle=(i == 0))
               for i, s in enumerate(splits)]
    evaluate = make_evaluate(device)
    if args.eval_only:
        val, test = evaluate(net, loaders[1]), evaluate(net, loaders[2])
        print(f"eval-only\t{describe(val, test)} P: {test['pearson']:.4f} "
              f"S: {test['spearman']:.4f}")
        return net, val["mse"], test, []
    out = common.run_finetune(args, net, loaders, loss_fn, evaluate, "mse",
                              False, describe, device)
    best_test = out["best_test"]
    print(f"best val MSE: {out['best']:.5f} (epoch {out['best_epoch']})\t"
          f"test @ best: RMSE {best_test.get('rmse', float('nan')):.5f} "
          f"Pearson {best_test.get('pearson', float('nan')):.4f} "
          f"Spearman {best_test.get('spearman', float('nan')):.4f}")
    return net, out["best"], best_test, out["losses"]


if __name__ == "__main__":
    main()
