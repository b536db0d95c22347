"""Atom3D LEP fine-tuning: ligand efficacy, binary classification
(counterpart of ``geossl_tpu/train/finetune_lep.py``; reference
``examples/finetune_lep.py``).

Two towers of one SHARED backbone encode the active and the inactive
structure; their pooled representations, concatenated, go through
``Linear(2·emb -> 1)`` with BCE-with-logits (``:34-45,179-206``); ROC-AUC
and PR-AUC on val and test (``:96-99``); ``model.pth`` at the best val
ROC-AUC; batch 16, lr 1e-4 (``submit_finetune_lba_lep_schnet.sh:28-33``).
LEP ships pre-split by protein (train/val/test); the synthetic stand-in is
split at random here. Pairs are bucketed by the larger of their two atom
counts, so both towers of a batch share one padded width: the structures
are capped at 400 atoms, the bucket is 512. On CUDA by default;
``--device cpu`` takes the plain versions. ``--steps_per_call k`` runs k
optimizer steps per call, as one CUDA graph replay on the card
(``common.ChainStep``; both towers' batches are its static slots).

Run: ``python -m geossl_tpu_torch.train.finetune_lep --synthetic --epochs 3``
"""

from __future__ import annotations

import argparse
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geossl_tpu_torch.data.batch import DualMolBatch
from geossl_tpu_torch.data.bucketing import (
    assign_buckets,
    bucket_chunks,
    find_native_packer,
    native_batch,
    pack_batch,
)
from geossl_tpu_torch.data.lep import load_lep
from geossl_tpu_torch.data.splitters import random_split
from geossl_tpu_torch.data.synthetic import synthetic_lep
from geossl_tpu_torch.data.transforms import spatial_sort_store
from geossl_tpu_torch.parallel import mesh as pmesh
from geossl_tpu_torch.parallel.mesh import prefetch
from geossl_tpu_torch.train import common
from geossl_tpu_torch.utils import metrics


class DualLoader:
    """Two MolStores and their labels as DualMolBatch batches (reference
    collate ``dataloaders_LEP.py:6-68``): pairs are bucketed by
    max(active, inactive) atom count, both towers of a batch are packed at
    that bucket's width, and the training order interleaves buckets as
    ``BucketedLoader`` does (``shuffle=False``: store order). Both towers
    pack through the C++ packer (NumPy under ``GEOSSL_NO_NATIVE=1``)."""

    def __init__(self, active, inactive, labels, batch_size, bucket_sizes,
                 shuffle, seed=0):
        if not len(active) == len(inactive) == len(labels):
            raise ValueError("active, inactive and labels differ in length")
        self.active, self.inactive = active, inactive
        self.labels = np.asarray(labels, np.float32)
        self.batch_size = batch_size
        self.shuffle, self.seed = shuffle, seed
        sizes = np.maximum(active.num_atoms(), inactive.num_atoms())
        self._bucket_of = assign_buckets(sizes, sorted(bucket_sizes))
        self._native = find_native_packer()
        if self._native is not None:
            self._flat = [self._native.StoreArrays(s)
                          for s in (active, inactive)]

    def _pack(self, tower: int, chunk, n_max: int):
        if self._native is not None:
            return native_batch(self._native.pack_batch_from_store(
                self._flat[tower], chunk, n_max, self.batch_size))
        store = (self.active, self.inactive)[tower]
        return pack_batch([store.get(int(i)) for i in chunk], n_max,
                          self.batch_size)

    def __len__(self) -> int:
        _, counts = np.unique(self._bucket_of, return_counts=True)
        return int(sum(-(-c // self.batch_size) for c in counts))

    def epoch(self, epoch: int = 0) -> Iterator[DualMolBatch]:
        rng = np.random.default_rng((self.seed, epoch))
        for bucket, chunk in bucket_chunks(self._bucket_of, self.batch_size,
                                           rng, self.shuffle):
            a, b = (self._pack(t, chunk, bucket) for t in (0, 1))
            y = np.zeros((self.batch_size,), np.float32)
            y[:len(chunk)] = self.labels[chunk]
            yield DualMolBatch(active=a, inactive=b, y=torch.from_numpy(y))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    common.add_finetune_args(p)
    p.set_defaults(lr=1e-4, epochs=300, batch_size=16, bucket=[512])
    return p


class LEPNet(nn.Module):
    """The shared backbone and the dual head under the JAX package's names
    (``model``, ``graph_pred_linear``); ``forward(dual)`` -> logits [B]
    of a (global) batch, on a mesh each rank's rows gathered
    (``parallel/mesh.sharded``). ``plain`` runs the plain versions."""

    def __init__(self, model: nn.Module, head: nn.Module, plain: bool = False):
        super().__init__()
        self.model = model
        self.graph_pred_linear = head
        self.plain = plain

    def forward(self, dual: DualMolBatch):
        return pmesh.sharded(self.rows_forward, dual)

    def rows_forward(self, dual: DualMolBatch):
        towers = [self.model(t.atom_type, t.positions, t.node_mask,
                             plain=self.plain)[0]
                  for t in (dual.active, dual.inactive)]
        return self.graph_pred_linear(*towers)


def make_net(args, cfg, generator: torch.Generator) -> LEPNet:
    return LEPNet(common.make_backbone(cfg, generator),
                  common.DualHead(args.emb_dim, generator),
                  plain=not common.use_kernels(args))


def loss_fn(net: LEPNet, dual: DualMolBatch) -> torch.Tensor:
    """BCE with logits, written as the JAX driver's
    ``optax.sigmoid_binary_cross_entropy``."""
    logits = net(dual)
    per = -dual.y * F.logsigmoid(logits) - (1.0 - dual.y) * F.logsigmoid(-logits)
    return common.graph_masked_mean(per, dual.active.graph_mask)


def make_evaluate(device):
    @torch.no_grad()
    def evaluate(net: LEPNet, loader: DualLoader) -> dict:
        scores, trues, masks = [], [], []
        for dual in prefetch(loader.epoch(0), device):
            scores.append(net(dual))
            trues.append(dual.y)
            masks.append(dual.active.graph_mask)
        gm = torch.cat(masks).cpu().numpy()
        s = torch.cat(scores).cpu().numpy()[gm]
        t = torch.cat(trues).cpu().numpy()[gm]
        return {"roc": metrics.roc_auc(t, s), "pr": metrics.pr_auc(t, s)}
    return evaluate


def describe(val: dict, test: dict) -> str:
    return (f"val ROC: {val['roc']:.4f} PR: {val['pr']:.4f}\t"
            f"test ROC: {test['roc']:.4f} PR: {test['pr']:.4f}")


def load_splits(args) -> dict:
    """{split: (active store, inactive store, labels)}, Morton-sorted under
    ``--spatial_sort``."""
    if args.synthetic:
        act, inact, labels = synthetic_lep(
            args.synthetic_size, max_atoms=min(300, common.buckets(args)[-1] - 16))
        splits = {k: (act.select(i), inact.select(i), labels[i])
                  for k, i in zip(("train", "val", "test"),
                                  random_split(len(labels), seed=args.seed))}
    else:
        splits = {k: load_lep(args.data_root, split_dir=k)
                  for k in ("train", "val", "test")}
    if args.spatial_sort == "on":
        splits = {k: (spatial_sort_store(a), spatial_sort_store(b), y)
                  for k, (a, b, y) in splits.items()}
    return splits


def main(argv=None):
    """Fine-tune (or, with ``--eval_only``, evaluate); returns (the net,
    the best val ROC-AUC, the test metrics at the best epoch, every step's
    loss). Under ``--eval_only``: (net, val ROC-AUC, test metrics, []).
    None in a launcher that started the ranks (``common.start_ranks``)."""
    args = build_parser().parse_args(argv)
    common.check_ported_args(args)
    if common.start_ranks(args, argv, "geossl_tpu_torch.train.finetune_lep"):
        return None
    mesh, device = common.setup_platform(args)
    cfg = common.model_config_from_args(args)
    common.check_driver_limits(args, cfg, device)
    splits = load_splits(args)
    net = make_net(args, cfg, torch.Generator().manual_seed(args.seed))
    common.load_input_model(args, net)
    pmesh.put_replicated(mesh, net.to(device))
    bs = common.round_batch_to_mesh(args.batch_size, mesh)
    loaders = [DualLoader(*splits[k], bs, common.buckets(args),
                          shuffle=(k == "train"), seed=args.seed)
               for k in ("train", "val", "test")]
    evaluate = make_evaluate(device)
    if args.eval_only:
        val, test = evaluate(net, loaders[1]), evaluate(net, loaders[2])
        print(f"eval-only\t{describe(val, test)}")
        return net, val["roc"], test, []
    out = common.run_finetune(args, net, loaders, loss_fn, evaluate, "roc",
                              True, describe, device)
    best_test = out["best_test"]
    print(f"best val ROC: {out['best']:.4f} (epoch {out['best_epoch']})\t"
          f"test @ best: ROC {best_test.get('roc', float('nan')):.4f} "
          f"PR {best_test.get('pr', float('nan')):.4f}")
    return net, out["best"], best_test, out["losses"]


if __name__ == "__main__":
    main()
