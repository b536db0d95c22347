"""The baseline SSL pretraining objectives: supervised, charge, distance,
torsion, InfoGraph and ContextPred (counterpart of
``geossl_tpu/train/pretrain_baselines.py``; reference
``examples/pretrain_{Supervised,ChargePrediction,DistancePrediction,
TorsionAnglePrediction,3DInfoGraph}.py``; ``contextpred`` is the JAX
package's reconstruction of the reference's ``util.py:79-119``).

One CLI, ``pretrain_baselines <objective> [flags]``, with the JAX parser's
per-objective flags and defaults. Per step, on the clean geometry (no atom
masking, as the JAX driver):

* **supervised**: ``LinearHead`` on the graph representation (both
  backbones), MAE or MSE against the z-normalised ``y[:, task_id]``.
* **charge**: exactly ``int(M·ratio)`` real atoms of the batch masked to the
  unknown token ``NODE_CLASS - 1`` before encoding, cross entropy on them.
* **distance**: L1 between a Linear(2·emb -> 1) on [h_i, h_j] and d_ij over
  every ordered pair (``--distance_sample_ratio`` subsamples them).
* **torsion**: MSE between a Linear(3·emb -> 1) on atom triples and their
  bond angle, ``max(8, int(n_max³·ratio))`` triples per graph.
* **infograph**: the bilinear node-vs-graph discriminator.
* **contextpred**: two backbones, ``model`` on the substructure ball around
  a random centre atom and ``context_model`` on the context ring, each
  called with that holed node mask; only ``model`` is saved.

Each saves ``{"model": state_dict}`` as ``model.pth`` at the best epoch-mean
loss and ``model_final.pth`` at the end, the checkpoint ``serve.Predictor``
and the fine-tunes' ``--input_model_file`` load. On CUDA (the default) the
backbone runs the port's kernels; ``--device cpu`` the plain versions.
``--steps_per_call k`` runs k steps per call (``common.ChainStep``: one CUDA
graph replay on the card, every objective's draw from the epoch's device
generator inside it; eager steps on the CPU), as the JAX driver's
``chain_step``. ``--profile_dir`` is refused, as in every driver but
pretrain_geossl.

Run: ``python -m geossl_tpu_torch.train.pretrain_baselines charge --synthetic --epochs 2``
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch
from torch import nn

from geossl_tpu_torch.data.bucketing import BucketedLoader
from geossl_tpu_torch.data.molecule3d import load_molecule3d
from geossl_tpu_torch.objectives.contextpred import (
    context_masks,
    contextpred_loss,
    hop_distances,
    sample_centers,
)
from geossl_tpu_torch.objectives.heads import (
    ChargePredictor,
    DistancePredictor,
    TorsionAnglePredictor,
    charge_loss,
    charge_masking,
    distance_loss,
    torsion_loss,
    torsion_triples,
)
from geossl_tpu_torch.objectives.infograph import (
    InfoGraphDiscriminator,
    infograph_loss,
)
from geossl_tpu_torch.objectives.pairs import pair_selection
from geossl_tpu_torch.ops import geometry
from geossl_tpu_torch.parallel import mesh as pmesh
from geossl_tpu_torch.train import common

NODE_CLASS = 9
OBJECTIVES = ("supervised", "charge", "distance", "torsion", "infograph",
              "contextpred")


def build_parser(objective: str):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    p.add_argument("--dataset", default="Molecule3D_1000000")
    if objective == "charge":
        p.add_argument("--charge_masking_ratio", type=float, default=0.3)
    if objective == "distance":
        p.add_argument("--distance_sample_ratio", type=float, default=1.0)
    if objective == "torsion":
        p.add_argument("--torsion_angle_sample_ratio", type=float,
                       default=0.001)
    if objective == "supervised":
        p.add_argument("--task_id", type=int, default=6)
        p.add_argument("--loss", default="mae", choices=["mae", "mse"])
    if objective == "contextpred":
        p.add_argument("--contextpred_neg_samples", type=int, default=1)
        p.add_argument("--context_hops", type=int, default=5,
                       help="substruct ball radius K (hops)")
        p.add_argument("--context_csize", type=int, default=3,
                       help="ring width: context spans K-1 .. K-1+csize")
        p.add_argument("--context_bond_cutoff", type=float, default=1.8,
                       help="radius (Å) of the hop graph: the covalent-bond "
                            "scale stands in for the reference's 2D bond "
                            "graph")
    return p


class Baseline(nn.Module):
    """One baseline objective: the backbone ``model`` and the objective's
    ``head`` (``context_model`` for contextpred), the JAX package's
    top-level parameter names. ``forward(batch, generator=None, draw=None)``
    -> (loss, accuracy); ``draw`` replaces the objective's one random draw
    from ``generator``: charge's uniforms [B, N], distance's [B, N, N] (with
    ``distance_sample_ratio < 1``), torsion's [B, T, 3], contextpred's centre
    indices [B]. ``plain`` runs the plain versions on any device."""

    def __init__(self, objective: str, model: nn.Module,
                 head: Optional[nn.Module] = None,
                 context_model: Optional[nn.Module] = None,
                 plain: bool = False, **hparams):
        super().__init__()
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}")
        self.objective = objective
        self.model = model
        if head is not None:
            self.head = head
        if context_model is not None:
            self.context_model = context_model
        self.plain = plain
        self.hparams = hparams

    def encode(self, model, atom_type, batch, node_mask=None):
        """``model`` on the (global) batch; on a mesh each rank encodes its
        rows and the representations are gathered, so that every objective
        sees the whole batch (``parallel/mesh.sharded``)."""
        node_mask = batch.node_mask if node_mask is None else node_mask
        return pmesh.sharded(
            lambda z, pos, m: model(z, pos, m, plain=self.plain),
            atom_type, batch.positions, node_mask)

    def forward(self, batch, generator: Optional[torch.Generator] = None,
                draw: Optional[torch.Tensor] = None):
        hp, z = self.hparams, batch.atom_type
        zero = torch.zeros((), device=z.device)
        if self.objective == "charge":
            # mask atoms to the unknown token before encoding
            # (pretrain_ChargePrediction.py:64-81)
            masked, sel = charge_masking(generator, z, batch.node_mask,
                                         hp["charge_masking_ratio"],
                                         NODE_CLASS, u=draw)
            _, node = self.encode(self.model, masked, batch)
            return charge_loss(self.head(node), z, sel)
        if self.objective == "distance":
            _, node = self.encode(self.model, z, batch)
            dist, _ = geometry.pairwise_distances(batch.positions,
                                                  batch.node_mask)
            ratio = hp["distance_sample_ratio"]
            sel = pair_selection(batch.node_mask, "permutation", ratio,
                                 generator if ratio < 1 else None, u=draw)
            return distance_loss(self.head(node), dist, sel), zero
        if self.objective == "torsion":
            _, node = self.encode(self.model, z, batch)
            idx, angle, valid = torsion_triples(
                generator, batch.positions, batch.node_mask,
                hp["num_triples"], r=draw)
            return torsion_loss(self.head(node, idx), angle, valid), zero
        if self.objective == "infograph":
            graph, node = self.encode(self.model, z, batch)
            return infograph_loss(self.head, node, graph, batch.node_mask,
                                  batch.graph_mask)
        if self.objective == "contextpred":
            return self._contextpred(batch, generator, draw)
        graph, _ = self.encode(self.model, z, batch)
        y = (batch.y[:, hp["task_id"]] - hp["train_mean"]) / hp["train_std"]
        err = self.head(graph) - y.to(graph.dtype)
        per = err.abs() if hp["loss"] == "mae" else err ** 2
        return common.graph_masked_mean(per, batch.graph_mask), zero

    def _contextpred(self, batch, generator, draw):
        hp, z, mask = self.hparams, batch.atom_type, batch.node_mask
        k = hp["context_hops"]
        l1, l2 = k - 1, k - 1 + hp["context_csize"]
        dist, pm = geometry.pairwise_distances(batch.positions, mask)
        bond_adj = geometry.radius_adjacency(dist, pm,
                                             hp["context_bond_cutoff"])
        centers = sample_centers(generator, mask, index=draw)
        hops = hop_distances(bond_adj, centers, l2)
        sub_mask, ctx_mask, ov_mask = context_masks(hops, mask, k, l1, l2)
        # each backbone on its holed node mask: a ball, and a ring
        _, sub_node = self.encode(self.model, z, batch, sub_mask)
        _, ctx_node = self.encode(self.context_model, z, batch, ctx_mask)
        substruct = torch.sum(sub_node * centers[..., None].to(sub_node.dtype),
                              dim=1)
        ov = ov_mask.to(ctx_node.dtype)
        context = torch.sum(ctx_node * ov[..., None], dim=1) / torch.clamp(
            ov.sum(-1, keepdim=True), min=1.0)
        valid = batch.graph_mask & (ov_mask.sum(-1) > 0)
        return contextpred_loss(substruct, context, valid,
                                hp["contextpred_neg_samples"])


def label_stats(store, task_id: int):
    """(mean, std) of ``store.y[:, task_id]`` in the JAX driver's float32
    arithmetic; a column with no variance is refused."""
    y = store.y[:, task_id]
    mean, std = float(y.mean()), float(y.std())
    if not np.isfinite(std) or std < 1e-12:
        raise ValueError(
            f"property column task_id={task_id} has no variance over this "
            f"corpus (std={std}); z-normalization would divide by zero — "
            "pick a different --task_id")
    return mean, std


def make_baseline(objective: str, args, cfg, store, n_max: int,
                  generator: torch.Generator) -> Baseline:
    """The backbone and the objective's head (or second backbone), drawn
    from ``generator`` in that order, and the objective's hyperparameters
    (``store``: supervised's label statistics; ``n_max``: the largest
    bucket, torsion's triple count)."""
    model = common.make_backbone(cfg, generator)
    emb = args.emb_dim
    head = context_model = None
    hp = {}
    if objective == "charge":
        head = ChargePredictor(emb, NODE_CLASS, generator)
        hp["charge_masking_ratio"] = args.charge_masking_ratio
    elif objective == "distance":
        head = DistancePredictor(emb, generator)
        hp["distance_sample_ratio"] = args.distance_sample_ratio
    elif objective == "torsion":
        head = TorsionAnglePredictor(emb, generator)
        hp["num_triples"] = max(8, int(n_max ** 3
                                       * args.torsion_angle_sample_ratio))
    elif objective == "infograph":
        head = InfoGraphDiscriminator(emb, generator)
    elif objective == "contextpred":
        context_model = common.make_backbone(cfg, generator)
        hp.update(context_hops=args.context_hops,
                  context_csize=args.context_csize,
                  context_bond_cutoff=args.context_bond_cutoff,
                  contextpred_neg_samples=args.contextpred_neg_samples)
    else:
        # LinearHead for both backbones, as the JAX driver (not make_head)
        head = common.LinearHead(emb, generator)
        mean, std = label_stats(store, args.task_id)
        print(f"Train mean: {mean}\tTrain std: {std}")
        hp.update(task_id=args.task_id, loss=args.loss, train_mean=mean,
                  train_std=std)
    return Baseline(objective, model, head, context_model,
                    plain=not common.use_kernels(args), **hp)


def run(objective: str, args):
    """Train; returns (the Baseline module, every step's loss as floats).
    ``args`` come from a rank (or one process): ``main`` starts the
    ranks."""
    mesh, device = common.setup_platform(args)
    cfg = common.model_config_from_args(args)
    common.check_driver_limits(args, cfg, device)
    subset = None
    if args.dataset.startswith("Molecule3D_"):
        subset = int(args.dataset.split("_")[-1])
    store = load_molecule3d(args.data_root, subset=subset,
                            synthetic=args.synthetic,
                            synthetic_size=args.synthetic_size,
                            synthetic_max_atoms=args.synthetic_max_atoms)
    buckets = common.buckets(args)
    net = make_baseline(objective, args, cfg, store, buckets[-1],
                        torch.Generator().manual_seed(args.seed))
    if args.input_model_file:
        from geossl_tpu_torch.utils.torch_import import load_model_state

        net.model.load_state_dict(
            load_model_state(args.input_model_file, cfg)["model"])
    pmesh.put_replicated(mesh, net.to(device))
    loader = BucketedLoader(store, common.round_batch_to_mesh(
        args.batch_size, mesh), buckets, seed=args.seed)
    opt, sched = common.make_optimizer_from_args(
        args, net.parameters(),
        common.opt_steps_per_epoch(len(loader), args.grad_accum))
    history = common.run_pretrain(args, net, objective, opt, sched, loader,
                                  lambda b, g: net(b, g), device)
    return net, history


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in OBJECTIVES:
        raise SystemExit(
            "usage: python -m geossl_tpu_torch.train.pretrain_baselines "
            f"{{{','.join(OBJECTIVES)}}} [options]")
    objective = argv[0]
    args = build_parser(objective).parse_args(argv[1:])
    common.check_ported_args(args)
    if common.start_ranks(args, argv,
                          "geossl_tpu_torch.train.pretrain_baselines"):
        return None
    return run(objective, args)


if __name__ == "__main__":
    main()
