"""GeoSSL-DDM pretraining of SchNet or PaiNN (counterpart of
``geossl_tpu/train/pretrain_geossl.py``; reference
``examples/pretrain_GeoSSL.py``), the port's training path.

Per step, as the JAX step: view 1 is the clean geometry, view 2 the
positions plus N(mu, sigma); BFS atom masking on every batch
(``--GeoSSL_atom_masking_ratio``); the node latents of each view are scored
against the *other* view's pairwise distances by two NCSN_version_03 heads,
``l1 = NCSN_01(h1, d2)``, ``l2 = NCSN_02(h2, d1)``, loss ``(l1 + l2) / 2``,
then one Adam step. The backbone is saved as ``{"model": state_dict}`` in
``model.pth`` on the best epoch-mean loss and ``model_final.pth`` at the end
(``pretrain_GeoSSL.py:48-65``), the checkpoint ``serve.Predictor`` loads.

With ``--model_3d painn`` one radius graph, built from the clean geometry,
is the pair mask of both views (``pretrain_GeoSSL.py:88-89``); distances and
directions come from each view's live positions.

On CUDA (the default) the backbone's message pass (CFConv, or PaiNN's) and
the heads' per-pair chain run the port's kernels; ``--device cpu`` takes the
plain versions. Only ``--GeoSSL_option DDM`` is ported.

Run: ``python -m geossl_tpu_torch.train.pretrain_geossl --synthetic --epochs 2``
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch
from torch import nn

from geossl_tpu_torch.data.bucketing import BucketedLoader
from geossl_tpu_torch.data.masking import make_bfs_transform
from geossl_tpu_torch.data.molecule3d import load_molecule3d
from geossl_tpu_torch.models.painn import PaiNN
from geossl_tpu_torch.objectives.contrastive import l2_normalize, perturb_positions
from geossl_tpu_torch.objectives.ncsn import NCSNv3
from geossl_tpu_torch.objectives.pairs import pair_selection
from geossl_tpu_torch.ops import geometry
from geossl_tpu_torch.serve import resolve_device
from geossl_tpu_torch.train import checkpoints, common, optim


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_common_args(p)
    p.add_argument("--dataset", default="Molecule3D_1000000")
    p.add_argument("--GeoSSL_option", default="DDM",
                   choices=["DDM", "EBM_NCE", "InfoNCE", "RR"])
    p.add_argument("--GeoSSL_mu", type=float, default=0.0)
    p.add_argument("--GeoSSL_sigma", type=float, default=0.3)
    p.add_argument("--GeoSSL_atom_masking_ratio", type=float, default=0.3)
    p.add_argument("--SM_sigma_begin", type=float, default=10.0)
    p.add_argument("--SM_sigma_end", type=float, default=0.01)
    p.add_argument("--SM_num_noise_level", type=int, default=50)
    p.add_argument("--SM_noise_type", default="symmetry",
                   choices=["symmetry", "random"])
    p.add_argument("--SM_anneal_power", type=float, default=2.0)
    p.add_argument("--distance_sample_ratio", type=float, default=1.0)
    p.add_argument("--gnn_2d_lr_scale", type=float, default=None,
                   help="RR only (not ported)")
    p.add_argument("--T", type=float, default=0.1)
    p.add_argument("--CL_neg_samples", type=int, default=1)
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--AE_loss", default="l2", choices=["l1", "l2", "cosine"])
    p.add_argument("--detach_target", dest="detach_target",
                   action="store_true", default=True)
    p.add_argument("--no_detach_target", dest="detach_target",
                   action="store_false")
    p.set_defaults(lr=5e-4, epochs=100)
    return p


class DDM(nn.Module):
    """The backbone and the two NCSN_version_03 heads, under the JAX
    package's top-level parameter names (``model``, ``NCSN_01``,
    ``NCSN_02``). ``plain`` runs the plain versions on any device. A PaiNN
    backbone gets the clean geometry's radius graph as the pair mask of
    both views."""

    def __init__(self, model: nn.Module, ncsn_01: NCSNv3, ncsn_02: NCSNv3,
                 normalize: bool = False, plain: bool = False):
        super().__init__()
        self.model = model
        self.NCSN_01 = ncsn_01
        self.NCSN_02 = ncsn_02
        self.normalize = normalize
        self.plain = plain

    @property
    def plain(self) -> bool:
        return self._plain

    @plain.setter
    def plain(self, value: bool) -> None:
        self._plain = value
        for head in (self.NCSN_01, self.NCSN_02):
            head.use_kernel = not value

    def forward(self, batch, pos2, sel, draws=None,
                generator: Optional[torch.Generator] = None):
        """The DDM loss of one batch. ``draws`` = (sigmas1, noise1, sigmas2,
        noise2) replaces the heads' draws from ``generator``."""
        z, mask = batch.atom_type, batch.node_mask
        d1, pm = geometry.pairwise_distances(batch.positions, batch.node_mask)
        kw = {"plain": self.plain}
        if isinstance(self.model, PaiNN):
            # cached clean-geometry radius graph (pretrain_GeoSSL.py:88-89)
            kw["pair_mask"] = geometry.radius_adjacency(
                d1, pm, self.model.cutoff, self.model.max_neighbors)
        _, h1 = self.model(z, batch.positions, mask, **kw)
        _, h2 = self.model(z, pos2, mask, **kw)
        if self.normalize:
            h1, h2 = l2_normalize(h1), l2_normalize(h2)
        d2, _ = geometry.pairwise_distances(pos2, batch.node_mask)
        s1, n1, s2, n2 = draws if draws is not None else (None,) * 4
        # cross terms (pretrain_GeoSSL.py:207-208)
        l1 = self.NCSN_01(h1, d2, sel, batch.graph_mask, s1, n1, generator)
        l2 = self.NCSN_02(h2, d1, sel, batch.graph_mask, s2, n2, generator)
        return (l1 + l2) / 2


def make_ddm(args, cfg, generator: torch.Generator) -> DDM:
    model = common.make_backbone(cfg, generator)
    heads = [NCSNv3(emb_dim=args.emb_dim, sigma_begin=args.SM_sigma_begin,
                    sigma_end=args.SM_sigma_end,
                    num_noise_level=args.SM_num_noise_level,
                    anneal_power=args.SM_anneal_power, generator=generator)
             for _ in range(2)]
    return DDM(model, *heads, normalize=args.normalize,
               plain=not common.use_kernels(args))


def batch_views(args, batch, generator):
    """(perturbed positions, pair selection) of one batch, drawn from
    ``generator`` in this order."""
    pos2 = perturb_positions(generator, batch.positions, args.GeoSSL_mu,
                             args.GeoSSL_sigma)
    option = "permutation" if args.SM_noise_type == "random" else "combination"
    ratio = args.distance_sample_ratio
    sel = pair_selection(batch.node_mask, option, ratio,
                         generator if ratio < 1 else None)
    return pos2, sel


def train_step(ddm: DDM, opt, sched, batches, args, generator) -> torch.Tensor:
    """One optimizer step over ``batches`` (gradients averaged over the
    group, as ``--grad_accum`` does); returns the mean loss on the device."""
    opt.zero_grad(set_to_none=True)
    total = 0.0
    for batch in batches:
        pos2, sel = batch_views(args, batch, generator)
        loss = ddm(batch, pos2, sel, generator=generator)
        (loss / len(batches)).backward()
        total = total + loss.detach()
    opt.step()
    sched.step()
    return total / len(batches)


def main(argv=None):
    """Train; returns (the DDM module, every step's loss as floats)."""
    args = build_parser().parse_args(argv)
    if args.GeoSSL_option != "DDM":
        raise NotImplementedError(f"--GeoSSL_option {args.GeoSSL_option}: "
                                  "only DDM is ported (ROADMAP.md queue 1)")
    if args.gnn_2d_lr_scale is not None:
        raise NotImplementedError("--gnn_2d_lr_scale applies to RR, which is "
                                  "not ported")
    common.check_ported_args(args)
    cfg = common.model_config_from_args(args)
    device = resolve_device(args.device)
    common.check_driver_limits(args, cfg, device, ncsn=True)
    subset = None
    if args.dataset.startswith("Molecule3D_"):
        subset = int(args.dataset.split("_")[-1])
    store = load_molecule3d(args.data_root, subset=subset,
                            synthetic=args.synthetic,
                            synthetic_size=args.synthetic_size,
                            synthetic_max_atoms=args.synthetic_max_atoms)
    transform = None
    if args.GeoSSL_atom_masking_ratio > 0:
        transform = make_bfs_transform(args.GeoSSL_atom_masking_ratio)

    ddm = make_ddm(args, cfg, torch.Generator().manual_seed(args.seed))
    if args.input_model_file:
        from geossl_tpu_torch.utils.torch_import import load_torch_checkpoint

        ddm.model.load_state_dict(load_torch_checkpoint(args.input_model_file)["model"])
    ddm.to(device)
    loader = BucketedLoader(store, args.batch_size, common.buckets(args),
                            seed=args.seed, transform=transform)
    opt, sched = common.make_optimizer_from_args(
        args, ddm.parameters(),
        common.opt_steps_per_epoch(len(loader), args.grad_accum))

    saver = checkpoints.BestModelSaver(args.output_model_dir)
    mlog = common.MetricLogger(args.log_file)
    start_epoch, best, extra = common.try_resume(args, {"ddm": ddm}, opt, sched)
    plateau = common.make_plateau(args, extra)
    saver.best_metric = best
    history = []
    for epoch in range(start_epoch, args.epochs + 1):
        timer = common.EpochTimer()
        generator = torch.Generator(device).manual_seed(
            hash((args.seed + 1, epoch)) % (2**31))
        losses = [train_step(ddm, opt, sched, [b.to(device) for b in group],
                             args, generator)
                  for group in common.accum_groups(loader.epoch(epoch),
                                                   args.grad_accum)]
        # one device-to-host copy per epoch
        losses = torch.stack(losses).tolist()
        history += losses
        mean_loss = sum(losses) / len(losses)
        if plateau is not None:
            optim.set_plateau_scale(sched, plateau.step(mean_loss))
        saved = saver.maybe_save_best(
            mean_loss, lambda: {"model": ddm.model.state_dict()})
        print(f"Epoch: {epoch}\tSSL Loss: {mean_loss:.5f}\tSSL Acc: 0.00000"
              f"\tTime: {timer.elapsed():.3f}" + ("\t[saved best]" if saved else ""))
        mlog.log(epoch=epoch, loss=mean_loss, acc=0.0,
                 time_s=round(timer.elapsed(), 3), saved_best=saved)
        common.maybe_save_state(args, {"ddm": ddm}, opt, sched, epoch,
                                saver.best_metric,
                                plateau.state() if plateau else None)
    saver.save_final({"model": ddm.model.state_dict()})
    mlog.log(final=True, best_loss=saver.best_metric, epochs=args.epochs)
    return ddm, history


if __name__ == "__main__":
    main()
