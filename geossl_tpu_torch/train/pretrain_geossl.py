"""GeoSSL pretraining of SchNet or PaiNN: DDM, InfoNCE, EBM-NCE and RR
(counterpart of ``geossl_tpu/train/pretrain_geossl.py``; reference
``examples/pretrain_GeoSSL.py``), the port's training path.

Per step, as the JAX step: view 1 is the clean geometry, view 2 the
positions plus N(mu, sigma); BFS atom masking on every batch
(``--GeoSSL_atom_masking_ratio``); both views go through the one backbone.
Then, per ``--GeoSSL_option``:

* **DDM** (``:179-212``): the node latents of each view are scored against
  the *other* view's pairwise distances by two NCSN_version_03 heads,
  ``l1 = NCSN_01(h1, d2)``, ``l2 = NCSN_02(h2, d1)``, loss ``(l1 + l2) / 2``.
* **InfoNCE** (``:141-176``): symmetric cross entropy over the B×B
  similarities of the graph representations / ``--T``.
* **EBM_NCE** (``:103-138``): BCE on the positive dot products against
  ``--CL_neg_samples`` cyclic-shift negatives.
* **RR** (``:77-100``): two AutoEncoders (``AE_01``, ``AE_02``) reconstruct
  each view's graph representation from the other's; the mean of the two.
  ``--gnn_2d_lr_scale`` runs them at that lr (an absolute lr, the
  reference's param-group quirk, times the schedule's factor).

``--normalize`` l2-normalises the latents the loss reads. Then one Adam
step. The backbone is saved as ``{"model": state_dict}`` in ``model.pth``
on the best epoch-mean loss and ``model_final.pth`` at the end
(``pretrain_GeoSSL.py:48-65``), the checkpoint ``serve.Predictor`` loads.

With ``--model_3d painn`` one radius graph, built from the clean geometry,
is the pair mask of both views (``pretrain_GeoSSL.py:88-89``); distances and
directions come from each view's live positions.

On CUDA (the default) the backbone's message pass (CFConv, or PaiNN's) and
DDM's per-pair head chain run the port's kernels; ``--device cpu`` takes
the plain versions. Batches come from the C++ packer (the fused BFS mask
and pack) through ``parallel/mesh.prefetch``; ``--steps_per_call k`` runs k
steps per call as one CUDA graph replay on the card (the steps' draws from
one device generator, reseeded per epoch and registered with the graphs);
``--profile_dir`` writes a ``torch.profiler`` trace of the first epoch.

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
from geossl_tpu_torch.objectives.autoencoder import AutoEncoder
from geossl_tpu_torch.objectives.contrastive import (
    dual_infonce_loss,
    ebm_nce_loss,
    l2_normalize,
    perturb_positions,
)
from geossl_tpu_torch.objectives.ncsn import NCSNv3
from geossl_tpu_torch.objectives.pairs import pair_selection
from geossl_tpu_torch.ops import geometry
from geossl_tpu_torch.parallel import mesh as pmesh
from geossl_tpu_torch.train import common, optim


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
                   help="RR only: ABSOLUTE lr for the two AutoEncoder heads "
                        "(torch param-group quirk, pretrain_GeoSSL.py:335-337"
                        " — the group lr is the scale itself, NOT lr*scale; "
                        "reference default 1.0). Default: AE heads train at "
                        "--lr like everything else")
    p.add_argument("--T", type=float, default=0.1)
    p.add_argument("--CL_neg_samples", type=int, default=1,
                   help="cyclic-shift negatives per positive for EBM_NCE")
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--AE_loss", default="l2", choices=["l1", "l2", "cosine"])
    p.add_argument("--detach_target", dest="detach_target",
                   action="store_true", default=True)
    p.add_argument("--no_detach_target", dest="detach_target",
                   action="store_false")
    p.set_defaults(lr=5e-4, epochs=100)
    return p


def encode_views(model: nn.Module, batch, pos2, plain: bool = False):
    """((g1, h1), (g2, h2), d1): both views through ``model``, and the clean
    view's pairwise distances. A PaiNN backbone gets the clean geometry's
    radius graph as the pair mask of both views
    (``pretrain_GeoSSL.py:88-89``)."""
    z, mask = batch.atom_type, batch.node_mask
    d1, pm = geometry.pairwise_distances(batch.positions, mask)
    kw = {"plain": plain}
    if isinstance(model, PaiNN):
        kw["pair_mask"] = geometry.radius_adjacency(
            d1, pm, model.cutoff, model.max_neighbors)
    return (model(z, batch.positions, mask, **kw), model(z, pos2, mask, **kw),
            d1)


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
        """The DDM loss of one (global) batch. ``draws`` = (sigmas1, noise1,
        sigmas2, noise2) replaces the heads' draws from ``generator``, which
        are made for the whole batch, in the heads' order. On a mesh each
        rank runs the backbone and the heads on its rows and the per-graph
        losses are gathered (``parallel/mesh.sharded``)."""
        if draws is None:
            # the heads' distances' shape and dtype (NCSNv3.per_graph)
            b, n = batch.node_mask.shape
            like = ((b, n, n), torch.promote_types(torch.float32,
                                                   batch.positions.dtype),
                    batch.positions.device, generator)
            draws = (*self.NCSN_01.sample(*like), *self.NCSN_02.sample(*like))
        l1, l2 = pmesh.sharded(self.per_graph, batch, pos2, sel, *draws)
        gm = batch.graph_mask
        return (common.graph_masked_mean(l1, gm)
                + common.graph_masked_mean(l2, gm)) / 2

    def per_graph(self, batch, pos2, sel, s1, n1, s2, n2):
        """The two heads' per-graph losses [B] of ``batch``'s rows."""
        (_, h1), (_, h2), d1 = encode_views(self.model, batch, pos2, self.plain)
        if self.normalize:
            h1, h2 = l2_normalize(h1), l2_normalize(h2)
        d2, _ = geometry.pairwise_distances(pos2, batch.node_mask)
        # cross terms (pretrain_GeoSSL.py:207-208)
        return (self.NCSN_01.per_graph(h1, d2, sel, s1, n1),
                self.NCSN_02.per_graph(h2, d1, sel, s2, n2))


class GraphSSL(nn.Module):
    """InfoNCE, EBM_NCE or RR on the two views' graph representations:
    the backbone under the JAX package's name ``model`` and, for RR, the
    AutoEncoders ``AE_01`` (view 1 -> view 2) and ``AE_02`` (2 -> 1), whose
    BatchNorm statistics are buffers carried from step to step. ``forward``
    returns (loss, accuracy); RR's accuracy is 0, as the JAX driver's."""

    def __init__(self, model: nn.Module, option: str, temperature: float = 0.1,
                 num_neg: int = 1, normalize: bool = False,
                 ae_01: Optional[AutoEncoder] = None,
                 ae_02: Optional[AutoEncoder] = None, plain: bool = False):
        super().__init__()
        if option not in ("InfoNCE", "EBM_NCE", "RR"):
            raise ValueError(f"GraphSSL: unknown option {option!r}")
        if (option == "RR") != (ae_01 is not None and ae_02 is not None):
            raise ValueError("GraphSSL: RR, and RR only, takes ae_01 and ae_02")
        self.model = model
        self.option = option
        self.temperature = temperature
        self.num_neg = num_neg
        self.normalize = normalize
        self.plain = plain
        if option == "RR":
            self.AE_01 = ae_01
            self.AE_02 = ae_02

    def forward(self, batch, pos2):
        """(loss, accuracy) of one (global) batch; on a mesh each rank
        encodes its rows and the graph representations are gathered, so
        the batch-coupled losses (the shifted negatives, the BatchNorm
        statistics) see the whole batch (``parallel/mesh.sharded``)."""
        g1, g2 = pmesh.sharded(self.graph_reprs, batch, pos2)
        if self.normalize:
            g1, g2 = l2_normalize(g1), l2_normalize(g2)
        gm = batch.graph_mask
        if self.option == "InfoNCE":
            return dual_infonce_loss(g1, g2, self.temperature, gm)
        if self.option == "EBM_NCE":
            return ebm_nce_loss(g1, g2, gm, num_neg=self.num_neg)
        loss = (self.AE_01(g1, g2, gm) + self.AE_02(g2, g1, gm)) / 2
        return loss, torch.zeros((), device=loss.device)

    def graph_reprs(self, batch, pos2):
        """Both views' graph representations of ``batch``'s rows."""
        (g1, _), (g2, _), _ = encode_views(self.model, batch, pos2, self.plain)
        return g1, g2


def make_ddm(args, cfg, generator: torch.Generator) -> DDM:
    model = common.make_backbone(cfg, generator)
    heads = [NCSNv3(emb_dim=args.emb_dim, sigma_begin=args.SM_sigma_begin,
                    sigma_end=args.SM_sigma_end,
                    num_noise_level=args.SM_num_noise_level,
                    anneal_power=args.SM_anneal_power, generator=generator)
             for _ in range(2)]
    return DDM(model, *heads, normalize=args.normalize,
               plain=not common.use_kernels(args))


def make_graph_ssl(args, cfg, generator: torch.Generator) -> GraphSSL:
    """The backbone and, for RR, the two AutoEncoders, drawn from
    ``generator`` in that order."""
    model = common.make_backbone(cfg, generator)
    aes = ([AutoEncoder(args.emb_dim, args.AE_loss, args.detach_target,
                        generator) for _ in range(2)]
           if args.GeoSSL_option == "RR" else [None, None])
    return GraphSSL(model, args.GeoSSL_option, args.T, args.CL_neg_samples,
                    args.normalize, *aes, plain=not common.use_kernels(args))


def batch_views(args, batch, generator):
    """(perturbed positions, pair selection) of one batch, drawn from
    ``generator`` in this order."""
    pos2 = view_positions(args, batch, generator)
    option = "permutation" if args.SM_noise_type == "random" else "combination"
    ratio = args.distance_sample_ratio
    sel = pair_selection(batch.node_mask, option, ratio,
                         generator if ratio < 1 else None)
    return pos2, sel


def view_positions(args, batch, generator):
    """View 2: the positions plus N(``GeoSSL_mu``, ``GeoSSL_sigma``)."""
    return perturb_positions(generator, batch.positions, args.GeoSSL_mu,
                             args.GeoSSL_sigma)


def loss_of(module: nn.Module, args):
    """``(batch, generator)`` -> (loss, accuracy) of ``module`` (a
    :class:`DDM` or a :class:`GraphSSL`), its draws from the generator."""
    if isinstance(module, DDM):
        def ddm_loss(batch, generator):
            loss = module(batch, *batch_views(args, batch, generator),
                          generator=generator)
            return loss, torch.zeros((), device=loss.device)
        return ddm_loss
    return lambda batch, generator: module(
        batch, view_positions(args, batch, generator))


def train_step(ddm: nn.Module, opt, sched, batches, args,
               generator) -> torch.Tensor:
    """One optimizer step over ``batches`` (gradients averaged over the
    group, as ``--grad_accum`` does); returns the mean loss on the device.
    ``ddm``: a :class:`DDM` or a :class:`GraphSSL`."""
    fn = loss_of(ddm, args)
    return common.pretrain_step(ddm, opt, sched, batches,
                                lambda b: fn(b, generator))[0]


def main(argv=None):
    """Train; returns (the DDM or GraphSSL module, every step's loss as
    floats); None in a launcher that started the ranks
    (``common.start_ranks``)."""
    args = build_parser().parse_args(argv)
    option = args.GeoSSL_option
    group_lr = None
    if args.gnn_2d_lr_scale is not None:
        if option != "RR":
            raise SystemExit("--gnn_2d_lr_scale only applies to the RR "
                             "AutoEncoder heads (GeoSSL_option=RR)")
        # the reference's quirk: the AE groups' lr is the scale itself
        # (pretrain_GeoSSL.py:335-337), a factor on the base lr here
        f = args.gnn_2d_lr_scale / args.lr
        group_lr = {"AE_01": f, "AE_02": f}
    common.check_ported_args(args, traces=True)
    if common.start_ranks(args, argv, "geossl_tpu_torch.train.pretrain_geossl"):
        return None
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
    transform = None
    if args.GeoSSL_atom_masking_ratio > 0:
        transform = make_bfs_transform(args.GeoSSL_atom_masking_ratio)

    generator = torch.Generator().manual_seed(args.seed)
    module = (make_ddm(args, cfg, generator) if option == "DDM"
              else make_graph_ssl(args, cfg, generator))
    if args.input_model_file:
        from geossl_tpu_torch.utils.torch_import import load_model_state

        module.model.load_state_dict(
            load_model_state(args.input_model_file, cfg)["model"])
    pmesh.put_replicated(mesh, module.to(device))
    loader = BucketedLoader(store, common.round_batch_to_mesh(
        args.batch_size, mesh), common.buckets(args), seed=args.seed,
        transform=transform)
    params = (module.parameters() if group_lr is None else optim.param_groups(
        dict(module.named_children()), args.lr, group_lr))
    opt, sched = common.make_optimizer_from_args(
        args, params, common.opt_steps_per_epoch(len(loader), args.grad_accum))
    history = common.run_pretrain(
        args, module, "ddm" if option == "DDM" else "ssl", opt, sched, loader,
        loss_of(module, args), device, labels=("SSL Loss", "SSL Acc"))
    return module, history


if __name__ == "__main__":
    main()
