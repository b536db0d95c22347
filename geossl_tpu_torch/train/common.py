"""Shared driver plumbing (counterpart of ``geossl_tpu/train/common.py``):
backbone and head construction, the drivers' common flags with the JAX
package's names and defaults (one command line drives both packages),
gradient accumulation groups, resume state, the metric log, and the
fine-tunes' epoch loop (``run_finetune``).

Both backbones are ported (``--model_3d schnet|painn``). Flags the port
does not run yet raise ``NotImplementedError`` when set away from their
defaults: multi-device and multi-host runs, ``--steps_per_call`` (a TPU
dispatch optimisation), ``--profile_dir``, bf16 compute and the fine-tunes'
``--pair_devices``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional

import torch
from torch import nn

from geossl_tpu_torch.config import ModelConfig, PaiNNConfig, SchNetConfig
from geossl_tpu_torch.models.common import HalvingMLP, init_linear_
from geossl_tpu_torch.models.painn import PaiNN
from geossl_tpu_torch.models.schnet import SchNet
from geossl_tpu_torch.ops import cfconv as cfconv_ops
from geossl_tpu_torch.ops import ncsn as ncsn_ops
from geossl_tpu_torch.ops import painn as painn_ops
from geossl_tpu_torch.train import checkpoints, optim
from geossl_tpu_torch.utils.torch_import import load_torch_checkpoint


def graph_masked_mean(per_graph: torch.Tensor,
                      graph_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of a per-graph loss over the real graphs (``graph_mask``); the
    empty slots that pad a partial batch count for nothing."""
    if graph_mask is None:
        return per_graph.mean()
    gm = graph_mask.to(per_graph.dtype)
    return torch.sum(per_graph * gm) / torch.clamp(gm.sum(), min=1.0)


class LinearHead(nn.Linear):
    """``graph_pred_linear`` for SchNet tasks: ``nn.Linear(emb, 1)``
    (``finetune_qm9.py:113``), returning ``[B]``."""

    def __init__(self, emb_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(emb_dim, 1)
        init_linear_(self, generator)

    def forward(self, x):
        return super().forward(x)[..., 0]


class PaiNNHead(HalvingMLP):
    """``graph_pred_linear`` for PaiNN tasks: the backbone's
    ``create_output_layers()`` halving silu MLP (emb -> emb/2 -> 1; keys
    ``0.*``, ``1.*``), returning ``[B]``."""

    def __init__(self, emb_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(emb_dim, 1, generator=generator)

    def forward(self, x):
        return super().forward(x)[..., 0]


class DualHead(nn.Linear):
    """LEP's ``graph_pred_linear`` for both backbones: ``Linear(2·emb -> 1)``
    on the two towers' concatenated representations
    (``finetune_lep.py:34-45``, ``:194-206``), returning ``[B]``."""

    def __init__(self, emb_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(2 * emb_dim, 1)
        init_linear_(self, generator)

    def forward(self, repr_active, repr_inactive):
        return super().forward(
            torch.cat([repr_active, repr_inactive], dim=-1))[..., 0]


def make_head(model_3d: str, emb_dim: int,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """The reference's per-backbone downstream head."""
    if model_3d == "schnet":
        return LinearHead(emb_dim, generator)
    return PaiNNHead(emb_dim, generator)


def make_backbone(cfg: ModelConfig,
                  generator: Optional[torch.Generator] = None) -> nn.Module:
    """SchNet or PaiNN for ``cfg``; ``forward(atom_type, positions,
    node_mask, ...)`` -> (graph_repr [B,F], node_repr [B,N,F])."""
    sparse = {"auto": "auto", "on": True, "off": False}[cfg.sparse_tiles]
    if cfg.model_3d == "painn":
        p = cfg.painn
        return PaiNN(
            n_atom_basis=cfg.emb_dim,
            n_interactions=p.n_interactions,
            n_rbf=p.n_rbf,
            cutoff=p.cutoff,
            readout=p.readout,
            max_neighbors=cfg.max_neighbors,
            max_z=p.max_z,
            shared_interactions=p.shared_interactions,
            shared_filters=p.shared_filters,
            epsilon=p.epsilon,
            sparse=sparse,
            generator=generator,
        )
    s = cfg.schnet
    return SchNet(
        hidden_channels=cfg.emb_dim,
        num_filters=s.num_filters,
        num_interactions=s.num_interactions,
        num_gaussians=s.num_gaussians,
        cutoff=s.cutoff,
        node_class=s.node_class,
        readout=s.readout,
        max_neighbors=cfg.max_neighbors,
        sparse=sparse,
        generator=generator,
    )


# -- flags -------------------------------------------------------------------


def add_common_args(p: argparse.ArgumentParser):
    """The JAX drivers' common flags, same names and defaults, plus
    ``--device``. ``--use_pallas`` keeps its name: 'auto' and 'on' run the
    port's kernels (on CUDA; the CPU always takes the plain versions), 'off'
    the plain versions on any device."""
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")
    p.add_argument("--platform", default=None,
                   help="JAX's platform flag; not used by the port (see "
                        "--device)")
    p.add_argument("--model_3d", default="schnet", choices=["schnet", "painn"])
    p.add_argument("--emb_dim", type=int, default=128)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--decay", type=float, default=0.0)
    p.add_argument("--lr_scheduler", default="CosineAnnealingLR",
                   choices=list(optim.SCHEDULERS))
    p.add_argument("--lr_decay_factor", type=float, default=0.5)
    p.add_argument("--lr_decay_step_size", type=int, default=100)
    p.add_argument("--lr_decay_patience", type=int, default=50)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--data_root", default="data")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic stand-in dataset (no downloads)")
    p.add_argument("--synthetic_size", type=int, default=256)
    p.add_argument("--synthetic_max_atoms", type=int, default=29)
    p.add_argument("--output_model_dir", default="")
    p.add_argument("--input_model_file", default="")
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--local_device_count", type=int, default=None)
    p.add_argument("--bucket", type=int, nargs="+", default=[32, 64, 128])
    p.add_argument("--num_filters", type=int, default=128)
    p.add_argument("--num_interactions", type=int, default=6)
    p.add_argument("--num_gaussians", type=int, default=51)
    p.add_argument("--cutoff", type=float, default=10.0)
    p.add_argument("--readout", default="mean", choices=["mean", "add"])
    p.add_argument("--painn_radius_cutoff", type=float, default=5.0)
    p.add_argument("--painn_n_interactions", type=int, default=3)
    p.add_argument("--painn_n_rbf", type=int, default=20)
    p.add_argument("--painn_readout", default="add", choices=["mean", "add"])
    p.add_argument("--max_num_neighbors", type=int, default=None)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--filter_mxu", default="f32", choices=["f32", "bf16"])
    p.add_argument("--log_file", default="",
                   help="append one JSON line of metrics per epoch")
    p.add_argument("--profile_dir", default="")
    p.add_argument("--use_pallas", default="auto", choices=["auto", "on", "off"],
                   help="the port's kernels: auto/on run them on CUDA, off "
                        "takes the plain versions on any device")
    p.add_argument("--sparse_tiles", default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--grad_accum", type=int, default=1,
                   help="average gradients over k same-shape loader batches "
                        "before each optimizer step")
    p.add_argument("--steps_per_call", type=int, default=1)
    p.add_argument("--ckpt_every", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="resume from <output_model_dir>/state.pth if present")
    return p


def check_ported_args(args) -> None:
    """Raise for the flags whose paths the port does not run yet."""
    unported = {
        "--num_devices": args.num_devices not in (None, 1),
        "--coordinator_address": args.coordinator_address is not None,
        "--num_processes": args.num_processes != 1,
        "--steps_per_call": args.steps_per_call > 1,
        "--profile_dir": bool(args.profile_dir),
        "--pair_devices": getattr(args, "pair_devices", 1) > 1,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)}: not ported yet (ROADMAP.md queue 1); the port "
            "runs one device, one process, one optimizer step per call")
    if args.grad_accum < 1:
        raise ValueError(f"--grad_accum must be >= 1, got {args.grad_accum}")


def use_kernels(args) -> bool:
    return args.use_pallas != "off"


# -- the kernels' limits ----------------------------------------------------------


def kernel_limit_errors(cfg: ModelConfig, *, backward: bool,
                        per_block: bool = True, stack: bool = False,
                        ncsn: bool = False) -> list:
    """Each setting of ``cfg`` that a CUDA kernel of the named routes would
    refuse at its first launch, as one line naming the flag and the limit:
    the per-block kernels (``backward``: and their backwards), the backbone's
    whole-stack kernel, DDM's NCSN head kernels. Empty when they all fit."""
    errors = []

    def need(ok, flag, value, limit):
        if not ok:
            errors.append(f"--{flag} {value}: {limit}")

    f = cfconv_ops.KERNEL_F
    if cfg.model_3d == "painn":
        r = cfg.painn.n_rbf
        if per_block or stack:
            need(cfg.emb_dim == f, "emb_dim", cfg.emb_dim,
                 f"the PaiNN kernels take {f} only (ops/cfconv.KERNEL_F)")
            need(2 <= r <= painn_ops.MAX_R, "painn_n_rbf", r,
                 f"the PaiNN kernels take 2 to {painn_ops.MAX_R} "
                 "(ops/painn.MAX_R)")
    else:
        s = cfg.schnet
        g, g_max = s.num_gaussians, cfconv_ops.KERNEL_MAX_G
        if per_block:
            need(s.num_filters == f, "num_filters", s.num_filters,
                 f"the CFConv kernels take {f} only (ops/cfconv.KERNEL_F)")
            if cfg.max_neighbors is None or backward:
                need(g <= g_max, "num_gaussians", g,
                     f"the symmetric CFConv forward and both CFConv "
                     f"backwards take at most {g_max} "
                     "(ops/cfconv.KERNEL_MAX_G)")
            else:
                g_plain = cfconv_ops.PLAIN_FWD_MAX_G
                need(g <= g_plain, "num_gaussians", g,
                     f"the plain-mode CFConv forward takes at most {g_plain} "
                     "(ops/cfconv.PLAIN_FWD_MAX_G)")
        # the stack serves only when h keeps one width (num_filters = emb)
        if stack and s.num_filters == cfg.emb_dim:
            need(s.num_filters == f, "num_filters", s.num_filters,
                 f"schnet_stack takes {f} only (ops/cfconv.KERNEL_F)")
            need(g <= g_max, "num_gaussians", g,
                 f"schnet_stack takes at most {g_max} "
                 "(ops/cfconv.KERNEL_MAX_G)")
    if ncsn:
        e = ncsn_ops.KERNEL_E
        need(cfg.emb_dim == e, "emb_dim", cfg.emb_dim,
             f"the NCSN head kernels take {e} only (ops/ncsn.KERNEL_E)")
    return list(dict.fromkeys(errors))


def check_kernel_limits(cfg: ModelConfig, device: torch.device,
                        **routes) -> None:
    """Raise ``ValueError`` at startup, before anything is allocated, when
    ``device`` is CUDA and a kernel of ``routes`` (:func:`kernel_limit_errors`)
    would refuse ``cfg`` at its first launch. The CPU runs every setting."""
    if device.type != "cuda":
        return
    errors = kernel_limit_errors(cfg, **routes)
    if errors:
        raise ValueError(
            "these settings exceed the CUDA kernels' limits: "
            + "; ".join(errors) + " (the CPU runs them: --device cpu; a "
            "driver also with --use_pallas off)")


def check_driver_limits(args, cfg: ModelConfig, device: torch.device,
                        ncsn: bool = False) -> None:
    """:func:`check_kernel_limits` for a driver: its per-block kernels, with
    their backwards unless ``--eval_only``; nothing under ``--use_pallas
    off``."""
    if use_kernels(args):
        check_kernel_limits(cfg, device,
                            backward=not getattr(args, "eval_only", False),
                            ncsn=ncsn)


def model_config_from_args(args) -> ModelConfig:
    return ModelConfig(
        model_3d=args.model_3d,
        emb_dim=args.emb_dim,
        schnet=SchNetConfig(
            hidden_channels=args.emb_dim, num_filters=args.num_filters,
            num_interactions=args.num_interactions,
            num_gaussians=args.num_gaussians, cutoff=args.cutoff,
            readout=args.readout),
        painn=PaiNNConfig(
            n_atom_basis=args.emb_dim,
            n_interactions=args.painn_n_interactions,
            n_rbf=args.painn_n_rbf, cutoff=args.painn_radius_cutoff,
            readout=args.painn_readout),
        compute_dtype=args.compute_dtype,
        filter_mxu=args.filter_mxu,
        max_neighbors=args.max_num_neighbors,
        sparse_tiles=args.sparse_tiles,
    )


def buckets(args) -> tuple:
    b = args.bucket
    return tuple(sorted([b] if isinstance(b, int) else b))


def opt_steps_per_epoch(num_batches: int, grad_accum: int) -> int:
    """Optimizer steps per epoch under gradient accumulation: ceil(n/k)."""
    return -(-num_batches // max(grad_accum, 1))


def accum_groups(batches, k: int):
    """Consecutive same-shape batches in groups of at most ``k`` (a change
    of padded width, or the end of the epoch, closes a group early)."""
    pending = []
    for b in batches:
        if pending and b.max_atoms != pending[0].max_atoms:
            yield pending
            pending = []
        pending.append(b)
        if len(pending) == k:
            yield pending
            pending = []
    if pending:
        yield pending


def make_optimizer_from_args(args, params, steps_per_epoch: int):
    return optim.make_optimizer(
        params, args.lr, args.epochs, steps_per_epoch, args.decay,
        args.lr_scheduler, decay_factor=args.lr_decay_factor,
        decay_step_size=args.lr_decay_step_size)


def make_plateau(args, extra=None) -> "optim.PlateauController | None":
    """The ReduceLROnPlateau controller, or None for the other schedulers;
    ``extra`` (the resume scalars) restores its counters."""
    plateau_state = {k: extra.pop(k) for k in list(extra or {})
                     if k.startswith("plateau_")}
    if args.lr_scheduler != "ReduceLROnPlateau":
        return None
    ctl = optim.PlateauController(args.lr, factor=args.lr_decay_factor,
                                  patience=args.lr_decay_patience,
                                  min_lr=args.min_lr)
    ctl.load(plateau_state)
    return ctl


# -- resume state ------------------------------------------------------------


def state_path(args) -> str:
    return (os.path.join(args.output_model_dir, "state.pth")
            if args.output_model_dir else "")


def train_state(modules: dict, opt, sched) -> dict:
    """Everything a resume needs. The lr schedule is a function of the step
    count, so its step is saved, not the LambdaLR."""
    return {"modules": {k: m.state_dict() for k, m in modules.items()},
            "opt": opt.state_dict(), "step": sched.last_epoch}


def try_resume(args, modules: dict, opt, sched,
               higher_is_better: bool = False):
    """Load ``state.pth`` under ``--resume``; returns (start_epoch,
    best_metric, extra scalars); a fresh start's best is the worst value."""
    path = state_path(args)
    if not (args.resume and path and os.path.exists(path)):
        return 1, float("-inf" if higher_is_better else "inf"), {}
    state, last_epoch, best, extra = checkpoints.load_train_state(path)
    for k, m in modules.items():
        m.load_state_dict(state["modules"][k])
    opt.load_state_dict(state["opt"])
    sched.last_epoch = state["step"]
    optim.set_plateau_scale(sched, extra.get("plateau_scale", 1.0))
    print(f"Resumed from {path} at epoch {last_epoch} (best {best:.5f})")
    return last_epoch + 1, best, extra


def maybe_save_state(args, modules: dict, opt, sched, epoch: int,
                     best_metric: float, extra=None) -> None:
    """The resume state every ``--ckpt_every`` epochs and at the last one."""
    path = state_path(args)
    if path and (epoch % max(args.ckpt_every, 1) == 0 or epoch == args.epochs):
        checkpoints.save_train_state(path, train_state(modules, opt, sched),
                                     epoch, best_metric, extra)


# -- pretraining ---------------------------------------------------------------


def pretrain_step(module: nn.Module, opt, sched, batches,
                  loss_of) -> torch.Tensor:
    """One optimizer step over ``batches`` (gradients averaged over the
    group, as ``--grad_accum`` does); ``loss_of(batch)`` -> (loss,
    accuracy). Returns [mean loss, mean accuracy] on the device."""
    opt.zero_grad(set_to_none=True)
    total = 0.0
    for batch in batches:
        loss, acc = loss_of(batch)
        (loss / len(batches)).backward()
        total = total + torch.stack([loss.detach(),
                                     acc.detach().to(loss.dtype)])
    opt.step()
    sched.step()
    return total / len(batches)


def run_pretrain(args, module: nn.Module, key: str, opt, sched, loader,
                 loss_of, device, labels=("Loss", "Acc")) -> list:
    """The pretraining drivers' epoch loop, as the JAX drivers run it: an
    epoch of :func:`pretrain_step` with a generator seeded per epoch
    (``loss_of(batch, generator)``), the plateau scheduler on the epoch's
    mean loss, ``model.pth`` (``{"model": module.model.state_dict()}``) at
    the best mean loss and ``model_final.pth`` at the end, the epoch line
    (``labels``: the names of its loss and accuracy), the metric log and
    the resume state (``module`` under ``key``). Returns every step's
    loss."""
    saver = checkpoints.BestModelSaver(args.output_model_dir)
    mlog = MetricLogger(args.log_file)
    start_epoch, best, extra = try_resume(args, {key: module}, opt, sched)
    plateau = make_plateau(args, extra)
    saver.best_metric = best
    history = []
    for epoch in range(start_epoch, args.epochs + 1):
        timer = EpochTimer()
        generator = torch.Generator(device).manual_seed(
            hash((args.seed + 1, epoch)) % (2**31))
        steps = [pretrain_step(module, opt, sched,
                               [b.to(device) for b in group],
                               lambda b: loss_of(b, generator))
                 for group in accum_groups(loader.epoch(epoch),
                                           args.grad_accum)]
        steps = torch.stack(steps).tolist()  # one device-to-host copy
        history += [loss for loss, _ in steps]
        mean_loss = sum(loss for loss, _ in steps) / len(steps)
        mean_acc = sum(acc for _, acc in steps) / len(steps)
        if plateau is not None:
            optim.set_plateau_scale(sched, plateau.step(mean_loss))
        saved = saver.maybe_save_best(
            mean_loss, lambda: {"model": module.model.state_dict()})
        print(f"Epoch: {epoch}\t{labels[0]}: {mean_loss:.5f}\t{labels[1]}: "
              f"{mean_acc:.5f}\tTime: {timer.elapsed():.3f}"
              + ("\t[saved best]" if saved else ""))
        mlog.log(epoch=epoch, loss=mean_loss, acc=mean_acc,
                 time_s=round(timer.elapsed(), 3), saved_best=saved)
        maybe_save_state(args, {key: module}, opt, sched, epoch,
                         saver.best_metric,
                         plateau.state() if plateau else None)
    saver.save_final({"model": module.model.state_dict()})
    mlog.log(final=True, best_loss=saver.best_metric, epochs=args.epochs)
    return history


# -- run records ---------------------------------------------------------------


class EpochTimer:
    def __init__(self):
        self.start = time.time()

    def elapsed(self) -> float:
        return time.time() - self.start


class MetricLogger:
    """One JSON line per epoch appended to ``--log_file`` (off when the path
    is empty); non-finite floats become null."""

    def __init__(self, path: str = ""):
        self.path = path

    def log(self, **fields) -> None:
        if not self.path:
            return
        fields = {k: (None if isinstance(v, float) and not math.isfinite(v)
                      else v) for k, v in fields.items()}
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(fields) + "\n")


# -- fine-tunes -----------------------------------------------------------------


def add_finetune_args(p: argparse.ArgumentParser):
    """The flags both Atom3D fine-tunes add, the JAX drivers' names and
    defaults."""
    p.add_argument("--spatial_sort", default="on", choices=["on", "off"],
                   help="Morton-reorder each complex's atoms once at load "
                        "(outputs unchanged up to the order of f32 sums); "
                        "gathers in-cutoff pairs into few tiles, so the "
                        "occupancy-gated kernels skip more")
    p.add_argument("--eval_only", action="store_true",
                   help="skip training: evaluate --input_model_file (a "
                        "fine-tuned checkpoint with its head) on the val and "
                        "test splits and exit")
    return p


def load_input_model(args, net: nn.Module) -> dict:
    """Load ``--input_model_file`` into ``net.model`` (a pretrain or a
    fine-tuned ``.pth``) and, when the file has one, into
    ``net.graph_pred_linear``; returns the loaded checkpoint
    (``utils/torch_import.load_torch_checkpoint``; empty without the
    flag). With ``--eval_only`` the head is required."""
    ckpt, has_head = {}, False
    if args.input_model_file:
        ckpt = load_torch_checkpoint(args.input_model_file)
        net.model.load_state_dict(ckpt["model"])
        has_head = "graph_pred_linear" in ckpt
        if has_head:  # a fine-tuned checkpoint: its head too
            net.graph_pred_linear.load_state_dict(ckpt["graph_pred_linear"])
        print(f"Loaded pretrained backbone from {args.input_model_file}")
    if args.eval_only and not has_head:
        raise SystemExit(
            "--eval_only needs --input_model_file pointing at a FINE-TUNED "
            "checkpoint (with graph_pred_linear; pretrain checkpoints carry "
            "no head)")
    return ckpt


def finetune_step(net: nn.Module, opt, sched, batches, loss_fn):
    """One optimizer step over ``batches`` (gradients averaged over the
    group, as ``--grad_accum`` does); returns the mean loss on the
    device."""
    opt.zero_grad(set_to_none=True)
    total = 0.0
    for batch in batches:
        loss = loss_fn(net, batch)
        (loss / len(batches)).backward()
        total = total + loss.detach()
    opt.step()
    sched.step()
    return total / len(batches)


def model_tree(net: nn.Module, extra: Optional[dict] = None) -> dict:
    """A fine-tuned ``.pth``: ``model`` and ``graph_pred_linear`` (the
    reference's keys) and the ``extra`` entries."""
    return {"model": net.model.state_dict(),
            "graph_pred_linear": net.graph_pred_linear.state_dict(),
            **(extra or {})}


def run_finetune(args, net: nn.Module, loaders, loss_fn, evaluate,
                 key: str, higher_is_better: bool, describe, device,
                 ckpt_extra: Optional[dict] = None, on_best=None) -> dict:
    """The fine-tunes' epoch loop, as the JAX drivers run it: an epoch of
    optimizer steps, the plateau scheduler on the epoch's mean loss, val
    and test metrics, ``model.pth`` (:func:`model_tree` with
    ``ckpt_extra``) at the best val ``key``, the resume state and the metric
    log.

    ``loaders`` = (train, val, test); ``loss_fn(net, batch)``;
    ``evaluate(net, loader)`` -> {metric: float}; ``describe(val, test)``
    -> the epoch line's metrics; ``on_best()`` runs after each new best's
    ``model.pth`` (with ``--output_model_dir``). Returns {"best",
    "best_epoch", "best_test", "losses"} (every step's loss)."""
    train, val_loader, test_loader = loaders
    opt, sched = make_optimizer_from_args(
        args, net.parameters(),
        opt_steps_per_epoch(len(train), args.grad_accum))
    mlog = MetricLogger(args.log_file)
    start_epoch, best, extra = try_resume(args, {"net": net}, opt, sched,
                                          higher_is_better)
    plateau = make_plateau(args, extra)  # pops its keys from extra
    best_epoch = int(extra.pop("best_epoch", -1))
    best_test = extra  # the remaining keys: the test metrics at the best
    history = []
    for epoch in range(start_epoch, args.epochs + 1):
        timer = EpochTimer()
        losses = [finetune_step(net, opt, sched, [b.to(device) for b in group],
                                loss_fn)
                  for group in accum_groups(train.epoch(epoch),
                                            args.grad_accum)]
        losses = torch.stack(losses).tolist()  # one copy per epoch
        history += losses
        train_loss = sum(losses) / len(losses)
        if plateau is not None:
            optim.set_plateau_scale(sched, plateau.step(train_loss))
        val, test = evaluate(net, val_loader), evaluate(net, test_loader)
        print(f"Epoch: {epoch}\tLoss: {train_loss:.5f}\t{describe(val, test)}"
              f"\tTime: {timer.elapsed():.3f}")
        mlog.log(epoch=epoch, train_loss=train_loss,
                 **{f"val_{k}": v for k, v in val.items()},
                 **{f"test_{k}": v for k, v in test.items()},
                 time_s=round(timer.elapsed(), 3))
        if val[key] > best if higher_is_better else val[key] < best:
            best, best_epoch, best_test = val[key], epoch, test
            if args.output_model_dir:
                checkpoints.save_checkpoint(
                    os.path.join(args.output_model_dir, "model.pth"),
                    model_tree(net, ckpt_extra))
                if on_best is not None:
                    on_best()
        maybe_save_state(args, {"net": net}, opt, sched, epoch, best,
                         {"best_epoch": best_epoch, **best_test,
                          **(plateau.state() if plateau else {})})
    mlog.log(final=True, best_epoch=best_epoch, **{f"best_val_{key}": best},
             **{f"test_{k}_at_best": v for k, v in best_test.items()})
    return {"best": best, "best_epoch": best_epoch, "best_test": best_test,
            "losses": history}
