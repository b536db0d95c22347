"""Shared driver plumbing (counterpart of ``geossl_tpu/train/common.py``):
backbone and head construction, the drivers' common flags with the JAX
package's names and defaults (one command line drives both packages),
gradient accumulation groups, resume state, the metric log.

Both backbones are ported (``--model_3d schnet|painn``). Flags the port
does not run yet raise ``NotImplementedError`` when set away from their
defaults: multi-device and multi-host runs, ``--steps_per_call`` (a TPU
dispatch optimisation), ``--profile_dir`` and bf16 compute.
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
from geossl_tpu_torch.train import checkpoints, optim


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
        if pending and b.atom_type.shape != pending[0].atom_type.shape:
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


def try_resume(args, modules: dict, opt, sched):
    """Load ``state.pth`` under ``--resume``; returns (start_epoch,
    best_metric, extra scalars)."""
    path = state_path(args)
    if not (args.resume and path and os.path.exists(path)):
        return 1, float("inf"), {}
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
