"""Shared driver plumbing (counterpart of ``geossl_tpu/train/common.py``):
backbone and head construction, the drivers' common flags with the JAX
package's names and defaults (one command line drives both packages),
multi-device and multi-host start-up (:func:`start_ranks`,
:func:`setup_platform`), gradient accumulation groups, several optimizer
steps per call (:class:`ChainStep`, ``--steps_per_call``: CUDA graphs on
the card), resume state, the metric log, and the epoch loops
(``run_pretrain``, ``run_finetune``), which take their batches through
``parallel/mesh.prefetch``.

Both backbones are ported (``--model_3d schnet|painn``). ``--num_devices N``
starts N ranks on this host (``torch.multiprocessing``, spawn), one per
device; ``--coordinator_address/--num_processes/--process_id`` start this
host's ranks of a multi-host run; a rank started by ``torchrun`` (its
``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` environment) joins as it is. Each
rank runs the driver on its rows of every global batch
(``parallel/mesh.py``). ``--profile_dir`` raises ``NotImplementedError``
in every driver but pretrain_geossl (:func:`check_ported_args`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import socket
import sys
import time
from typing import Optional

import torch
from torch import nn

from geossl_tpu_torch.config import ModelConfig, PaiNNConfig, SchNetConfig
from geossl_tpu_torch.models.common import HalvingMLP, init_linear_
from geossl_tpu_torch.models.painn import PaiNN
from geossl_tpu_torch.models.schnet import SchNet
from geossl_tpu_torch.ops import cfconv as cfconv_ops
from geossl_tpu_torch.ops import painn as painn_ops
from geossl_tpu_torch.ops._launch import launch_counts
from geossl_tpu_torch.parallel import mesh as pmesh
from geossl_tpu_torch.parallel import multihost
from geossl_tpu_torch.parallel.mesh import prefetch
from geossl_tpu_torch.train import checkpoints, optim
from geossl_tpu_torch.utils import profiling
from geossl_tpu_torch.utils.torch_import import load_model_state


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
    node_mask, ...)`` -> (graph_repr [B,F], node_repr [B,N,F]), computed
    in ``cfg.compute_dtype`` (its parameters f32 either way; the outputs
    f32) with SchNet's filter products in ``cfg.filter_mxu``."""
    sparse = {"auto": "auto", "on": True, "off": False}[cfg.sparse_tiles]
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
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
            pair_axis=cfg.pair_axis,
            dtype=dtype,
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
        pair_axis=cfg.pair_axis,
        dtype=dtype,
        filter_mxu=cfg.filter_mxu,
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
    p.add_argument("--num_devices", type=int, default=None,
                   help="data parallelism: one rank per device, started on "
                        "this host (default: one device, one process)")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of rank 0: this host starts its ranks of "
                        "a multi-host run (with --num_processes hosts, this "
                        "one --process_id)")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--local_device_count", type=int, default=None,
                   help="ranks this host starts in a multi-host run "
                        "(default: its cards; one on the CPU)")
    p.add_argument("--dist_backend", default="auto", choices=["auto", "gloo"],
                   help="the ranks' collectives: auto is NCCL on CUDA and gloo "
                        "on the CPU; gloo on CUDA lets ranks share a card")
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
    p.add_argument("--profile_dir", default="",
                   help="pretrain_geossl: write a torch.profiler trace of the "
                        "first epoch into this directory")
    p.add_argument("--use_pallas", default="auto", choices=["auto", "on", "off"],
                   help="the port's kernels: auto/on run them on CUDA, off "
                        "takes the plain versions on any device")
    p.add_argument("--sparse_tiles", default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--grad_accum", type=int, default=1,
                   help="average gradients over k same-shape loader batches "
                        "before each optimizer step")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="k optimizer steps per call, as one CUDA graph replay "
                        "on the card")
    p.add_argument("--ckpt_every", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="resume from <output_model_dir>/state.pth if present")
    return p


def check_ported_args(args, traces: bool = False) -> None:
    """Raise for ``--profile_dir`` unless the calling driver ``traces`` (only
    pretrain_geossl, as in the JAX package); check ``--grad_accum`` and
    ``--steps_per_call``, then :func:`check_chain_args`."""
    if args.profile_dir and not traces:
        raise NotImplementedError(
            "--profile_dir: only pretrain_geossl writes a trace (as in the "
            "JAX package)")
    if args.grad_accum < 1:
        raise ValueError(f"--grad_accum must be >= 1, got {args.grad_accum}")
    if args.steps_per_call < 1:
        raise ValueError(
            f"--steps_per_call must be >= 1, got {args.steps_per_call}")
    check_chain_args(args)


def check_chain_args(args) -> None:
    """``--grad_accum`` and ``--steps_per_call`` both consume groups of
    loader batches; refuse the mix, as the JAX drivers do."""
    if getattr(args, "grad_accum", 1) > 1 and \
            getattr(args, "steps_per_call", 1) > 1:
        raise SystemExit(
            "--grad_accum fuses loader batches into ONE optimizer step; "
            "--steps_per_call fuses optimizer steps into one call — "
            "pick one")


def use_kernels(args) -> bool:
    return args.use_pallas != "off"


# -- ranks ------------------------------------------------------------------------


def in_rank() -> bool:
    """True in a process started as one rank of a run (by
    :func:`start_ranks` or by ``torchrun``: ``RANK`` and ``WORLD_SIZE`` are
    set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def mesh_devices(args) -> int:
    """The ranks a single-host command line asks for: ``--num_devices``
    times ``--pair_devices``."""
    return (args.num_devices or 1) * getattr(args, "pair_devices", 1)


def host_devices(args) -> int:
    """The devices this host offers its ranks: its cards on CUDA (any
    number of ranks with ``--dist_backend gloo``, which lets ranks share a
    card), its cores on the CPU."""
    if torch.device(args.device).type == "cuda" and args.dist_backend != "gloo":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(local_rank: int, module: str, argv: list, env: dict,
               first: int, threads: int) -> None:
    """One rank: its environment, its share of the host's CPU threads, then
    the driver's ``main(argv)``."""
    import importlib

    os.environ.update(env, RANK=str(first + local_rank),
                      LOCAL_RANK=str(local_rank))
    torch.set_num_threads(threads)
    importlib.import_module(module).main(argv)


def start_ranks(args, argv, module: str) -> bool:
    """The launcher: when this command line asks for more than one device
    (``--num_devices``, ``--pair_devices``) or for a multi-host run
    (``--coordinator_address``), start this host's ranks, each running
    ``module``'s ``main(argv)`` in a process of its own (``torch
    .multiprocessing``, spawn), wait for them and return True; a rank that
    fails ends the others and raises here. False in a rank (or under
    ``torchrun``) and for a one-device run: the caller runs the driver.

    A JAX process with L local devices is one launcher here that starts L
    ranks: rank ``process_id * L + l``, world size ``num_processes * L``
    (``--local_device_count`` L, default the host's cards, one on the
    CPU)."""
    if in_rank():
        return False
    argv = list(sys.argv[1:] if argv is None else argv)
    if args.coordinator_address is None and args.num_processes != 1:
        raise ValueError(f"--num_processes {args.num_processes} needs "
                         "--coordinator_address (host:port of rank 0)")
    if args.coordinator_address is not None:
        if args.num_processes < 2:
            raise ValueError(f"--coordinator_address: multi-host needs "
                             f"num_processes >= 2, got {args.num_processes}")
        if not 0 <= args.process_id < args.num_processes:
            raise ValueError(f"process_id {args.process_id} out of range "
                             f"[0, {args.num_processes})")
        local = args.local_device_count or (
            torch.cuda.device_count()
            if torch.device(args.device).type == "cuda" else 1)
        if local < 1:
            raise ValueError(f"--local_device_count {local}: this host has "
                             "no device to start a rank on")
        world, first = args.num_processes * local, args.process_id * local
        host, port = args.coordinator_address.rsplit(":", 1)
    else:
        local = mesh_devices(args)
        if local == 1 and args.num_devices in (None, 1):
            return False
        if args.num_devices is not None and args.num_devices < 1 or \
                local > host_devices(args):
            raise ValueError(
                f"--num_devices {args.num_devices} out of range: this "
                f"process sees {host_devices(args)} device(s)"
                + (f" ({local} ranks with --pair_devices)"
                   if local != (args.num_devices or 1) else ""))
        world, first, host, port = local, 0, "127.0.0.1", str(_free_port())
    env = {"WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(local),
           "MASTER_ADDR": host, "MASTER_PORT": port}
    threads = max(1, torch.get_num_threads() // local)
    torch.multiprocessing.start_processes(
        _rank_main, args=(module, argv, env, first, threads), nprocs=local,
        join=True, start_method="spawn")
    return True


def setup_platform(args):
    """The counterpart of JAX's ``setup_platform``: in a rank, join the
    process group (before the first CUDA use) and make the run's mesh (a
    ``(data, pair)`` mesh with ``--pair_devices``); otherwise no mesh.
    Returns (mesh or None, this rank's device). Refuses ``--steps_per_call``
    above 1 with gloo ranks on CUDA, whose collectives a CUDA graph cannot
    capture."""
    # serve imports this module
    from geossl_tpu_torch.serve import resolve_device

    if not in_rank():
        return pmesh.make_mesh(args.num_devices), resolve_device(args.device)
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = pmesh.rank_device("cuda")
    backend = multihost.backend_for(device, args.dist_backend)
    if backend == "gloo" and device.type == "cuda" and world > 1 \
            and getattr(args, "steps_per_call", 1) > 1:
        raise SystemExit(
            "--steps_per_call > 1 replays CUDA graphs, which cannot capture "
            "gloo collectives: run NCCL ranks (one card each) or "
            "--steps_per_call 1")
    multihost.initialize(
        f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", world,
        rank, device=device, backend=backend)
    pair = getattr(args, "pair_devices", 1)
    if pair > 1:
        from geossl_tpu_torch.parallel.pair_parallel import make_pair_mesh

        num_data = world // pair
        if args.num_devices not in (None, num_data) or num_data * pair != world:
            raise ValueError(f"--num_devices {args.num_devices} x "
                             f"--pair_devices {pair} != the {world} ranks")
        return make_pair_mesh(pair, num_data, device), device
    return pmesh.make_mesh(args.num_devices, device), device


def round_batch_to_mesh(batch_size: int, mesh) -> int:
    """Pad the batch size up to a multiple of the mesh's ranks, so that
    every rank gets whole rows (JAX's ``round_batch_to_mesh``)."""
    return batch_size if mesh is None else \
        batch_size + (-batch_size) % mesh.size


def host_agreement(name: str, value: float) -> None:
    """``multihost.assert_host_agreement`` on the current mesh's device."""
    mesh = pmesh.current()
    if mesh is not None:
        multihost.assert_host_agreement(name, value, mesh.device)


# -- the kernels' limits ----------------------------------------------------------


def kernel_limit_errors(cfg: ModelConfig, *, backward: bool,
                        per_block: bool = True, stack: bool = False) -> list:
    """Each setting of ``cfg`` that a CUDA kernel of the named routes would
    refuse at its first launch, as one line naming the flag and the limit:
    the per-block kernels (``backward``: and their backwards) and the
    backbone's whole-stack kernel. Empty when they all fit. (DDM's NCSN
    head kernels take any --emb_dim: up to 256 in a fixed-width instance,
    above it in the streamed one.)"""
    errors = []

    def need(ok, flag, value, limit):
        if not ok:
            errors.append(f"--{flag} {value}: {limit}")

    if cfg.model_3d == "painn":
        # the per-block PaiNN kernels take any --emb_dim (padded to
        # ops/painn.KERNEL_F, or in column blocks of it) and any
        # --painn_n_rbf from MIN_R (above ONE_PASS_R in streamed passes);
        # the stack pads only
        f, r = painn_ops.KERNEL_F, cfg.painn.n_rbf
        if per_block or stack:
            need(r >= painn_ops.MIN_R, "painn_n_rbf", r,
                 f"the PaiNN kernels take {painn_ops.MIN_R} or more "
                 "(ops/painn.MIN_R)")
        if stack:
            need(cfg.emb_dim <= f, "emb_dim", cfg.emb_dim,
                 f"painn_stack takes up to {f} (ops/painn.KERNEL_F)")
    elif stack:
        # the per-block CFConv kernels take any --num_filters (padded to
        # ops/cfconv.KERNEL_F, or in column blocks of it; the bf16
        # backwards in hidden blocks of it) and any --num_gaussians; the
        # stack pads only
        f, nf = cfconv_ops.KERNEL_F, cfg.schnet.num_filters
        need(nf <= f, "num_filters", nf,
             f"schnet_stack takes up to {f} (ops/cfconv.KERNEL_F)")
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


def check_driver_limits(args, cfg: ModelConfig,
                        device: torch.device) -> None:
    """:func:`check_kernel_limits` for a driver: its per-block kernels, with
    their backwards unless ``--eval_only``; nothing under ``--use_pallas
    off``."""
    if use_kernels(args):
        check_kernel_limits(cfg, device,
                            backward=not getattr(args, "eval_only", False))


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
    count, so its step is saved, not the LambdaLR. The optimizer state is
    saved in its eager form, which runs with and without CUDA graphs
    load alike (``optim.portable_state_dict``)."""
    return {"modules": {k: m.state_dict() for k, m in modules.items()},
            "opt": optim.portable_state_dict(opt), "step": sched.last_epoch}


def try_resume(args, modules: dict, opt, sched,
               higher_is_better: bool = False):
    """Load ``state.pth`` under ``--resume``; returns (start_epoch,
    best_metric, extra scalars); a fresh start's best is the worst value."""
    path = state_path(args)
    if args.resume and path:
        # the resume decision must agree across ranks: without a shared
        # filesystem only rank 0 has state.pth, and a split (rank 0 at epoch
        # N+1, the others at 1) would deadlock the collectives
        host_agreement("resume checkpoint exists", float(os.path.exists(path)))
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


def params_of(opt) -> list:
    return [p for pg in opt.param_groups for p in pg["params"]]


def optimizer_step(opt, sched, body, batches) -> torch.Tensor:
    """One optimizer step: ``body(batches)`` leaves the group's gradients
    in ``.grad`` and returns its outputs; on a mesh they are summed over
    the ranks; then Adam and the schedule."""
    opt.zero_grad(set_to_none=True)
    out = body(batches)
    pmesh.all_reduce_grads(params_of(opt), pmesh.current())
    opt.step()
    sched.step()
    return out


def backward_share(loss: torch.Tensor, group_len: int) -> None:
    """Backward of this rank's share of one batch's loss in a group of
    ``group_len`` (``--grad_accum``): the global batch's loss over the group
    length, and on a mesh over the world size (the ranks' gradients are
    then summed: ``mesh.all_reduce_grads``)."""
    scale = pmesh.loss_scale(pmesh.current())
    share = loss / group_len
    (share if scale == 1 else share / scale).backward()


def pretrain_body(loss_of):
    """``body(batches)`` for :func:`optimizer_step`: the gradients of the
    group's mean loss (as ``--grad_accum`` averages them); ``loss_of(batch)``
    -> (loss, accuracy). Returns [mean loss, mean accuracy] on the device."""
    def body(batches):
        total = 0.0
        for batch in batches:
            loss, acc = loss_of(batch)
            backward_share(loss, len(batches))
            total = total + torch.stack([loss.detach(),
                                         acc.detach().to(loss.dtype)])
        return total / len(batches)
    return body


def pretrain_step(module: nn.Module, opt, sched, batches,
                  loss_of) -> torch.Tensor:
    """One optimizer step over ``batches`` (gradients averaged over the
    group, as ``--grad_accum`` does); ``loss_of(batch)`` -> (loss,
    accuracy). Returns [mean loss, mean accuracy] on the device."""
    return optimizer_step(opt, sched, pretrain_body(loss_of), batches)


# -- several optimizer steps per call -------------------------------------------


def _leaves(batch) -> list:
    """The tensors of a batch dataclass, in field order."""
    if batch is None or isinstance(batch, torch.Tensor):
        return [] if batch is None else [batch]
    return [t for f in dataclasses.fields(batch)
            for t in _leaves(getattr(batch, f.name))]


class ChainStep:
    """``--steps_per_call k``: a call runs one optimizer step per batch of a
    group of up to k same-shape batches (:func:`accum_groups`) and returns
    their outputs stacked, [kk, ...]: the card's counterpart of the JAX
    package's ``make_chain_step`` (k steps in one dispatch). The trajectory
    is k eager steps' (:func:`optimizer_step` with ``body``).

    On CUDA a call is one CUDA graph replay. A graph per (batch shapes,
    group length kk) is captured on first use: kk whole steps (zeroed
    gradients, ``body``'s forward and backward through the kernels'
    autograd Functions, Adam) reading kk static batch slots, into which a
    call copies its batches. All graphs share one memory pool. Adam is made
    capturable (``optim.make_capturable``); each step in a graph copies its
    lr from a device table that a call writes before the replay with the
    schedule's lrs for those steps, plateau scale included, and the
    schedule then moves kk steps on. ``generator`` (the steps' device
    draws) is registered with each graph, so that a replay draws what kk
    eager steps would. The first capture of a shape is preceded by one
    forward and backward on the capture stream (kernel builds and loads,
    cuBLAS workspaces), after which the parameters, the buffers of
    ``modules``, the generator and the zeroed gradients are as before. A
    capture that fails raises: nothing falls back to eager steps on the
    card. Launch counters count the captures, not the replays. On a mesh
    each step's gradient all_reduce is in the graph (NCCL: gloo's cannot be
    captured, and ``setup_platform`` refuses it).

    On other devices the steps run eagerly, one by one.
    """

    def __init__(self, opt, sched, body, device, modules=(), generator=None):
        self.opt, self.sched, self.body = opt, sched, body
        self.device = torch.device(device)
        self.modules = list(modules)
        self.generator = generator
        self._graphs: dict = {}
        self._warm: set = set()
        self._stream = self._pool = None

    def __call__(self, group) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.stack([optimizer_step(self.opt, self.sched,
                                               self.body, [b])
                                for b in group])
        key = (len(group),
               tuple((tuple(t.shape), t.dtype) for t in _leaves(group[0])))
        graph, slots, lrs, out = self._graphs.get(key) or self._capture(
            group, key)
        for slot, batch in zip(slots, group):
            for dst, src in zip(_leaves(slot), _leaves(batch)):
                dst.copy_(src, non_blocking=True)
        # a fresh pinned block per call: the caching host allocator keeps it
        # until its copy is done
        lrs.copy_(torch.tensor(optim.scheduled_lrs(self.sched, len(group)),
                               dtype=torch.float32).pin_memory(),
                  non_blocking=True)
        graph.replay()
        optim.advance(self.sched, len(group))
        return out.clone()  # before the next replay overwrites it

    def _buffers(self):
        return [b for m in self.modules for b in m.buffers()]

    def _warm_up(self, batch) -> None:
        gen_state = None if self.generator is None else \
            self.generator.get_state()
        saved = [b.detach().clone() for b in self._buffers()]
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            self.body([batch])
            self.opt.zero_grad(set_to_none=False)
            with torch.no_grad():
                for b, v in zip(self._buffers(), saved):
                    b.copy_(v)
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        if gen_state is not None:
            self.generator.set_state(gen_state)

    def _capture(self, group, key):
        if self._stream is None:
            optim.make_capturable(self.opt)
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        if key[1] not in self._warm:
            self._warm_up(group[0])
            self._warm.add(key[1])
        slots = [pmesh.map_batch(torch.clone, b) for b in group]
        lrs = torch.zeros((len(group), len(self.opt.param_groups)),
                          dtype=torch.float32, device=self.device)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        # thread_local: a prefetch thread may pin and upload the next batches
        # while this thread captures
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            outs = []
            for i, slot in enumerate(slots):
                # the static .grad tensors zeroed in one launch, not one
                # each (zero_grad's default)
                torch._foreach_zero_([p.grad for pg in self.opt.param_groups
                                      for p in pg["params"]
                                      if p.grad is not None])
                for g, pg in enumerate(self.opt.param_groups):
                    pg["lr"].copy_(lrs[i, g])
                outs.append(self.body([slot]))
                # NCCL's all_reduce is captured with the step
                pmesh.all_reduce_grads(params_of(self.opt), pmesh.current())
                self.opt.step()
            out = torch.stack(outs)
        self._graphs[key] = (graph, slots, lrs, out)
        return self._graphs[key]


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
    host_agreement("start epoch", start_epoch)
    host_agreement("loader length", len(loader))
    plateau = make_plateau(args, extra)
    saver.best_metric = best
    history = []
    # one generator, reseeded per epoch (a CUDA graph keeps drawing from the
    # generator registered with it)
    generator = torch.Generator(device)
    body = pretrain_body(lambda b: loss_of(b, generator))
    chain = None
    if args.steps_per_call > 1:
        chain = ChainStep(opt, sched, body, device, [module], generator)
    for epoch in range(start_epoch, args.epochs + 1):
        timer = EpochTimer()
        generator.manual_seed(hash((args.seed + 1, epoch)) % (2**31))
        tracing = (profiling.trace(args.profile_dir,
                                   cuda=device.type == "cuda")
                   if args.profile_dir and epoch == start_epoch
                   else contextlib.nullcontext())
        with tracing:
            batches = prefetch(loader.epoch(epoch), device)
            if chain is not None:
                steps = [chain(group) for group in
                         accum_groups(batches, args.steps_per_call)]
            else:
                steps = [optimizer_step(opt, sched, body, group)[None]
                         for group in accum_groups(batches, args.grad_accum)]
            steps = torch.cat(steps).tolist()  # one device-to-host copy
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
        if args.profile_dir and epoch == start_epoch:
            print(f"profiler trace written to {args.profile_dir}")
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
    """One JSON line per epoch appended to ``--log_file`` by rank 0 (off
    when the path is empty); non-finite floats become null."""

    def __init__(self, path: str = ""):
        self.path = path

    def log(self, **fields) -> None:
        if not self.path or not multihost.is_main():
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
    fine-tuned ``.pth``, or a JAX ``.ckpt`` of ``--model_3d``'s backbone)
    and, when the file has one, into ``net.graph_pred_linear``; returns the
    loaded checkpoint (``utils/torch_import.load_model_state``; empty
    without the flag). With ``--eval_only`` the head is required."""
    ckpt, has_head = {}, False
    if args.input_model_file:
        ckpt = load_model_state(args.input_model_file,
                                model_config_from_args(args))
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


def finetune_body(net: nn.Module, loss_fn):
    """``body(batches)`` for :func:`optimizer_step`: the gradients of the
    group's mean ``loss_fn(net, batch)`` (as ``--grad_accum`` averages
    them); returns the mean loss on the device."""
    def body(batches):
        total = 0.0
        for batch in batches:
            loss = loss_fn(net, batch)
            backward_share(loss, len(batches))
            total = total + loss.detach()
        return total / len(batches)
    return body


def finetune_step(net: nn.Module, opt, sched, batches, loss_fn):
    """One optimizer step over ``batches`` (gradients averaged over the
    group, as ``--grad_accum`` does); returns the mean loss on the
    device."""
    return optimizer_step(opt, sched, finetune_body(net, loss_fn), batches)


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
    log (each epoch's line with the kernels this process has launched so
    far: ``launches``, by wrapper name).

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
    host_agreement("start epoch", start_epoch)
    host_agreement("loader length", len(train))
    plateau = make_plateau(args, extra)  # pops its keys from extra
    best_epoch = int(extra.pop("best_epoch", -1))
    best_test = extra  # the remaining keys: the test metrics at the best
    history = []
    body = finetune_body(net, loss_fn)
    chain = None
    if args.steps_per_call > 1:
        chain = ChainStep(opt, sched, body, device, [net])
    for epoch in range(start_epoch, args.epochs + 1):
        timer = EpochTimer()
        batches = prefetch(train.epoch(epoch), device)
        if chain is not None:
            losses = [chain(group) for group in
                      accum_groups(batches, args.steps_per_call)]
        else:
            losses = [optimizer_step(opt, sched, body, group)[None]
                      for group in accum_groups(batches, args.grad_accum)]
        losses = torch.cat(losses).tolist()  # one copy per epoch
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
                 time_s=round(timer.elapsed(), 3),
                 launches={k: v for k, v in launch_counts().items() if v})
        if val[key] > best if higher_is_better else val[key] < best:
            best, best_epoch, best_test = val[key], epoch, test
            if args.output_model_dir:
                checkpoints.save_checkpoint(
                    os.path.join(args.output_model_dir, "model.pth"),
                    model_tree(net, ckpt_extra))
                if on_best is not None and multihost.is_main():
                    on_best()
        maybe_save_state(args, {"net": net}, opt, sched, epoch, best,
                         {"best_epoch": best_epoch, **best_test,
                          **(plateau.state() if plateau else {})})
    mlog.log(final=True, best_epoch=best_epoch, **{f"best_val_{key}": best},
             **{f"test_{k}_at_best": v for k, v in best_test.items()})
    return {"best": best, "best_epoch": best_epoch, "best_test": best_test,
            "losses": history}
