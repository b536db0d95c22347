"""Multi-process running (counterpart of
``geossl_tpu/parallel/multihost.py``).

The JAX package runs one process per host, each owning its local devices,
and ``jax.distributed`` joins them into one global mesh. The port runs one
process per device (a *rank*), joined by ``torch.distributed``: NCCL
between cards, gloo on the CPU (or, asked for, between ranks that share a
card). A JAX process with L local devices becomes, here, one launcher per
host that starts L ranks (``train/common.start_ranks``); the world size is
the global device count, as the JAX mesh's is.

* :func:`initialize` joins this rank to the group with a finite timeout,
  so that a dead peer ends the survivors instead of hanging them, and
  registers a bounded exit barrier (:func:`_sync_before_shutdown`).
* :func:`is_main`: host-side side effects (checkpoints, ``model.pth``,
  ``--log_file``) are rank 0's.
* :func:`assert_host_agreement` fails fast when a host-side decision (a
  resume, an epoch counter, a loader's length) differs across ranks.

A rank's rows of the global batch are ``mesh.shard_batch``'s.
"""

from __future__ import annotations

import atexit
import datetime
import threading

import torch
import torch.distributed as dist

# The collectives' timeout: a rank waits this long for a peer (its kernel
# builds included) before the group gives up on it.
TIMEOUT_S = 300.0
# How long the exit barrier waits for the other ranks.
EXIT_SYNC_S = 60.0


def backend_for(device: torch.device, backend: str = "auto") -> str:
    """'nccl' for a CUDA device, 'gloo' for the CPU, unless named."""
    if backend != "auto":
        return backend
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device=None, backend: str = "auto",
               timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group as rank ``process_id`` of ``num_processes``,
    rendezvousing at ``coordinator_address`` (``host:port``; rank 0 listens
    there), with the JAX function's argument checks. ``device``: this
    rank's device (the backend follows it: :func:`backend_for`). Every
    collective fails after ``timeout_s`` without its peers."""
    if num_processes < 1:
        raise ValueError(f"multi-host needs num_processes >= 1, got "
                         f"{num_processes}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of range "
                         f"[0, {num_processes})")
    device = torch.device("cpu" if device is None else device)
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend_for(device, backend) == "nccl":
            kw["device_id"] = device
    dist.init_process_group(
        backend_for(device, backend), init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    atexit.register(_sync_before_shutdown)


def _sync_before_shutdown(timeout_s: float = EXIT_SYNC_S) -> None:
    """Align the ranks before the group is torn down (rank 0 writes its
    final checkpoints after the others are done), then destroy it. Bounded:
    a peer that died leaves the barrier blocked, so it runs in a daemon
    thread and is given up after ``timeout_s``."""
    if not dist.is_initialized():
        return

    def sync():
        try:
            dist.barrier()
        except Exception:
            pass  # a peer is gone: its error was reported where it died

    t = threading.Thread(target=sync, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        print(f"[multihost] exit sync timed out after {timeout_s:.0f}s "
              "(peer unreachable?); proceeding to shutdown", flush=True)
        return
    dist.destroy_process_group()


def is_main() -> bool:
    """True on the rank that owns host-side side effects (checkpoint and
    metric-file writes; epoch lines print on every rank)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def assert_host_agreement(name: str, value: float, device=None) -> None:
    """Fail fast when a host-side decision differs across ranks.

    Resume decisions, epoch counters and loader lengths are made from
    rank-local state (``os.path.exists`` on a checkpoint that only rank 0
    wrote); if ranks disagree, their steps issue mismatched collectives
    that hang or corrupt the run. This gathers the scalar from every rank
    (on ``device``: a CUDA tensor under NCCL) and raises an actionable
    error instead. No-op without a process group."""
    if not dist.is_initialized():
        return
    world, rank = dist.get_world_size(), dist.get_rank()
    vals = torch.zeros(world, dtype=torch.float64,
                       device="cpu" if device is None else device)
    vals[rank] = float(value)
    dist.all_reduce(vals)
    vals = vals.cpu().tolist()
    if any(v != vals[0] for v in vals):
        raise SystemExit(
            f"multi-host desync: {name!r} differs across processes "
            f"(per-process values {vals}). Typical cause: --resume with "
            "--output_model_dir on a non-shared filesystem — only rank 0 "
            "has state.pth. Put the output dir on storage every process "
            "can read, or drop --resume.")

