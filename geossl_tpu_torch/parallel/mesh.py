"""Data parallelism over ranks, one device each (counterpart of
``geossl_tpu/parallel/mesh.py``), and the batch prefetch through which
every driver's training and eval loop takes its batches.

The JAX package jits each step over a 1-D ``data`` mesh: parameters
replicated, the batch's leading axis sharded, the gradient psum inserted
by XLA. The port runs one process per device, joined by
``torch.distributed`` (NCCL on CUDA, gloo on the CPU), and keeps the
property the JAX tests pin: k ranks give the one-process trajectory.

* Every rank packs and uploads the same global batch (the loaders are
  seed-deterministic) and draws the global batch's random numbers from one
  generator, so its draws are the one process's draws.
* The backbone runs on this rank's rows only (:func:`shard_batch`); its
  outputs come back to the global batch through :func:`gather_rows`, a
  differentiable gather. The loss is then the global batch's loss on every
  rank, exactly as one process computes it.
* Each rank takes the gradient of that loss divided by the world size
  (:func:`loss_scale`), and one ``all_reduce`` over a flat buffer sums the
  gradients (:func:`all_reduce_grads`): the gather's backward sums the
  cotangents of every rank's rows, so the sum is the one process's
  gradient. (``DistributedDataParallel`` would average per-rank means,
  which is wrong wherever a rank's rows hold another count of real graphs
  than another's.)

A mesh may also have a pair axis (``parallel/pair_parallel.py``): the
ranks of one data index hold the same rows and split the pair grid
between them.

Without a process group (one process, no ``--num_devices``) there is no
mesh and nothing here issues a collective. With one (even of one rank)
every collective runs, so that a world of one exercises the same code.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Optional

import torch
import torch.distributed as dist

# how long the producer waits on a full queue before it looks again whether
# the consumer has stopped
_PUT_POLL_S = 0.1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a run: ``size`` ranks, this one ``rank``, on ``device``;
    a ``(data, pair)`` layout with ``num_pair`` ranks per data index (rank =
    data_index * num_pair + pair_index, JAX's ``make_pair_mesh`` order).
    ``data_group`` joins the ranks of this rank's pair index (they hold
    different rows), ``pair_group`` those of its data index (same rows,
    different stripes); both are the world group when ``num_pair`` is 1
    (resp. ``size`` is ``num_pair``)."""

    size: int
    rank: int
    device: torch.device
    num_pair: int = 1
    data_group: object = None
    pair_group: object = None

    @property
    def num_data(self) -> int:
        return self.size // self.num_pair

    @property
    def data_index(self) -> int:
        return self.rank // self.num_pair

    @property
    def pair_index(self) -> int:
        return self.rank % self.num_pair


_ACTIVE: Optional[Mesh] = None


def current() -> Optional[Mesh]:
    """The mesh the running process belongs to (set by :func:`make_mesh` and
    ``pair_parallel.make_pair_mesh``), or None without a process group."""
    return _ACTIVE


def activate(mesh: Optional[Mesh]) -> Optional[Mesh]:
    global _ACTIVE
    _ACTIVE = mesh
    return mesh


def make_mesh(num_devices: Optional[int] = None,
              device=None) -> Optional[Mesh]:
    """The data mesh of this process, the counterpart of JAX's
    ``make_mesh``: every rank of the process group (a rank is a device).
    Without a process group a run is one process on one device and the
    result is None (``num_devices`` must then be None or 1: ranks are
    started by the launcher, ``train/common.start_ranks``). ``device``:
    this rank's device (default: ``cuda:<LOCAL_RANK>``; the CPU only when
    asked for, :func:`rank_device`). The mesh becomes :func:`current`."""
    if not dist.is_initialized():
        if num_devices is not None and num_devices != 1:
            raise ValueError(
                f"--num_devices {num_devices} out of range: this process "
                "runs one device; start one rank per device (--num_devices "
                "on a driver's command line, torchrun, or "
                "multihost.initialize)")
        return activate(None)
    world = dist.get_world_size()
    if num_devices is not None:
        if world > 1 and num_devices != world:
            raise ValueError(
                f"--num_devices {num_devices} != the {world} global "
                "devices: a multi-process mesh must include every process's "
                "devices (a prefix slice would leave some processes without "
                "rows)")
        if not 1 <= num_devices <= world:
            raise ValueError(
                f"--num_devices {num_devices} out of range: this process "
                f"sees {world} device(s)")
    group = dist.group.WORLD
    return activate(Mesh(world, dist.get_rank(), rank_device(device), 1,
                         group, group))


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when it names one (``"cpu"``, or
    ``cuda:<i>``), else ``cuda:<LOCAL_RANK mod the card count>``. Raises
    when a card is wanted and none is visible: the CPU is used only when it
    is asked for."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: pass device='cpu' (--device cpu) to "
            "run this rank on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def map_batch(fn, batch):
    """``batch`` (a tensor, None, or a batch dataclass, possibly nested)
    with ``fn`` applied to each tensor."""
    if batch is None or isinstance(batch, torch.Tensor):
        return None if batch is None else fn(batch)
    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{
            f.name: map_batch(fn, getattr(batch, f.name))
            for f in dataclasses.fields(batch)})
    if isinstance(batch, (tuple, list)):
        return type(batch)(map_batch(fn, b) for b in batch)
    return batch


def row_range(mesh: Mesh, rows: int) -> tuple:
    """(start, stop) of this rank's rows of a ``rows``-row global batch."""
    if rows % mesh.num_data:
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{mesh.num_data} data ranks (round the batch "
                         "size to the mesh: common.round_batch_to_mesh)")
    per = rows // mesh.num_data
    return mesh.data_index * per, (mesh.data_index + 1) * per


def shard_batch(mesh: Optional[Mesh], batch):
    """This rank's rows of the global ``batch`` (tensors, batch
    dataclasses, tuples of them; the leading axis is the batch's), as
    views; the batch itself without a mesh (JAX's ``shard_batch``, where a
    process uploads its own rows: here every rank holds the global batch,
    whose host-side tensors are small beside a step's activations)."""
    if mesh is None or mesh.num_data == 1:
        return batch

    def rows(t):
        start, stop = row_range(mesh, t.shape[0])
        return t[start:stop]
    return map_batch(rows, batch)


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce`` (sum) over ``group``; its backward is the same
    all_reduce of the cotangent (every rank's output is the sum, so every
    rank's input reaches every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global batch's ``x`` from every data rank's rows (this rank's
    rows are ``x``), differentiable: the cotangent of a rank's rows is the
    sum of every rank's cotangent of them. Built as an all_reduce of the
    rows placed in zeros, so that every backend (gloo on the CPU and on
    CUDA, NCCL, a CUDA graph) runs it and the gathered values are the rows'
    exactly."""
    if mesh is None:
        return x
    per = x.shape[0]
    before = mesh.data_index * per
    after = (mesh.num_data - mesh.data_index - 1) * per
    pad = [x.new_zeros((n,) + x.shape[1:]) for n in (before, after)]
    return all_reduce_sum(torch.cat([pad[0], x, pad[1]]), mesh.data_group)


def sharded(fn, *args, mesh: Optional[Mesh] = None):
    """``fn`` on this rank's rows of ``args`` (:func:`shard_batch`), its
    outputs (a tensor or a tuple of tensors, rows first) gathered back to
    the global batch (:func:`gather_rows`). Without a mesh: ``fn(*args)``.
    Every driver's forward runs through it, so a rank's evaluation outputs
    are the global batch's (JAX's ``fetch`` of a batch-sharded output); on a
    ``(data, pair)`` mesh it is JAX's ``pair_sharded_apply``, the backbone's
    ``pair_axis`` path splitting each data rank's pair grid."""
    mesh = current() if mesh is None else mesh
    if mesh is None:
        return fn(*args)
    out = fn(*shard_batch(mesh, args))
    if isinstance(out, torch.Tensor):
        return gather_rows(out, mesh)
    return type(out)(gather_rows(t, mesh) for t in out)


def loss_scale(mesh: Optional[Mesh]) -> int:
    """What each rank divides the global loss by before its backward: the
    world size (the gradients are then summed)."""
    return 1 if mesh is None else mesh.size


def all_reduce_grads(params, mesh: Optional[Mesh]) -> None:
    """Sum the ``.grad`` of ``params`` over every rank, in one all_reduce
    of one flat buffer (capturable in a CUDA graph under NCCL). The
    parameters without a gradient are left out (the same on every rank:
    every rank runs the same graph)."""
    if mesh is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    torch._foreach_copy_(
        grads, [v.view_as(g) for v, g in zip(flat.split(
            [g.numel() for g in grads]), grads)])


def put_replicated(mesh: Optional[Mesh], module: torch.nn.Module):
    """Every parameter and buffer of ``module`` broadcast from rank 0 (at
    start-up: the ranks then begin from one set of weights, whatever each
    drew or loaded). Returns ``module``."""
    if mesh is None:
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def prefetch(batch_iterator, device, size: int = 2):
    """Yield the batches of ``batch_iterator`` on ``device``, in order,
    packed and uploaded up to ``size`` batches ahead.

    A daemon thread drains the iterator (so the C++ packer, which releases
    the interpreter lock, runs beside the training loop), pins each batch
    on CUDA and uploads it with ``non_blocking`` on the consumer's current
    stream: the host never waits for a copy, and the caching host allocator
    keeps each pinned block until its copy is done. On the CPU the thread
    runs the iterator and the batches stay where they are. The thread is
    the iterator's only consumer, so its RNG draws (shuffle, masking) are
    the plain loop's. An exception in the producer is raised here; closing
    this generator (``close()``, a ``break``, garbage collection) stops the
    thread within ``_PUT_POLL_S`` of its current batch.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.current_stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        # a bounded put that gives up once the consumer has stopped
        # (otherwise the thread would block forever on a full queue)
        while not stop.is_set():
            try:
                q.put(item, timeout=_PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in batch_iterator:
                if cuda:
                    with torch.cuda.stream(stream):
                        batch = batch.pin_memory().to(device,
                                                      non_blocking=True)
                if not put(batch):
                    return
        except BaseException as e:  # raised on the consumer's side
            put(e)
            return
        put(end)

    thread = threading.Thread(target=producer, name="geossl-prefetch",
                              daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
