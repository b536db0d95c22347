"""Pair-grid model parallelism: the O(N²) message computation split over
ranks (counterpart of ``geossl_tpu/parallel/pair_parallel.py``).

Each of the ``num_pair`` ranks of a data index holds the same rows and the
whole node path (embeddings, dense layers, readout: O(N·F²), replicated);
for the message pass it takes its contiguous j-stripe of the ``[B, N, N]``
pair grid, runs the plain-mode kernels on the rectangular ``[B, N, N/D]``
stripe (CFConv's ``cfconv_fwd``/``cfconv_bwd``, PaiNN's
``painn_fwd``/``painn_bwd``: a stripe is not symmetric, so the symmetric
kernels never run here), and one differentiable ``all_reduce`` over the pair
group (:func:`pair_sum`) restores the full per-node messages, as the JAX
package's ``psum`` does.

Gradients: every rank takes the gradient of the global loss over the world
size and the gradients are summed over every rank (``mesh.all_reduce_grads``).
The node path's gradients are then each rank's share of one replicated
computation, summed back to one; the filter weights' are the stripes'
partials, summed to the whole. The all_reduce's backward (itself an
all_reduce) gives each stripe the full cotangent of the messages. JAX gets
the same from ``shard_map``'s transposes.

The backbones opt in through ``ModelConfig.pair_axis`` (``"pair"``, the JAX
name): ``models/schnet.InteractionBlock`` and ``models/painn
.PaiNNInteraction`` then run their message pass on stripes. Composes with
data parallelism on a ``(data, pair)`` mesh, over which ``mesh.sharded``
runs a module as JAX's ``pair_sharded_apply`` does. Driver surface:
``finetune_lba --pair_devices K``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from geossl_tpu_torch.parallel import mesh as pmesh

PAIR_AXIS = "pair"


def make_pair_mesh(num_pair: int, num_data: int = 1,
                   device=None) -> pmesh.Mesh:
    """A ``(data, pair)`` mesh over the process group's ranks, rank =
    data_index * num_pair + pair_index; needs ``num_data * num_pair``
    ranks. Makes one data group per pair index and one pair group per data
    index (every rank takes part in making each). Becomes
    ``mesh.current()``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = num_data * num_pair
    if num_pair < 1 or num_data < 1 or world != n:
        raise ValueError(f"need {n} devices, have {world}")
    rank = dist.get_rank()
    data_groups = [dist.new_group([d * num_pair + p for d in range(num_data)])
                   for p in range(num_pair)]
    pair_groups = [dist.new_group([d * num_pair + p for p in range(num_pair)])
                   for d in range(num_data)]
    return pmesh.activate(pmesh.Mesh(
        n, rank, pmesh.rank_device(device), num_pair,
        data_groups[rank % num_pair], pair_groups[rank // num_pair]))


def local_stripe(n: int, mesh: Optional[pmesh.Mesh] = None):
    """(start, length) of this rank's contiguous j-stripe of an ``n``-wide
    pair-grid axis. Shared by the backbones' ``pair_axis`` paths."""
    mesh = pmesh.current() if mesh is None else mesh
    if mesh is None:
        raise ValueError("pair_axis needs a pair mesh (make_pair_mesh)")
    d = mesh.num_pair
    if n % d:
        raise ValueError(
            f"pair_axis sharding needs N % axis_size == 0; "
            f"got N={n}, axis {PAIR_AXIS!r} size {d}")
    nloc = n // d
    return mesh.pair_index * nloc, nloc


def pair_sum(x: torch.Tensor,
             mesh: Optional[pmesh.Mesh] = None) -> torch.Tensor:
    """The stripes' partial messages summed over the pair group,
    differentiable (JAX's ``psum`` over ``"pair"``)."""
    mesh = pmesh.current() if mesh is None else mesh
    return pmesh.all_reduce_sum(x, mesh.pair_group)


def stripe(t: torch.Tensor, j0: int, nloc: int, dim: int) -> torch.Tensor:
    """``t``'s columns ``j0 .. j0 + nloc`` along ``dim``, contiguous (the
    kernels read contiguous operands)."""
    return t.narrow(dim, j0, nloc).contiguous()

