"""Bucketing and padding of molecules into fixed-shape batches (NumPy; the
port's copy of ``pick_bucket``, ``assign_buckets``, ``bucket_chunks``,
``pack_batch`` and ``BucketedLoader`` from ``geossl_tpu/data/bucketing.py``,
without the C++ packer). Every batch is ``[batch_size, n_max]`` for a bucket
size ``n_max``; a partial batch is padded with empty graph slots flagged by
``graph_mask``.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from geossl_tpu_torch.data.batch import DenseMolBatch
from geossl_tpu_torch.data.store import MolRecord, MolStore


def pick_bucket(n: int, bucket_sizes: Sequence[int]) -> int:
    for b in bucket_sizes:
        if n <= b:
            return b
    raise ValueError(f"molecule with {n} atoms exceeds largest bucket "
                     f"{bucket_sizes[-1]}")


def assign_buckets(sizes: np.ndarray, bucket_sizes: Sequence[int]) -> np.ndarray:
    """Vectorized :func:`pick_bucket`; oversized entries raise with the size
    histogram."""
    ladder = np.asarray(sorted(bucket_sizes))
    slot = np.searchsorted(ladder, sizes)
    if (slot >= len(ladder)).any():
        edges = np.concatenate([[0], ladder, [int(sizes.max())]])
        hist, _ = np.histogram(sizes, bins=edges)
        bands = ", ".join(f"≤{int(e)}: {int(c)}" for e, c in zip(edges[1:], hist))
        raise ValueError(
            f"{int((slot >= len(ladder)).sum())} molecules exceed the largest "
            f"bucket {int(ladder[-1])} (max {int(sizes.max())} atoms; size "
            f"histogram {bands}). Extend the bucket ladder, e.g. --bucket "
            f"{' '.join(str(int(b)) for b in ladder)} "
            f"{int(2 ** np.ceil(np.log2(sizes.max())))}")
    return ladder[slot]


def bucket_chunks(bucket_of, batch_size, rng):
    """Per-bucket index chunks, shuffled within each bucket, with the
    epoch's batch order shuffled across buckets (the reference DataLoader's
    uniform shuffle in distribution)."""
    chunks = []
    for bucket in np.unique(bucket_of):
        idx = rng.permutation(np.where(bucket_of == bucket)[0])
        for s in range(0, len(idx), batch_size):
            chunks.append((int(bucket), idx[s:s + batch_size]))
    if len(chunks) > 1:
        chunks = [chunks[i] for i in rng.permutation(len(chunks))]
    return chunks


def pack_batch(records: Sequence[MolRecord], n_max: int,
               batch_size: Optional[int] = None) -> DenseMolBatch:
    """Pad molecules into one DenseMolBatch of CPU tensors;
    ``batch_size > len(records)`` adds empty graph slots."""
    b = batch_size or len(records)
    if len(records) > b:
        raise ValueError(f"{len(records)} records exceed batch_size {b}")
    atom_type = np.zeros((b, n_max), np.int32)
    positions = np.zeros((b, n_max, 3), np.float32)
    node_mask = np.zeros((b, n_max), bool)
    graph_mask = np.zeros((b,), bool)
    ys = None
    for i, r in enumerate(records):
        n = r.num_atoms
        atom_type[i, :n] = r.atom_type
        positions[i, :n] = r.positions
        node_mask[i, :n] = True
        graph_mask[i] = True
        if r.y is not None:
            if ys is None:
                ys = np.zeros((b, np.atleast_1d(r.y).shape[0]), np.float32)
            ys[i] = np.atleast_1d(r.y)
    return DenseMolBatch(
        atom_type=torch.from_numpy(atom_type).long(),
        positions=torch.from_numpy(positions),
        node_mask=torch.from_numpy(node_mask),
        y=None if ys is None else torch.from_numpy(ys),
        graph_mask=torch.from_numpy(graph_mask),
    )


class BucketedLoader:
    """Iterate a MolStore as padded batches: molecules go to the smallest
    bucket that fits, batches are same-bucket, and the epoch's batch order
    is shuffled across buckets. One epoch is deterministic per
    ``(seed, epoch)``: the same NumPy stream as the JAX package's loader
    (shuffling, no dropped batches) feeds the shuffle and then the
    transform (e.g. BFS masking)."""

    def __init__(self, store: MolStore, batch_size: int,
                 bucket_sizes: Sequence[int], seed: int = 0,
                 transform: Optional[Callable[[MolRecord, np.random.Generator],
                                              MolRecord]] = None):
        self.store = store
        self.batch_size = batch_size
        self.seed = seed
        self.transform = transform
        self._bucket_of = assign_buckets(store.num_atoms(), sorted(bucket_sizes))

    def __len__(self) -> int:
        _, counts = np.unique(self._bucket_of, return_counts=True)
        return int(sum(-(-c // self.batch_size) for c in counts))

    def epoch(self, epoch: int) -> Iterator[DenseMolBatch]:
        """One epoch of batches (CPU tensors)."""
        rng = np.random.default_rng((self.seed, epoch))
        for bucket, chunk in bucket_chunks(self._bucket_of, self.batch_size,
                                           rng):
            records = [self.store.get(int(i)) for i in chunk]
            if self.transform is not None:
                records = [self.transform(r, rng) for r in records]
            yield pack_batch(records, bucket, self.batch_size)
