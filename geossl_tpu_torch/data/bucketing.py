"""Bucketing and padding of molecules into fixed-shape batches (the port's
copy of ``pick_bucket``, ``assign_buckets``, ``bucket_chunks``,
``find_native_packer``, ``pack_batch`` and ``BucketedLoader`` from
``geossl_tpu/data/bucketing.py``). Every batch is ``[batch_size, n_max]``
for a bucket size ``n_max``; a partial batch is padded with empty graph
slots flagged by ``graph_mask``.

The loader packs through the C++ host runtime (``native/packing``) where
the JAX package's loader does: straight from the store's flat arrays when
there is no transform or the transform is the BFS mask (fused in C++), and
``with_forces`` is off. :func:`pack_batch` (NumPy) is the plain version: it
packs the record path (other transforms, MD17's forces) and everything
under ``GEOSSL_NO_NATIVE=1``.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from geossl_tpu_torch.data.batch import DenseMolBatch
from geossl_tpu_torch.data.store import MolRecord, MolStore
from geossl_tpu_torch.native import packing


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


def bucket_chunks(bucket_of, batch_size, rng, shuffle=True, drop_last=False):
    """Per-bucket index chunks. With ``shuffle`` each bucket is shuffled and
    the epoch's batch order is shuffled across buckets (the reference
    DataLoader's uniform shuffle in distribution); without it the chunks
    keep store order, bucket by bucket. ``drop_last`` leaves out each
    bucket's partial last chunk."""
    chunks = []
    for bucket in np.unique(bucket_of):
        idx = np.where(bucket_of == bucket)[0]
        if shuffle:
            idx = rng.permutation(idx)
        for s in range(0, len(idx), batch_size):
            chunk = idx[s:s + batch_size]
            if drop_last and len(chunk) < batch_size:
                continue
            chunks.append((int(bucket), chunk))
    if shuffle and len(chunks) > 1:
        chunks = [chunks[i] for i in rng.permutation(len(chunks))]
    return chunks


def find_native_packer():
    """The C++ packer (``native/packing``, built and loaded here on first
    use; a failed build raises), or None under ``GEOSSL_NO_NATIVE=1``."""
    if not packing.enabled():
        return None
    packing.load()
    return packing


def native_batch(packed) -> DenseMolBatch:
    """The DenseMolBatch of the native packer's arrays (atom types as
    int64, as :func:`pack_batch` gives them)."""
    at, pos, nm, gm, y = packed
    return DenseMolBatch(
        atom_type=torch.from_numpy(at).long(),
        positions=torch.from_numpy(pos),
        node_mask=torch.from_numpy(nm),
        y=None if y is None else torch.from_numpy(y),
        graph_mask=torch.from_numpy(gm))


def pack_batch(records: Sequence[MolRecord], n_max: int,
               batch_size: Optional[int] = None,
               with_forces: bool = False) -> DenseMolBatch:
    """Pad molecules into one DenseMolBatch of CPU tensors;
    ``batch_size > len(records)`` adds empty graph slots. ``with_forces``
    packs the records' forces too (zeros where a record has none)."""
    b = batch_size or len(records)
    if len(records) > b:
        raise ValueError(f"{len(records)} records exceed batch_size {b}")
    atom_type = np.zeros((b, n_max), np.int32)
    positions = np.zeros((b, n_max, 3), np.float32)
    node_mask = np.zeros((b, n_max), bool)
    graph_mask = np.zeros((b,), bool)
    ys = None
    forces = np.zeros((b, n_max, 3), np.float32) if with_forces else None
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
        if with_forces and r.forces is not None:
            forces[i, :n] = r.forces
    return DenseMolBatch(
        atom_type=torch.from_numpy(atom_type).long(),
        positions=torch.from_numpy(positions),
        node_mask=torch.from_numpy(node_mask),
        y=None if ys is None else torch.from_numpy(ys),
        graph_mask=torch.from_numpy(graph_mask),
        forces=None if forces is None else torch.from_numpy(forces),
    )


class BucketedLoader:
    """Iterate a MolStore as padded batches: molecules go to the smallest
    bucket that fits, batches are same-bucket, and the epoch's batch order
    is shuffled across buckets (``shuffle=False``: store order, as the
    fine-tunes' eval loaders). One epoch is deterministic per
    ``(seed, epoch)``: the same NumPy stream as the JAX package's loader
    (no dropped batches) feeds the shuffle and then the transform (e.g. BFS
    masking). ``with_forces`` packs MD17's forces into each batch (the JAX
    loader's flag, which also turns the C++ packer off). Without a
    transform, or with the BFS mask (a transform that carries
    ``bfs_mask_ratio``), and without forces, the C++ packer packs straight
    from the store (the fused BFS pack draws one seed per batch from the
    epoch's stream, as the JAX package's default path does); otherwise each
    record goes through the transform and :func:`pack_batch`."""

    def __init__(self, store: MolStore, batch_size: int,
                 bucket_sizes: Sequence[int], seed: int = 0,
                 transform: Optional[Callable[[MolRecord, np.random.Generator],
                                              MolRecord]] = None,
                 shuffle: bool = True, with_forces: bool = False):
        self.store = store
        self.batch_size = batch_size
        self.seed = seed
        self.transform = transform
        self.shuffle = shuffle
        self.with_forces = with_forces
        self._bucket_of = assign_buckets(store.num_atoms(), sorted(bucket_sizes))
        self._bfs_ratio = getattr(transform, "bfs_mask_ratio", None)
        self._native = None
        # a store without bonds masks per record, as the JAX loader does
        if (transform is None or (self._bfs_ratio is not None
                                  and store.bond_index is not None)) \
                and not with_forces:
            self._native = find_native_packer()
        if self._native is not None:
            self._flat = self._native.StoreArrays(
                store, bonds=self._bfs_ratio is not None)

    def __len__(self) -> int:
        _, counts = np.unique(self._bucket_of, return_counts=True)
        return int(sum(-(-c // self.batch_size) for c in counts))

    def epoch(self, epoch: int) -> Iterator[DenseMolBatch]:
        """One epoch of batches (CPU tensors)."""
        rng = np.random.default_rng((self.seed, epoch))
        for bucket, chunk in bucket_chunks(self._bucket_of, self.batch_size,
                                           rng, self.shuffle):
            if self._native is not None:
                if self._bfs_ratio is not None:
                    yield native_batch(self._native.pack_batch_bfs_from_store(
                        self._flat, chunk, bucket, self.batch_size,
                        self._bfs_ratio, rng))
                else:
                    yield native_batch(self._native.pack_batch_from_store(
                        self._flat, chunk, bucket, self.batch_size))
                continue
            records = [self.store.get(int(i)) for i in chunk]
            if self.transform is not None:
                records = [self.transform(r, rng) for r in records]
            yield pack_batch(records, bucket, self.batch_size,
                             self.with_forces)
