"""Per-molecule transforms (the port's copy of ``random_rotation_matrix``,
``random_rotation_transform``, ``morton_order`` and ``spatial_sort_store``
from ``geossl_tpu/data/transforms.py``).

``random_rotation_transform`` is QM9's ``--use_rotation_transform``
augmentation (``MoleculeDatasetQM9.get``, ``datasets_QM9.py:139-140``): a
uniform random rotation of the conformer, drawn from the loader's
generator in the order the JAX loader draws it.

Sorting atoms along a 3D Morton curve makes spatially near atoms index-near,
which gathers the in-cutoff pairs into few tiles of the dense pair grid and
raises the share of all-zero tiles the kernels skip. SchNet is
permutation-equivariant and its readout permutation-invariant, so outputs
change only by the order of f32 sums.
"""

from __future__ import annotations

import numpy as np

from geossl_tpu_torch.data.store import MolRecord, MolStore


def random_rotation_matrix(rng: np.random.Generator) -> np.ndarray:
    """Uniform random rotation: QR of a Gaussian matrix, signs fixed (the
    Haar measure)."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def random_rotation_transform(record: MolRecord,
                              rng: np.random.Generator) -> MolRecord:
    """The record with its positions (and forces) rotated by one draw of
    :func:`random_rotation_matrix`."""
    rot = random_rotation_matrix(rng).astype(np.float32)
    return MolRecord(
        atom_type=record.atom_type,
        positions=record.positions @ rot.T,
        chirality=record.chirality,
        bond_index=record.bond_index,
        y=record.y,
        forces=None if record.forces is None else record.forces @ rot.T,
    )


def morton_order(positions: np.ndarray, bits: int = 10) -> np.ndarray:
    """Atom permutation sorting by the 3D Morton code of the quantized
    coordinates (stable, so ties keep index order)."""
    if positions.size == 0:
        return np.zeros(0, np.int64)
    p = positions - positions.min(axis=0)
    scale = (2**bits - 1) / max(float(p.max()), 1e-9)
    q = (p * scale).astype(np.uint64)
    code = np.zeros(len(q), np.uint64)
    for b in range(bits):
        for axis in range(3):
            code |= ((q[:, axis] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                3 * b + axis)
    return np.argsort(code, kind="stable")


def spatial_sort_transform(record: MolRecord) -> MolRecord:
    """Reorder one record's atoms along the Morton curve."""
    order = morton_order(record.positions)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return MolRecord(
        atom_type=record.atom_type[order],
        positions=record.positions[order],
        chirality=None if record.chirality is None else record.chirality[order],
        bond_index=None if record.bond_index is None else inv[record.bond_index],
        y=record.y,
        forces=None if record.forces is None else record.forces[order],
    )


def spatial_sort_store(store: MolStore) -> MolStore:
    """Morton-sort every molecule of a store once, up front. Molecule order
    is kept, so per-molecule outputs stay in input order."""
    if len(store) == 0:
        return store
    return MolStore.from_records(
        [spatial_sort_transform(store.get(i)) for i in range(len(store))])
