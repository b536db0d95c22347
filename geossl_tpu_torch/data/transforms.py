"""Spatial sorting of molecules (the port's copy of ``morton_order`` and
``spatial_sort_store`` from ``geossl_tpu/data/transforms.py``).

Sorting atoms along a 3D Morton curve makes spatially near atoms index-near,
which gathers the in-cutoff pairs into few tiles of the dense pair grid and
raises the share of all-zero tiles the kernels skip. SchNet is
permutation-equivariant and its readout permutation-invariant, so outputs
change only by the order of f32 sums.
"""

from __future__ import annotations

import numpy as np

from geossl_tpu_torch.data.store import MolRecord, MolStore


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
