"""MolStore — the cached on-disk dataset format (the port's own copy of
``geossl_tpu/data/store.py``; reads and writes the same ``.npz`` files).

One ``.npz`` holds every molecule's arrays concatenated along the atom/bond
axis plus offset tables; ``get(i)`` slices per-molecule views.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

_OPTIONAL = ("chirality", "bond_index", "bond_offsets", "y", "forces")


@dataclass
class MolRecord:
    atom_type: np.ndarray  # [N] int32
    positions: np.ndarray  # [N, 3] f32
    chirality: Optional[np.ndarray] = None  # [N] int32
    bond_index: Optional[np.ndarray] = None  # [2, E] int32
    y: Optional[np.ndarray] = None  # [T] f32
    forces: Optional[np.ndarray] = None  # [N, 3] f32

    @property
    def num_atoms(self) -> int:
        return int(self.atom_type.shape[0])


class MolStore:
    """A list of molecules backed by flat arrays."""

    def __init__(self, atom_type, positions, offsets, chirality=None,
                 bond_index=None, bond_offsets=None, y=None, forces=None):
        self.atom_type = atom_type
        self.positions = positions
        self.offsets = offsets  # [M+1]
        self.chirality = chirality
        self.bond_index = bond_index  # [2, sumE]
        self.bond_offsets = bond_offsets  # [M+1]
        self.y = y  # [M, T]
        self.forces = forces  # [sumN, 3]

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def num_atoms(self) -> np.ndarray:
        return np.diff(self.offsets)

    def get(self, i: int) -> MolRecord:
        s, e = self.offsets[i], self.offsets[i + 1]
        bond = None
        if self.bond_index is not None:
            bond = self.bond_index[:, self.bond_offsets[i]:self.bond_offsets[i + 1]]
        return MolRecord(
            atom_type=self.atom_type[s:e],
            positions=self.positions[s:e],
            chirality=None if self.chirality is None else self.chirality[s:e],
            bond_index=bond,
            y=None if self.y is None else self.y[i],
            forces=None if self.forces is None else self.forces[s:e],
        )

    def __getitem__(self, i: int) -> MolRecord:
        return self.get(i)

    @staticmethod
    def from_records(records: List[MolRecord]) -> "MolStore":
        offsets = np.zeros(len(records) + 1, np.int64)
        np.cumsum([r.num_atoms for r in records], out=offsets[1:])
        atom_type = np.concatenate([r.atom_type for r in records]).astype(np.int32)
        positions = np.concatenate([r.positions for r in records]).astype(np.float32)
        chirality = None
        if records[0].chirality is not None:
            chirality = np.concatenate([r.chirality for r in records]).astype(np.int32)
        bond_index = bond_offsets = None
        if records[0].bond_index is not None:
            bond_offsets = np.zeros(len(records) + 1, np.int64)
            np.cumsum([r.bond_index.shape[1] for r in records], out=bond_offsets[1:])
            bond_index = np.concatenate(
                [r.bond_index for r in records], axis=1).astype(np.int32)
        y = None
        if records[0].y is not None:
            y = np.stack([np.atleast_1d(r.y) for r in records]).astype(np.float32)
        forces = None
        if records[0].forces is not None:
            forces = np.concatenate([r.forces for r in records]).astype(np.float32)
        return MolStore(atom_type, positions, offsets, chirality, bond_index,
                        bond_offsets, y, forces)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        arrays = dict(atom_type=self.atom_type, positions=self.positions,
                      offsets=self.offsets)
        for name in _OPTIONAL:
            v = getattr(self, name)
            if v is not None:
                arrays[name] = v
        np.savez(path, **arrays)

    @staticmethod
    def load(path: str) -> "MolStore":
        z = np.load(path, allow_pickle=False)
        opt = {k: (z[k] if k in z.files else None) for k in _OPTIONAL}
        return MolStore(atom_type=z["atom_type"], positions=z["positions"],
                        offsets=z["offsets"], **opt)
