"""Synthetic molecular datasets for tests and the chip smoke run (the port's
copy of the generators in ``geossl_tpu/data/synthetic.py``: the same seed
gives the same arrays)."""

from __future__ import annotations

import numpy as np

from geossl_tpu_torch.data.store import MolRecord, MolStore

_ELEMENT_PROBS = np.array([0.5, 0.33, 0.06, 0.08, 0.01, 0.005, 0.005, 0.005, 0.005])


def _random_molecule(rng: np.random.Generator, n_atoms: int) -> MolRecord:
    # QM9-like element frequencies over the 9-way index code
    probs = _ELEMENT_PROBS / _ELEMENT_PROBS.sum()
    atom_type = rng.choice(9, size=n_atoms, p=probs).astype(np.int32)
    # a random walk, so distances look bond-like (~1.5 Å)
    steps = rng.normal(scale=0.9, size=(n_atoms, 3))
    steps[0] = 0
    positions = np.cumsum(steps, axis=0).astype(np.float32)
    positions += rng.normal(scale=0.2, size=(n_atoms, 3)).astype(np.float32)
    # spanning-tree bonds (chain with random reattachment), both directions
    edges = []
    for i in range(1, n_atoms):
        j = int(rng.integers(0, i))
        edges += [(i, j), (j, i)]
    bond_index = (np.asarray(edges, np.int32).T.reshape(2, -1) if edges
                  else np.zeros((2, 0), np.int32))
    return MolRecord(atom_type=atom_type, positions=positions,
                     chirality=np.zeros(n_atoms, np.int32),
                     bond_index=bond_index)


def _geometry_label(rec: MolRecord) -> float:
    """A smooth SE(3)-invariant function of the geometry."""
    pos = rec.positions
    n = pos.shape[0]
    if n < 2:
        return 0.0
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    iu = np.triu_indices(n, 1)
    return float(np.mean(np.exp(-d[iu] / 3.0)) * 10.0 + 0.1 * n)


def synthetic_qm9(num_molecules: int = 256, seed: int = 0,
                  num_targets: int = 13, min_atoms: int = 3,
                  max_atoms: int = 29) -> MolStore:
    """QM9 stand-in: sizes 3..29, 13 target columns."""
    rng = np.random.default_rng(seed)
    records = []
    for _ in range(num_molecules):
        n = int(rng.integers(min_atoms, max_atoms + 1))
        rec = _random_molecule(rng, n)
        scales = 1.0 + np.arange(num_targets) * 0.5
        rec.y = (_geometry_label(rec) * scales
                 + rng.normal(scale=0.01, size=num_targets)).astype(np.float32)
        records.append(rec)
    return MolStore.from_records(records)


def synthetic_molecule3d(num_molecules: int = 512, seed: int = 1,
                         max_atoms: int = 29) -> MolStore:
    """Molecule3D stand-in; ``max_atoms`` > 32 spans several buckets."""
    return synthetic_qm9(num_molecules, seed=seed, num_targets=8,
                         max_atoms=max_atoms)


def synthetic_md17(num_frames: int = 128, n_atoms: int = 21,
                   seed: int = 0) -> MolStore:
    """MD17 stand-in: one molecule in many perturbed frames, with the energy
    sum_pairs exp(-d/2) and its analytic forces -dE/dpos (consistent with
    the force the drivers take by autograd)."""
    rng = np.random.default_rng(seed)
    template = _random_molecule(rng, n_atoms)
    records = []
    for _ in range(num_frames):
        pos = template.positions + rng.normal(
            scale=0.1, size=(n_atoms, 3)).astype(np.float32)
        diff = pos[:, None] - pos[None, :]
        d = np.linalg.norm(diff, axis=-1)
        np.fill_diagonal(d, 1.0)
        e_pair = np.exp(-d / 2.0)
        np.fill_diagonal(e_pair, 0.0)
        energy = 0.5 * float(e_pair.sum())
        # dE/dpos_i = sum_j (-1/2) exp(-d/2) (pos_i - pos_j) / d
        grad = ((-0.5 * e_pair / d)[..., None] * diff).sum(axis=1)
        records.append(MolRecord(
            atom_type=template.atom_type.copy(), positions=pos,
            chirality=template.chirality.copy(),
            bond_index=template.bond_index.copy(),
            y=np.asarray([energy], np.float32),
            forces=(-grad).astype(np.float32)))
    return MolStore.from_records(records)


def synthetic_lba(num_complexes: int = 64, seed: int = 2,
                  max_atoms: int = 400) -> MolStore:
    """LBA stand-in: large pocket+ligand complexes with logKd-like labels."""
    rng = np.random.default_rng(seed)
    records = []
    lo = min(120, max(2, max_atoms // 2))
    for _ in range(num_complexes):
        n = int(rng.integers(lo, max_atoms + 1))
        rec = _random_molecule(rng, n)
        rec.positions *= 2.0  # protein-scale spread
        rec.y = np.asarray([_geometry_label(rec)], np.float32)
        records.append(rec)
    return MolStore.from_records(records)


def synthetic_lep(num_pairs: int = 48, seed: int = 3, max_atoms: int = 300):
    """LEP stand-in: (active store, inactive store, labels). The balanced
    labels are encoded in the geometry: an active's inactive conformation
    stays compact, an inactive's spreads out."""
    rng = np.random.default_rng(seed)
    act, inact, labels = [], [], []
    lo = min(80, max(2, max_atoms // 2))
    for _ in range(num_pairs):
        n = int(rng.integers(lo, max_atoms + 1))
        a = _random_molecule(rng, n)
        a.positions *= 2.0
        label = float(rng.integers(0, 2))
        spread = 0.2 if label > 0 else 2.0
        b = MolRecord(
            atom_type=a.atom_type.copy(),
            positions=(a.positions + rng.normal(scale=spread,
                                                size=a.positions.shape)
                       ).astype(np.float32),
            chirality=a.chirality.copy(),
            bond_index=a.bond_index.copy())
        a.y = np.asarray([label], np.float32)
        b.y = np.asarray([label], np.float32)
        act.append(a)
        inact.append(b)
        labels.append(label)
    return (MolStore.from_records(act), MolStore.from_records(inact),
            np.asarray(labels, np.float32))
