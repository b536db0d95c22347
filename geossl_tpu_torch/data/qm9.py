"""QM9 (the port's own copy of ``geossl_tpu/data/qm9.py``; reference
``Geom3D/datasets/datasets_QM9.py:15-297``).

Raw inputs, pre-downloaded into ``<root>/raw`` (no session has network):
``gdb9.sdf``, ``gdb9.sdf.csv``, ``uncharacterized.txt`` and
``atomref.txt``. The build:

* 12 targets + the derived ``gap_02 = lumo - homo`` (13 columns),
* per-atom thermochemical energies subtracted from zpve/u0/u298/h298/g298/cv,
* hartree -> eV for the energy-like targets,
* the 3054 uncharacterized molecules skipped, and the invalid-SMILES rows
  that a ``smiles_drop_file`` lists (one 0-based raw row per line; the
  reference finds them with RDKit, which the port does not use).

It reads the CSVs with the ``csv`` module and the molecules with the C++
runtime's SDF scanner (``native/packing.scan_sdf_file``), parsing each
block the scanner rejects (V3000, exponent coordinates) from its byte span
with the per-block parser (``data/featurize.sdf_block_to_arrays``): the JAX
package's path without RDKit. Under ``GEOSSL_NO_NATIVE=1`` every block goes
through the per-block parser; the store is the same either way. The result
is cached as ``<root>/processed/qm9_store.npz``, the file the JAX package
writes and reads.
"""

from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np

from geossl_tpu_torch.data.featurize import (
    ATOMIC_NUM_LIST,
    sdf_block_to_arrays,
)
from geossl_tpu_torch.data.store import MolRecord, MolStore
from geossl_tpu_torch.data.structio import iter_sdf_blocks
from geossl_tpu_torch.native import packing

TARGET_FIELDS = [
    "mu", "alpha", "homo", "lumo", "gap", "r2", "zpve",
    "u0", "u298", "h298", "g298", "cv", "gap_02",
]
HARTREE2EV = 27.211386245988  # CODATA hartree-electron volt relationship
CONVERSION = {
    "mu": 1.0, "alpha": 1.0, "homo": HARTREE2EV, "lumo": HARTREE2EV,
    "gap": HARTREE2EV, "gap_02": HARTREE2EV, "r2": 1.0, "zpve": HARTREE2EV,
    "u0": HARTREE2EV, "u298": HARTREE2EV, "h298": HARTREE2EV,
    "g298": HARTREE2EV, "cv": 1.0,
}
ATOM_DICT = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}
# thermo-corrected target columns (datasets_QM9.py:180-181)
THERMO_TARGETS = [6, 7, 8, 9, 10, 11]


def _read_thermo(path: str):
    """Parse atomref.txt (``datasets_QM9.py:177-201``)."""
    therm = {t: {} for t in THERMO_TARGETS}
    with open(path) as f:
        for line in f:
            split = line.split()
            if not split or split[0] not in ATOM_DICT:
                continue
            for target, val in zip(THERMO_TARGETS, split[1:]):
                therm[target][ATOM_DICT[split[0]]] = float(val)
    return therm


def _corrected_target(y, atom_count, therm, calculate_thermo):
    """Thermochemical subtraction + hartree->eV (``datasets_QM9.py:180-214``).
    ``atom_count`` maps the true atomic number to its count; elements other
    than HCNOF are ignored, as in the reference."""
    y = y.copy()
    if calculate_thermo:
        for atom, count in atom_count.items():
            if atom not in ATOM_DICT.values():
                continue
            for tid, sub in therm.items():
                y[tid] -= sub[atom] * count
    for k, col in enumerate(TARGET_FIELDS):
        y[k] *= CONVERSION[col]
    return y


def _read_targets(path: str) -> np.ndarray:
    """gdb9.sdf.csv -> [molecules, 13] float64: the 12 named columns in
    ``TARGET_FIELDS`` order and ``gap_02 = lumo - homo``."""
    cols = TARGET_FIELDS[:-1]
    with open(path, newline="") as f:
        rows = [[float(row[c]) for c in cols] for row in csv.DictReader(f)]
    target = np.asarray(rows, np.float64).reshape(-1, len(cols))
    gap_02 = target[:, cols.index("lumo")] - target[:, cols.index("homo")]
    return np.concatenate([target, gap_02[:, None]], axis=1)


def _iter_qm9_arrays(raw: str, skip=frozenset()):
    """Yield ``(arrays, atom_count_by_z)`` per gdb9.sdf molecule (``(None,
    None)`` for indices in ``skip`` and for blocks the parser rejects, so
    that the index stays aligned with the target CSV). QM9 is pure HCNOF,
    inside the 9-way vocab, so the index code inverts to atomic numbers
    for the thermo correction."""

    def counts_from_indices(atom_type):
        bc = np.bincount(atom_type, minlength=9)
        return {ATOMIC_NUM_LIST[i]: int(c) for i, c in enumerate(bc[:8]) if c}

    def parse_block(block):
        try:
            arrays, _ = sdf_block_to_arrays(block)
        except (ValueError, IndexError):
            return None, None
        return arrays, counts_from_indices(arrays["atom_type"])

    path = os.path.join(raw, "gdb9.sdf")
    if not packing.enabled():
        for i, block in enumerate(iter_sdf_blocks(path)):
            yield (None, None) if i in skip else parse_block(block)
        return
    ok, at, pos, aoff, bidx, _, boff, byte_off = packing.scan_sdf_file(path)
    with open(path, "rb") as fh:
        for k in range(len(ok)):
            if k in skip:
                yield None, None
            elif not ok[k]:
                # a block the scanner rejects, from its byte span
                fh.seek(byte_off[k])
                text = fh.read(byte_off[k + 1] - byte_off[k]).decode(
                    errors="replace")
                yield parse_block("".join(
                    line for line in text.splitlines(keepends=True)
                    if not line.startswith("$$$$")))
            else:
                s, e = aoff[k], aoff[k + 1]
                yield (dict(atom_type=at[s:e], positions=pos[s:e],
                            chirality=np.zeros(e - s, np.int32),
                            bond_index=np.ascontiguousarray(
                                bidx[:, boff[k]:boff[k + 1]])),
                       counts_from_indices(at[s:e]))


def build_qm9(root: str, calculate_thermo: bool = True,
              smiles_drop_file: Optional[str] = None) -> MolStore:
    """Featurize raw QM9 into a MolStore (one-time, on the host).

    The reference also drops the rows whose SMILES RDKit cannot read
    (``datasets_QM9.py:225``); without RDKit those few rows are kept,
    which shifts the indices (and so the split membership) after them,
    unless ``smiles_drop_file`` lists them. The build says which it did."""
    raw = os.path.join(root, "raw")
    therm = _read_thermo(os.path.join(raw, "atomref.txt"))
    target = _read_targets(os.path.join(raw, "gdb9.sdf.csv"))
    with open(os.path.join(raw, "uncharacterized.txt")) as f:
        skip = set(int(x.split()[0]) - 1 for x in f.read().split("\n")[9:-2])
    drop = set()
    if smiles_drop_file:
        with open(smiles_drop_file) as f:
            drop = {int(line) for line in f.read().split() if line.strip()}

    records = []
    dropped = 0
    for i, (arrays, atom_count) in enumerate(_iter_qm9_arrays(raw, skip)):
        if arrays is None:
            continue
        y = _corrected_target(target[i], atom_count, therm, calculate_thermo)
        if i in drop:
            dropped += 1
            continue
        records.append(MolRecord(
            atom_type=arrays["atom_type"], positions=arrays["positions"],
            chirality=arrays["chirality"], bond_index=arrays["bond_index"],
            y=y.astype(np.float32)))
    if not smiles_drop_file:
        print(f"qm9: {len(records)} molecules; invalid-SMILES filter "
              "UNAVAILABLE (no RDKit, no smiles_drop_file): rows the "
              "reference would drop are kept; indices/splits may shift "
              "by that handful (data/qm9.py docstring)")
    else:
        print(f"qm9: {len(records)} molecules; invalid-SMILES rows "
              f"dropped: {dropped}")
    return MolStore.from_records(records)


def load_qm9(root: str, synthetic: bool = False, synthetic_size: int = 256,
             smiles_drop_file: Optional[str] = None) -> MolStore:
    """The cached store, built from the raw files on first use; with
    ``synthetic=True`` the stand-in (``data/synthetic.synthetic_qm9``)."""
    if synthetic:
        from geossl_tpu_torch.data.synthetic import synthetic_qm9

        return synthetic_qm9(synthetic_size)
    cache = os.path.join(root, "processed", "qm9_store.npz")
    if os.path.exists(cache):
        return MolStore.load(cache)
    if not os.path.exists(os.path.join(root, "raw", "gdb9.sdf")):
        raise FileNotFoundError(
            f"QM9 raw files not found under {root}/raw (no network to "
            "download them). Use synthetic=True for the stand-in dataset.")
    store = build_qm9(root, smiles_drop_file=smiles_drop_file)
    store.save(cache)
    return store
