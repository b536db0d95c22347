"""The Molecule3D pretraining corpus (counterpart of
``geossl_tpu/data/molecule3d.py``): the build from the raw SDF shards, the
processed ``.npz`` MolStore caches (the same files the JAX package writes),
and the synthetic stand-in.

Reference: ``Geom3D/datasets/datasets_Molecule3D.py:18-175``. Raw inputs:
four SDF shards (``combined_mols_0_to_1000000.sdf`` ...) and
``properties.csv`` (3.9M molecules). Every molecule is featurized, its
property row attached as ``y``, and the full cache is written with the 1M and
2M head subsets; training uses the 1M subset
(``submit_pretrain_GeoSSL_DDM.sh:14``).

Two differences from the JAX package, neither of which changes a cache:

* No pandas. ``properties.csv`` is read in float64 and cast to float32, and
  the leading id column is dropped: the values of
  ``pd.read_csv(...).to_numpy(float32)[:, 1:]``. An empty field reads as NaN,
  as pandas reads it.
* No RDKit. The build always takes the JAX package's route without RDKit:
  the C++ shard scanner (``native.packing.scan_sdf_file``), with the blocks
  it rejects parsed again in Python, or, under ``GEOSSL_NO_NATIVE=1``,
  ``featurize.sdf_block_to_arrays`` per block. Both give the same store.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from geossl_tpu_torch.data.featurize import sdf_block_to_arrays
from geossl_tpu_torch.data.store import MolRecord, MolStore
from geossl_tpu_torch.data.structio import iter_sdf_blocks
from geossl_tpu_torch.native import packing

SDF_SHARDS = [
    "combined_mols_0_to_1000000.sdf",
    "combined_mols_1000000_to_2000000.sdf",
    "combined_mols_2000000_to_3000000.sdf",
    "combined_mols_3000000_to_3899647.sdf",
]


def _shard_path(raw: str, shard: str) -> str:
    path = os.path.join(raw, shard)
    if not os.path.exists(path):
        # properties.csv rows follow the global molecule order: a missing
        # shard would misalign every later label
        raise FileNotFoundError(
            f"Molecule3D shard {shard} missing under {raw}; all shards are "
            "required to keep property rows aligned")
    return path


def read_properties(path: str) -> np.ndarray:
    """``properties.csv`` without its header and its leading id column,
    float32 [M, T]: parsed in float64 and cast, as pandas' ``read_csv`` and
    ``to_numpy(float32)`` give it; an empty field is NaN."""
    try:  # numpy's C reader; it refuses an empty field
        table = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64,
                           ndmin=2)
    except ValueError:
        table = np.genfromtxt(path, delimiter=",", skip_header=1,
                              dtype=np.float64, ndmin=2)
    return table.astype(np.float32)[:, 1:]


def _rescue(path: str, ok, atom_type, pos, aoff, bond_index, boff, byte_off):
    """The blocks the C++ scanner rejected (V3000, exponent coordinates,
    ...) parsed again from their byte spans by ``sdf_block_to_arrays``, and
    spliced into the shard's flat arrays: the native build keeps every
    molecule the per-block build keeps. Returns the arrays, changed or not."""
    rescued = {}
    bad_idx = np.flatnonzero(~ok)
    if len(bad_idx):
        with open(path, "rb") as f:  # byte offsets need binary seeks
            for k in bad_idx:
                f.seek(byte_off[k])
                text = f.read(byte_off[k + 1] - byte_off[k]).decode(
                    errors="replace")
                block = "".join(line for line in text.splitlines(keepends=True)
                                if not line.startswith("$$$$"))
                try:
                    rescued[int(k)] = sdf_block_to_arrays(block)[0]
                except (ValueError, IndexError):
                    pass
    if not rescued:
        return ok, atom_type, pos, aoff, bond_index, boff
    ok = ok.copy()
    lens, blens = np.diff(aoff).copy(), np.diff(boff).copy()
    parts_a, parts_p, parts_b = [], [], []
    for k in range(len(ok)):
        if k in rescued:
            r = rescued[k]
            ok[k] = True
            lens[k], blens[k] = r["atom_type"].shape[0], r["bond_index"].shape[1]
            parts_a.append(r["atom_type"])
            parts_p.append(r["positions"])
            parts_b.append(r["bond_index"])
        else:
            parts_a.append(atom_type[aoff[k]:aoff[k + 1]])
            parts_p.append(pos[aoff[k]:aoff[k + 1]])
            parts_b.append(bond_index[:, boff[k]:boff[k + 1]])
    return (ok, np.concatenate(parts_a), np.concatenate(parts_p),
            _offsets(lens), np.concatenate(parts_b, axis=1), _offsets(blens))


def _offsets(lens: np.ndarray) -> np.ndarray:
    out = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=out[1:])
    return out


def _build_molecule3d_native(raw: str, prop_np: np.ndarray,
                             limit: Optional[int]) -> MolStore:
    """The corpus through the C++ shard scanner: one mmap'd pass per shard,
    no per-molecule Python. An unparseable block is skipped with its
    properties row, as the reference skips ``mol is None``
    (``datasets_Molecule3D.py:66-70``)."""
    atom_chunks, pos_chunks, bond_chunks = [], [], []
    len_chunks, bond_len_chunks, y_chunks = [], [], []
    base = 0  # global molecule index (all blocks, parsed or not)
    total_ok = 0
    for shard in SDF_SHARDS:
        path = _shard_path(raw, shard)
        ok, atom_type, pos, aoff, bond_index, _btype, boff, byte_off = (
            packing.scan_sdf_file(path))
        ok, atom_type, pos, aoff, bond_index, boff = _rescue(
            path, ok, atom_type, pos, aoff, bond_index, boff, byte_off)
        lens, blens = np.diff(aoff), np.diff(boff)
        ok_idx = np.flatnonzero(ok)
        if limit is not None and total_ok + len(ok_idx) > limit:
            ok_idx = ok_idx[: limit - total_ok]
            a_end = int(aoff[ok_idx[-1] + 1]) if len(ok_idx) else 0
            b_end = int(boff[ok_idx[-1] + 1]) if len(ok_idx) else 0
            atom_type, pos = atom_type[:a_end], pos[:a_end]
            bond_index = bond_index[:, :b_end]
        atom_chunks.append(atom_type)
        pos_chunks.append(pos)
        bond_chunks.append(bond_index)
        len_chunks.append(lens[ok_idx])
        bond_len_chunks.append(blens[ok_idx])
        y_chunks.append(prop_np[base + ok_idx])
        base += len(ok)
        total_ok += len(ok_idx)
        if limit is not None and total_ok >= limit:
            break
    atom_type = np.concatenate(atom_chunks)
    return MolStore(
        atom_type=atom_type,
        positions=np.concatenate(pos_chunks),
        offsets=_offsets(np.concatenate(len_chunks)),
        chirality=np.zeros_like(atom_type),  # no RDKit: unspecified
        bond_index=np.concatenate(bond_chunks, axis=1),
        bond_offsets=_offsets(np.concatenate(bond_len_chunks)),
        y=np.concatenate(y_chunks))


def _iter_mol_arrays(path: str):
    """Featurized arrays per block of one shard, None for a block that
    ``sdf_block_to_arrays`` cannot read."""
    for block in iter_sdf_blocks(path):
        try:
            yield sdf_block_to_arrays(block)[0]
        except (ValueError, IndexError):
            yield None


def build_molecule3d(root: str, limit: Optional[int] = None) -> MolStore:
    """The corpus (its first ``limit`` parseable molecules) from
    ``<root>/raw``: the C++ scanner, or per block under
    ``GEOSSL_NO_NATIVE=1``."""
    raw = os.path.join(root, "raw")
    # The reference drops the leading id column (``data.y =
    # target_df.iloc[abs_idx, 1:]``, datasets_Molecule3D.py:154); keeping it
    # would shift every target index by one.
    prop_np = read_properties(os.path.join(raw, "properties.csv"))
    if packing.enabled():
        return _build_molecule3d_native(raw, prop_np, limit)
    records: List[MolRecord] = []
    idx = 0
    for shard in SDF_SHARDS:
        for arrays in _iter_mol_arrays(_shard_path(raw, shard)):
            if arrays is not None:
                records.append(MolRecord(
                    atom_type=arrays["atom_type"],
                    positions=arrays["positions"],
                    chirality=arrays["chirality"],
                    bond_index=arrays["bond_index"], y=prop_np[idx]))
                if limit is not None and len(records) >= limit:
                    return MolStore.from_records(records)
            idx += 1
    return MolStore.from_records(records)


def process_molecule3d(root: str,
                       subsets: "tuple[int, ...]" = (1_000_000, 2_000_000)
                       ) -> MolStore:
    """The reference's whole ``process()`` (``datasets_Molecule3D.py:
    61-149``): one scan of the raw shards into the full corpus cache, then
    the head subsets (the first k molecules of the same scan order, so each
    equals a build with ``limit=k``). Returns the full store. Idempotent: a
    cache that exists is left as it is."""
    full_cache = os.path.join(root, "processed", "molecule3d_store.npz")
    if os.path.exists(full_cache):
        store = MolStore.load(full_cache)
    else:
        store = build_molecule3d(root, limit=None)
        store.save(full_cache)
    for k in subsets:
        path = os.path.join(root, "processed", f"molecule3d_{k}_store.npz")
        if os.path.exists(path):
            continue
        if k > len(store):
            raise ValueError(
                f"subset {k} exceeds the corpus size {len(store)}")
        store.select(np.arange(k)).save(path)
    return store


def load_molecule3d(root: str, subset: Optional[int] = 1_000_000,
                    synthetic: bool = False, synthetic_size: int = 512,
                    synthetic_max_atoms: int = 29) -> MolStore:
    """The (optionally size-limited) corpus; subset=1_000_000 is
    ``Molecule3D_1000000``. Reads ``<root>/processed/molecule3d_<subset>_
    store.npz``, and builds and writes it from ``<root>/raw`` when it is
    missing."""
    if synthetic:
        from geossl_tpu_torch.data.synthetic import synthetic_molecule3d

        return synthetic_molecule3d(synthetic_size,
                                    max_atoms=synthetic_max_atoms)
    tag = f"_{subset}" if subset else ""
    cache = os.path.join(root, "processed", f"molecule3d{tag}_store.npz")
    if os.path.exists(cache):
        return MolStore.load(cache)
    if not os.path.exists(os.path.join(root, "raw", "properties.csv")):
        raise FileNotFoundError(
            f"Molecule3D: neither {cache} nor the raw files under {root}/raw "
            "found; use synthetic=True for the stand-in")
    store = build_molecule3d(root, limit=subset)
    store.save(cache)
    return store
