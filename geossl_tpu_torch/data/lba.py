"""Atom3D LBA (ligand binding affinity) data pipeline: the port's own copy
of ``geossl_tpu/data/lba.py`` (NumPy; the same store and id map files).

Reference: ``Geom3D/datasets/datasets_LBA.py:23-295`` +
``PDBBind_utils.py:16-49``. Pipeline: PDBBind refined-set protein PDBs +
ligand SDFs -> pocket = residues within 6 Å of the ligand -> TransformLBA
(replace rare elements with Cu, drop H, select the pocket environment within
``dist`` of any ligand atom, cap at ``maxnum`` atoms by ligand distance) ->
merged pocket+ligand graph with y = logKd. ``load_lba`` reads the cache, or
builds it from ``<root>/raw/refined-set`` with the parsers of
``structio.py``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Tuple

import numpy as np

from geossl_tpu_torch.data.store import MolRecord, MolStore
from geossl_tpu_torch.data.structio import (
    PDBStructure,
    parse_index_refined,
    parse_pdb,
    parse_sdf,
)

# atom3d's element → atomic number map (subset; rare elements replaced by Cu)
ELEMENT_Z = {
    "H": 1, "C": 6, "N": 7, "O": 8, "F": 9, "P": 15, "S": 16, "Cl": 17,
    "Cu": 29,
}
KEEP_ELEMENTS = ["H", "C", "N", "O", "F", "S", "P", "Cl"]
# the 9-way atom-type code of the reference (index 8: unknown / mask token)
ATOMIC_NUM_LIST = (1, 6, 7, 8, 9, 15, 16, 17)
UNKNOWN_INDEX = len(ATOMIC_NUM_LIST)


def atomic_number_to_index(z: int) -> int:
    """Map a true atomic number to the 9-way index code."""
    return ATOMIC_NUM_LIST.index(z) if z in ATOMIC_NUM_LIST else UNKNOWN_INDEX


def replace_rare_elements(elements: List[str]) -> List[str]:
    """Rare elements → Cu (``datasets_LBA.py:41-52``)."""
    out = []
    for e in elements:
        if e == "CL":
            e = "Cl"
        out.append(e if e in KEEP_ELEMENTS else "Cu")
    return out


def drop_hydrogen(
    elements: List[str], coords: np.ndarray
) -> Tuple[List[str], np.ndarray]:
    keep = [i for i, e in enumerate(elements) if e != "H"]
    return [elements[i] for i in keep], coords[keep]


def select_env_by_dist(
    pocket_coords: np.ndarray, ligand_coords: np.ndarray, dist: float
) -> np.ndarray:
    """Indices of pocket atoms within ``dist`` of any ligand atom
    (``datasets_LBA.py:54-65``)."""
    d = np.linalg.norm(
        pocket_coords[:, None, :] - ligand_coords[None, :, :], axis=-1
    )
    return np.where((d <= dist).any(axis=1))[0]


def select_env_by_num(
    pocket_coords: np.ndarray, ligand_coords: np.ndarray, maxnum: int
) -> np.ndarray:
    """Cap the pocket at ``maxnum - n_ligand`` atoms nearest to the ligand,
    sorted back into original order (``datasets_LBA.py:66-84``)."""
    num = int(max(1, maxnum - len(ligand_coords)))
    d = np.linalg.norm(
        pocket_coords[:, None, :] - ligand_coords[None, :, :], axis=-1
    )
    dmin = d.min(axis=1)
    idx = np.argsort(dmin, kind="stable")[:num]
    return np.sort(idx)


def transform_lba(
    pocket_elements: List[str],
    pocket_coords: np.ndarray,
    ligand_elements: List[str],
    ligand_coords: np.ndarray,
    dist: float = 6.0,
    maxnum: int = 500,
) -> MolRecord:
    """Full TransformLBA + merge + index coding (``datasets_LBA.py:86-270``)."""
    pocket_elements = replace_rare_elements(pocket_elements)
    ligand_elements = replace_rare_elements(ligand_elements)
    pocket_elements, pocket_coords = drop_hydrogen(pocket_elements, pocket_coords)
    ligand_elements, ligand_coords = drop_hydrogen(ligand_elements, ligand_coords)
    env = select_env_by_dist(pocket_coords, ligand_coords, dist)
    pocket_elements = [pocket_elements[i] for i in env]
    pocket_coords = pocket_coords[env]
    env = select_env_by_num(pocket_coords, ligand_coords, maxnum)
    pocket_elements = [pocket_elements[i] for i in env]
    pocket_coords = pocket_coords[env]

    elements = pocket_elements + list(ligand_elements)
    coords = np.concatenate([pocket_coords, ligand_coords]).astype(np.float32)
    atom_type = np.asarray(
        [atomic_number_to_index(ELEMENT_Z.get(e, -1)) for e in elements], np.int32
    )
    return MolRecord(atom_type=atom_type, positions=coords)


def get_pocket_atom_indices(
    protein: PDBStructure, ligand_coords: np.ndarray, dist: float = 6.0
) -> np.ndarray:
    """Indices of protein atoms in the binding pocket.

    Reference semantics (``PDBBind_utils.py:16-49`` + ``PocketSelect``):
    collect every residue with at least one atom within ``dist`` Å of any
    ligand atom, skip water (HOH), and keep ALL atoms of the selected
    residues (the reference writes whole residues to the pocket mmCIF).
    """
    from scipy.spatial import cKDTree

    if len(protein) == 0 or len(ligand_coords) == 0:
        return np.zeros(0, np.int64)
    tree = cKDTree(protein.coords)
    near = tree.query_ball_point(ligand_coords, r=dist, p=2.0)
    keys = protein.residue_keys()
    pocket_res = {
        keys[i] for hits in near for i in hits if keys[i][3] != "HOH"
    }
    return np.asarray(
        [i for i, k in enumerate(keys) if k in pocket_res], np.int64
    )


def build_lba(
    root: str,
    year: int = 2020,
    dist: float = 6.0,
    maxnum: int = 500,
) -> MolStore:
    """Build the LBA cache from raw PDBBind refined-set files.

    Mirrors ``DatasetLBA.process`` (``datasets_LBA.py:166-295``): for each
    complex under ``<root>/raw/refined-set/<pdb_id>/`` parse
    ``<pdb_id>_protein.pdb`` + ``<pdb_id>_ligand.sdf``, extract the 6 Å
    pocket residues, apply ``transform_lba`` (replace-rare/drop-H/env
    selection/cap), attach the -logKd/Ki label from
    ``index/INDEX_refined_data.{year}``, and write:

    - ``<root>/processed/lba_{year}_store.npz`` (MolStore with ``y``)
    - ``<root>/processed/pdb_id2data_id_{year}.json`` — the pdb-id → row-id
      map the identity-30 split resolves through (``datasets_LBA.py:283-284``,
      ``splitters.py:361-388``).

    Complexes are visited in sorted pdb-id order, matching the reference's
    ``find ... | sort`` insertion order into ``structure_dict``
    (``PDBBind_utils.py:76-98``). Complexes with an unparseable ligand or a
    missing index label are skipped (the reference would crash on them).
    """
    raw_dir = os.path.join(root, "raw", "refined-set")
    index_file = os.path.join(raw_dir, "index", f"INDEX_refined_data.{year}")
    with open(index_file) as f:
        labels = parse_index_refined(f.read())

    protein_files = sorted(glob.glob(os.path.join(raw_dir, "*", "*_protein.pdb")))
    records: List[MolRecord] = []
    pdb_id2data_id = {}
    skipped = 0
    for pf in protein_files:
        pdb_id = os.path.basename(pf)[:4].lower()
        lf = os.path.join(os.path.dirname(pf), f"{pdb_id}_ligand.sdf")
        if pdb_id not in labels or not os.path.exists(lf):
            skipped += 1
            continue
        with open(pf) as f:
            protein = parse_pdb(f.read())
        try:
            with open(lf) as f:
                lig_elements, lig_coords = parse_sdf(f.read())
        except (ValueError, IndexError):  # truncated/malformed ligand files
            skipped += 1
            continue
        pocket_idx = get_pocket_atom_indices(protein, lig_coords, dist)
        rec = transform_lba(
            [protein.elements[i] for i in pocket_idx],
            protein.coords[pocket_idx],
            lig_elements,
            lig_coords,
            dist=dist,
            maxnum=maxnum,
        )
        rec.y = np.asarray([labels[pdb_id]], np.float32)
        pdb_id2data_id[pdb_id] = len(records)
        records.append(rec)

    if not records:
        raise FileNotFoundError(f"no usable complexes under {raw_dir}")
    if skipped:
        print(f"LBA: skipped {skipped} complexes (missing ligand/label)")
    store = MolStore.from_records(records)
    os.makedirs(os.path.join(root, "processed"), exist_ok=True)
    store.save(os.path.join(root, "processed", f"lba_{year}_store.npz"))
    with open(
        os.path.join(root, "processed", f"pdb_id2data_id_{year}.json"), "w"
    ) as f:
        json.dump(pdb_id2data_id, f)
    return store


def load_lba(root: str = "", year: int = 2020, dist: float = 6.0,
             maxnum: int = 500) -> MolStore:
    cache = os.path.join(root, "processed", f"lba_{year}_store.npz")
    if os.path.exists(cache):
        return MolStore.load(cache)
    if os.path.isdir(os.path.join(root, "raw", "refined-set")):
        return build_lba(root, year=year, dist=dist, maxnum=maxnum)
    raise FileNotFoundError(
        f"LBA: neither cache ({cache}) nor raw PDBBind files "
        f"({root}/raw/refined-set) found: download the refined set there, "
        "or use the driver's --synthetic stand-in.")
