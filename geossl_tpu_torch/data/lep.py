"""Atom3D LEP (ligand efficacy prediction) data pipeline: the port's own
copy of ``geossl_tpu/data/lep.py`` (NumPy; the same cache files).

Reference: ``Geom3D/datasets/datasets_LEP.py:16-292``. Each item is a PAIR of
structures (the same ligand bound to an active and an inactive protein
conformation) with a binary label (A/I -> 1/0, ``datasets_LEP.py:209``).
The transform selects the environment within ``dist`` of ligand chain 'L'
and caps it at ``maxnum`` atoms (``datasets_LEP.py:100-115``), with the LBA
helpers, with the reference's optional hydrogen drop (``droph``,
``--LEP_droph``, off by default). Raw ingestion reads the atom3d LMDB shards
(gzip + JSON records); only the ``lmdb`` import is gated.
"""

from __future__ import annotations

import gzip
import io
import json
import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from geossl_tpu_torch.data.lba import (
    ELEMENT_Z,
    atomic_number_to_index,
    drop_hydrogen,
    replace_rare_elements,
    select_env_by_dist,
    select_env_by_num,
)
from geossl_tpu_torch.data.store import MolRecord, MolStore


def transform_lep_structure(elements: List[str], coords: np.ndarray,
                            is_ligand: np.ndarray, dist: float = 6.0,
                            maxnum: int = 400, droph: bool = False
                            ) -> MolRecord:
    """Environment selection around the ligand chain
    (``datasets_LEP.py:100-115``); ``is_ligand`` is True per atom of chain
    'L'; ``droph`` drops the hydrogens of both parts first."""
    elements = replace_rare_elements(elements)
    lig_idx = np.where(is_ligand)[0]
    prot_idx = np.where(~is_ligand)[0]
    lig_elements = [elements[i] for i in lig_idx]
    lig_coords = coords[lig_idx]
    prot_elements = [elements[i] for i in prot_idx]
    prot_coords = coords[prot_idx]
    if droph:
        lig_elements, lig_coords = drop_hydrogen(lig_elements, lig_coords)
        prot_elements, prot_coords = drop_hydrogen(prot_elements, prot_coords)
    env = select_env_by_dist(prot_coords, lig_coords, dist)
    prot_elements = [prot_elements[i] for i in env]
    prot_coords = prot_coords[env]
    env = select_env_by_num(prot_coords, lig_coords, maxnum)
    prot_elements = [prot_elements[i] for i in env]
    prot_coords = prot_coords[env]

    merged = prot_elements + lig_elements
    coords = np.concatenate([prot_coords, lig_coords]).astype(np.float32)
    atom_type = np.asarray(
        [atomic_number_to_index(ELEMENT_Z.get(e, -1)) for e in merged], np.int32)
    return MolRecord(atom_type=atom_type, positions=coords)


def deserialize_lmdb_item(raw: bytes) -> dict:
    """Decode one atom3d LMDB value: gzip-compressed JSON whose DataFrame
    fields are stored in pandas ``orient='split'`` form (keys columns/index/
    data). Returns the item with those fields flattened to column-name ->
    list dicts, what ``atom3d.datasets.LMDBDataset.__getitem__`` rebuilds
    before ``TransformLEP`` runs (reference ``datasets_LEP.py:177-213``)."""
    try:
        with gzip.GzipFile(fileobj=io.BytesIO(raw), mode="rb") as f:
            raw = f.read()
    except (OSError, EOFError):
        pass  # some shards store metadata uncompressed
    item = json.loads(raw)
    for key, tname in list(item.get("types", {}).items()):
        if "DataFrame" in str(tname) and isinstance(item.get(key), dict):
            split = item[key]
            data = split["data"]
            item[key] = {c: [row[j] for row in data]
                         for j, c in enumerate(split["columns"])}
    return item


def read_lmdb_items(folder: str) -> Iterator[dict]:
    """Iterate the decoded items of an atom3d LMDB directory (needs the
    ``lmdb`` package, the only third-party piece of this pipeline)."""
    try:
        import lmdb
    except ImportError as e:
        raise ImportError(
            "reading raw LEP shards requires the 'lmdb' package; the "
            "processed cache needs no extras") from e
    env = lmdb.open(str(folder), max_readers=1, readonly=True, lock=False,
                    readahead=False, meminit=False)
    with env.begin(write=False) as txn:
        num = int(txn.get(b"num_examples"))
        for i in range(num):
            yield deserialize_lmdb_item(txn.get(str(i).encode()))


def item_to_records(item: dict, dist: float = 6.0, maxnum: int = 400,
                    droph: bool = False) -> Tuple[MolRecord, MolRecord, float]:
    """One decoded LEP item -> (active record, inactive record, label).
    The frames carry ``element/x/y/z/chain`` columns; ligand = chain 'L'
    (``datasets_LEP.py:100-115``); label 'A'/'I' -> 1/0 (``:209``)."""
    recs = []
    for frame_key in ("atoms_active", "atoms_inactive"):
        frame = item[frame_key]
        elements = [str(e) for e in frame["element"]]
        coords = np.stack([np.asarray(frame[c], np.float32)
                           for c in ("x", "y", "z")], axis=1)
        is_ligand = np.asarray([c == "L" for c in frame["chain"]], bool)
        recs.append(transform_lep_structure(elements, coords, is_ligand,
                                            dist=dist, maxnum=maxnum,
                                            droph=droph))
    label = {"A": 1.0, "I": 0.0}[str(item["label"])]
    return recs[0], recs[1], label


def build_lep_split(items: Sequence[dict], root: str, split_dir: str,
                    dist: float = 6.0, maxnum: int = 400, droph: bool = False
                    ) -> Tuple[MolStore, MolStore, np.ndarray]:
    """Transform decoded items and write the split's caches
    (``processed/lep_{split}_{active,inactive}.npz`` and the labels)."""
    act, ina, labels = [], [], []
    for item in items:
        a, i, y = item_to_records(item, dist=dist, maxnum=maxnum, droph=droph)
        a.y = np.asarray([y], np.float32)
        i.y = np.asarray([y], np.float32)
        act.append(a)
        ina.append(i)
        labels.append(y)
    if not act:
        raise FileNotFoundError(f"no LEP items for split {split_dir!r}")
    store_a, store_i = MolStore.from_records(act), MolStore.from_records(ina)
    labels = np.asarray(labels, np.float32)
    out = os.path.join(root, "processed")
    os.makedirs(out, exist_ok=True)
    store_a.save(os.path.join(out, f"lep_{split_dir}_active.npz"))
    store_i.save(os.path.join(out, f"lep_{split_dir}_inactive.npz"))
    np.save(os.path.join(out, f"lep_{split_dir}_labels.npy"), labels)
    return store_a, store_i, labels


def _raw_dir(root: str, split_dir: str) -> str:
    return os.path.join(root, "raw", "split-by-protein", "data", split_dir)


def build_lep(root: str, split_dir: str = "train", dist: float = 6.0,
              maxnum: int = 400, droph: bool = False
              ) -> Tuple[MolStore, MolStore, np.ndarray]:
    """Build one split's caches from the raw atom3d LMDB shard at
    ``<root>/raw/split-by-protein/data/<split>`` (``datasets_LEP.py:180``)."""
    folder = _raw_dir(root, split_dir)
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"LEP raw LMDB shard not found: {folder}")
    return build_lep_split(list(read_lmdb_items(folder)), root, split_dir,
                           dist=dist, maxnum=maxnum, droph=droph)


def load_lep(root: str = "", split_dir: str = "train", dist: float = 6.0,
             maxnum: int = 400, droph: bool = False
             ) -> Tuple[MolStore, MolStore, np.ndarray]:
    """(active store, inactive store, labels) of one split. LEP ships
    pre-split by protein into train/val/test LMDB directories
    (``datasets_LEP.py:180``)."""
    prefix = os.path.join(root, "processed", f"lep_{split_dir}_")
    if os.path.exists(prefix + "active.npz"):
        return (MolStore.load(prefix + "active.npz"),
                MolStore.load(prefix + "inactive.npz"),
                np.load(prefix + "labels.npy"))
    if os.path.isdir(_raw_dir(root, split_dir)):
        return build_lep(root, split_dir, dist=dist, maxnum=maxnum,
                         droph=droph)
    raise FileNotFoundError(
        f"LEP: neither cache ({prefix}active.npz) nor raw LMDB shard "
        f"({_raw_dir(root, split_dir)}) found: download the atom3d LEP "
        "release there, or use the driver's --synthetic stand-in.")
