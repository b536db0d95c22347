"""Dataset splits as index arrays (the port's own copy of
``geossl_tpu/data/splitters.py``; reference ``examples/splitters.py``): the
QM9 splits, ``random_split``, ``md17_split``, ``atom3d_lba_split``, the
scaffold splits (RDKit imported when a scaffold is made) and the
sequence-identity split. Each returns (train_idx, valid_idx, test_idx)
over a store."""

from __future__ import annotations

import json
import math
import os
from typing import Optional, Tuple

import numpy as np

Split = Tuple[np.ndarray, np.ndarray, np.ndarray]

# QM9's molecules after the 3054 uncharacterized ones are skipped
QM9_SIZE = 133885 - 3054


def qm9_random_customized_01(num_mols: int, seed: int = 0) -> Split:
    """The split of every published QM9 result (``splitters.py:253-306``):
    one ``np.random.RandomState(seed)`` permutation, 110k train / 10k valid
    / the rest test; a smaller (synthetic) store keeps the same shares of
    QM9's 130,831 molecules."""
    all_idx = np.random.RandomState(seed).permutation(num_mols)
    if num_mols >= QM9_SIZE:
        n_train, n_valid = 110000, 10000
    else:
        n_train = max(int(num_mols * 110000 / QM9_SIZE), 1)
        n_valid = max(int(num_mols * 10000 / QM9_SIZE), 1)
    return (all_idx[:n_train], all_idx[n_train:n_train + n_valid],
            all_idx[n_train + n_valid:])


def qm9_random_customized_02(num_mols: int, seed: int = 0) -> Split:
    """100k train / 10% test / the rest valid (``splitters.py:309-358``)."""
    all_idx = np.random.RandomState(seed).permutation(num_mols)
    if num_mols >= QM9_SIZE:
        n_train, n_test = 100000, int(0.1 * QM9_SIZE)
    else:
        n_train = max(int(num_mols * 100000 / QM9_SIZE), 1)
        n_test = int(0.1 * num_mols)
    n_valid = num_mols - n_train - n_test
    return (all_idx[:n_train], all_idx[n_train:n_train + n_valid],
            all_idx[n_train + n_valid:])


def random_split(num_mols: int, frac_train: float = 0.8,
                 frac_valid: float = 0.1, frac_test: float = 0.1,
                 seed: int = 42) -> Split:
    """``splitters.py:188-250``: one ``np.random.RandomState(seed)``
    permutation, cut by the fractions."""
    if abs(frac_train + frac_valid + frac_test - 1.0) >= 1e-6:
        raise ValueError("split fractions must sum to 1")
    all_idx = np.random.RandomState(seed).permutation(num_mols)
    n_train = int(frac_train * num_mols)
    n_valid = int(frac_valid * num_mols)
    return (all_idx[:n_train], all_idx[n_train:n_train + n_valid],
            all_idx[n_train + n_valid:])


def md17_split(num_frames: int, train_size: int = 1000,
               valid_size: int = 1000, seed: int = 42) -> Split:
    """Shuffled 1000 train / 1000 valid / the rest test
    (``datasets_MD17.py:78-82``, sizes ``finetune_md17.py:171``): one
    ``np.random.RandomState(seed)`` permutation; a store of at most
    ``train_size + valid_size`` frames (a synthetic one) is cut 40% / 30% /
    the rest instead."""
    ids = np.random.RandomState(seed).permutation(num_frames)
    if num_frames <= train_size + valid_size:
        train_size = max(1, int(num_frames * 0.4))
        valid_size = max(1, int(num_frames * 0.3))
    return (ids[:train_size], ids[train_size:train_size + valid_size],
            ids[train_size + valid_size:])


def atom3d_lba_split(data_root: str, year: int = 2020) -> Split:
    """Sequence-identity-30 split from downloaded index files
    (``splitters.py:361-388``): the pdb ids of
    ``processed/targets/{train,val,test}.txt`` mapped through
    ``processed/pdb_id2data_id_{year}.json``."""
    json_file = os.path.join(data_root, "processed",
                             f"pdb_id2data_id_{year}.json")
    with open(json_file) as f:
        pdb_id2data_id = json.load(f)

    def load(mode: str) -> np.ndarray:
        path = os.path.join(data_root, "processed", "targets", f"{mode}.txt")
        with open(path) as f:
            ids = [line.strip() for line in f if line.strip()]
        return np.asarray([pdb_id2data_id[i] for i in ids], np.int64)

    return load("train"), load("val"), load("test")


def generate_scaffold(smiles: str, include_chirality: bool = True) -> str:
    """Bemis-Murcko scaffold of a SMILES (``splitters.py:12-25``; RDKit)."""
    from rdkit.Chem.Scaffolds import MurckoScaffold

    return MurckoScaffold.MurckoScaffoldSmiles(
        smiles=smiles, includeChirality=include_chirality)


def _scaffold_groups(smiles_list) -> dict:
    groups: dict = {}
    for i, smiles in enumerate(smiles_list):
        groups.setdefault(generate_scaffold(smiles), []).append(i)
    return groups


def _as_split(train, valid, test) -> Split:
    return tuple(np.asarray(s, np.int64) for s in (train, valid, test))


def scaffold_split(smiles_list, frac_train: float = 0.8,
                   frac_valid: float = 0.1, frac_test: float = 0.1) -> Split:
    """Deterministic Bemis-Murcko scaffold split (``splitters.py:28-115``):
    scaffold groups sorted largest first (ties by their first index, the
    later first), filled train -> valid -> test."""
    assert abs(frac_train + frac_valid + frac_test - 1.0) < 1e-6
    groups = sorted(_scaffold_groups(smiles_list).values(),
                    key=lambda g: (len(g), g[0]), reverse=True)
    n = len(smiles_list)
    train_cutoff, valid_cutoff = frac_train * n, (frac_train + frac_valid) * n
    train, valid, test = [], [], []
    for group in groups:
        if len(train) + len(group) <= train_cutoff:
            train.extend(group)
        elif len(train) + len(valid) + len(group) <= valid_cutoff:
            valid.extend(group)
        else:
            test.extend(group)
    return _as_split(train, valid, test)


def random_scaffold_split(smiles_list, frac_train: float = 0.8,
                          frac_valid: float = 0.1, frac_test: float = 0.1,
                          seed: int = 0) -> Split:
    """Scaffold split over a ``RandomState(seed)`` permutation of the
    scaffold groups (``splitters.py:118-185``)."""
    groups = list(_scaffold_groups(smiles_list).values())
    perm = np.random.RandomState(seed).permutation(len(groups))
    n = len(smiles_list)
    n_train, n_valid = int(frac_train * n), int(frac_valid * n)
    train, valid, test = [], [], []
    for gi in perm:
        group = groups[gi]
        if len(train) + len(group) <= n_train:
            train.extend(group)
        elif len(valid) + len(group) <= n_valid:
            valid.extend(group)
        else:
            test.extend(group)
    return _as_split(train, valid, test)


def kmer_identity_neighbors(sequences, cutoff: float, k: int = 6):
    """An alignment-free stand-in for BLAST percent identity, the
    similarity backend of :func:`identity_split` (the reference shells out
    to BLAST, ``PDBBind_utils.py:146-147``). ``sequences[i]``: the chain
    sequences of complex i. Complexes i and j are neighbours when some chain
    pair's k-mer containment |kmers(a) ∩ kmers(b)| / min(|a|, |b|) reaches
    ``cutoff``. Returns ``find_similar(i) -> set`` (i included); an inverted
    k-mer index keeps each query to the complexes sharing a k-mer."""
    kmer_sets = [[{c[j:j + k] for j in range(max(len(c) - k + 1, 0))} or {c}
                  for c in chains] for chains in sequences]
    posting: dict = {}
    for idx, chains in enumerate(kmer_sets):
        for a in chains:
            for km in a:
                posting.setdefault(km, set()).add(idx)

    def similar(i: int, j: int) -> bool:
        return any(min(len(a), len(b)) and
                   len(a & b) / min(len(a), len(b)) >= cutoff
                   for a in kmer_sets[i] for b in kmer_sets[j])

    def find_similar(i: int):
        if cutoff <= 0:
            return set(range(len(kmer_sets)))
        candidates = set().union(*(posting[km] for a in kmer_sets[i]
                                   for km in a))
        return {i} | {j for j in candidates if j != i and similar(i, j)}

    return find_similar


def identity_split(n: int, find_similar, val_split: float = 0.1,
                   test_split: float = 0.1, min_fam_in_split: int = 5,
                   seed: Optional[int] = None) -> Split:
    """The greedy family split of ``PDBBind_utils.py:137-190``: draw a
    complex not yet assigned (``np.random.default_rng(seed)``), take its
    family ``find_similar(i)`` less the assigned ones, put at most
    ``ceil(split_size / min_fam_in_split)`` of it (in index order) into the
    split, and retire the whole family; val first, then test, the rest is
    train. As in the reference, the retired members beyond that cap belong
    to no split."""
    rng = np.random.default_rng(seed)
    available = np.ones(n, bool)

    def create(split_size: float):
        split = set()
        used = set(np.flatnonzero(~available).tolist())
        max_fam_size = int(math.ceil(split_size / min_fam_in_split))
        while len(split) < split_size and available.any():
            i = int(rng.choice(np.flatnonzero(available)))
            found = set(find_similar(i)) - used
            split.update(sorted(found)[:max_fam_size])
            available[list(found)] = False
            used.update(found)
        return split

    val = create(n * val_split)
    test = create(n * test_split)
    train = np.flatnonzero(available).tolist()
    return _as_split(train, sorted(val), sorted(test))
