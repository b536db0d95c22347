"""Dataset splits as index arrays (the port's own copy of the QM9 splits,
``random_split`` and ``atom3d_lba_split`` from
``geossl_tpu/data/splitters.py``; reference ``examples/splitters.py``). Each
returns (train_idx, valid_idx, test_idx) over a store. The MD17 split is
``md17_split``; the scaffold and identity splits come with their drivers."""

from __future__ import annotations

import json
import os
from typing import Tuple

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
