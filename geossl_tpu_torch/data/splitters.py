"""Dataset splits as index arrays (the port's own copy of ``random_split``
and ``atom3d_lba_split`` from ``geossl_tpu/data/splitters.py``; reference
``examples/splitters.py``). Each returns (train_idx, valid_idx, test_idx)
over a store. The QM9, MD17, scaffold and identity splits come with their
drivers."""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

Split = Tuple[np.ndarray, np.ndarray, np.ndarray]


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
