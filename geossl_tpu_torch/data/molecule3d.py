"""The Molecule3D pretraining corpus (counterpart of
``geossl_tpu/data/molecule3d.py``): the synthetic stand-in, or a processed
``.npz`` MolStore cache as the JAX package writes it. Building the cache from
the raw SDF shards is not ported (the SDF parser is queued)."""

from __future__ import annotations

import os
from typing import Optional

from geossl_tpu_torch.data.store import MolStore


def load_molecule3d(root: str, subset: Optional[int] = 1_000_000,
                    synthetic: bool = False, synthetic_size: int = 512,
                    synthetic_max_atoms: int = 29) -> MolStore:
    """The (optionally size-limited) corpus; subset=1_000_000 reads
    ``<root>/processed/molecule3d_1000000_store.npz``."""
    if synthetic:
        from geossl_tpu_torch.data.synthetic import synthetic_molecule3d

        return synthetic_molecule3d(synthetic_size,
                                    max_atoms=synthetic_max_atoms)
    tag = f"_{subset}" if subset else ""
    cache = os.path.join(root, "processed", f"molecule3d{tag}_store.npz")
    if not os.path.exists(cache):
        raise FileNotFoundError(
            f"{cache} not found: the port reads the processed MolStore that "
            "geossl_tpu.data.molecule3d writes (building it from the raw SDF "
            "shards is not ported); use synthetic=True for the stand-in")
    return MolStore.load(cache)
