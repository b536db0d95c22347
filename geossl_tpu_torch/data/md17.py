"""The MD17 dataset: its build from the raw npz and its cache (the port's
copy of ``geossl_tpu/data/md17.py``; reference
``Geom3D/datasets/datasets_MD17.py:16-82``).

Raw input: ``md17_<task>.npz`` or ``<task>_dft.npz`` (quantum-machine.org)
under ``<root>/raw``, with per-frame positions ``R``, energies ``E``, forces
``F`` and the molecule's atomic numbers ``z``. Atom types are index-coded
through the 9-way vocabulary (``data/featurize.atomic_number_to_index``), as
every model here embeds with node_class=9. The built store is cached as
``<root>/processed/md17_<task>_store.npz``, the file the JAX package writes
and reads.
"""

from __future__ import annotations

import os

import numpy as np

from geossl_tpu_torch.data.featurize import atomic_number_to_index
from geossl_tpu_torch.data.store import MolRecord, MolStore

MD17_TASKS = [
    "aspirin", "benzene2017", "benzene2018", "ethanol", "malonaldehyde",
    "naphthalene", "salicylic", "toluene", "uracil",
]


def build_md17(root: str, task: str) -> MolStore:
    """One record per frame: the index-coded atoms, positions, the energy
    as y [1] and the forces, all float32 as the JAX build stores them."""
    raw = os.path.join(root, "raw", f"md17_{task}.npz")
    if not os.path.exists(raw):
        raw = os.path.join(root, "raw", f"{task}_dft.npz")
    data = np.load(raw)
    e = np.asarray(data["E"], np.float64).reshape(-1)
    f = np.asarray(data["F"], np.float32)
    r = np.asarray(data["R"], np.float32)
    z = np.asarray(data["z"], np.int64).reshape(-1)
    atom_idx = np.asarray([atomic_number_to_index(int(a)) for a in z], np.int32)
    records = [MolRecord(atom_type=atom_idx.copy(), positions=r[i],
                         y=np.asarray([e[i]], np.float32), forces=f[i])
               for i in range(r.shape[0])]
    return MolStore.from_records(records)


def load_md17(root: str, task: str = "aspirin", synthetic: bool = False,
              synthetic_size: int = 128) -> MolStore:
    """The cached store, built from the raw file on first use; with
    ``synthetic=True`` the stand-in (``data/synthetic.synthetic_md17``)."""
    if synthetic:
        from geossl_tpu_torch.data.synthetic import synthetic_md17

        return synthetic_md17(synthetic_size)
    cache = os.path.join(root, "processed", f"md17_{task}_store.npz")
    if os.path.exists(cache):
        return MolStore.load(cache)
    try:
        store = build_md17(root, task)
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"MD17 raw npz for task {task!r} not found under {root}/raw "
            "(no network egress). Use synthetic=True for the stand-in."
        ) from e
    store.save(cache)
    return store
