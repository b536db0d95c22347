"""Featurization of SDF molecule blocks into index-coded NumPy arrays (the
port's own copy of the dependency-free part of
``geossl_tpu/data/featurize.py``; reference
``Geom3D/datasets/datasets_utils.py:14-176``).

The vocabulary is index-coded: atom type = index into ``ATOMIC_NUM_LIST``
(9 classes, index 8 = "unknown", which doubles as the masking token). The
RDKit featurizers are not ported: the card's machine has no RDKit, and
``sdf_block_to_arrays`` gives the same atom types, positions and bond
topology.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

from geossl_tpu_torch.data.structio import SYMBOL_TO_Z, parse_sdf_mol

# {'H':1,'C':6,'N':7,'O':8,'F':9,'P':15,'S':16,'Cl':17} + unknown
ATOMIC_NUM_LIST = [1, 6, 7, 8, 9, 15, 16, 17, "unknown"]
NODE_CLASS = len(ATOMIC_NUM_LIST)  # 9
UNKNOWN_INDEX = NODE_CLASS - 1  # 8: unknown atom == mask token


def atomic_number_to_index(z: int) -> int:
    """Map a true atomic number to the 9-way index code."""
    try:
        return ATOMIC_NUM_LIST.index(z)
    except ValueError:
        return UNKNOWN_INDEX


def sdf_block_to_arrays(block: str) -> Tuple[dict, Dict[int, int]]:
    """One raw SDF molecule block -> (arrays, atom counts by atomic number),
    the arrays of the reference's ``mol_to_graph_data_obj_simple_3D``:
    ``atom_type [N]`` (index-coded), ``chirality [N]`` (unspecified),
    ``positions [N,3]``, ``bond_index [2,2E]`` (both directions),
    ``bond_attr [2E,2]`` (bond type as written in the file, direction 0).
    Raises ``ValueError`` or ``IndexError`` on a block it cannot read."""
    elements, positions, bonds = parse_sdf_mol(block)
    atom_count: Dict[int, int] = defaultdict(int)
    atom_types = []
    for e in elements:
        z = SYMBOL_TO_Z.get(e, -1)
        atom_count[z] += 1
        atom_types.append(atomic_number_to_index(z))

    edges, edge_attrs = [], []
    for i, j, order in bonds:
        bt = min(max(int(order), 1), 4) - 1  # 1/2/3/4(arom) -> 0/1/2/3
        edges += [(i, j), (j, i)]
        edge_attrs += [(bt, 0), (bt, 0)]
    bond_index = (np.asarray(edges, dtype=np.int32).T.reshape(2, -1)
                  if edges else np.zeros((2, 0), np.int32))
    bond_attr = (np.asarray(edge_attrs, dtype=np.int32).reshape(-1, 2)
                 if edge_attrs else np.zeros((0, 2), np.int32))
    return (
        dict(
            atom_type=np.asarray(atom_types, dtype=np.int32),
            chirality=np.zeros(len(atom_types), np.int32),
            positions=positions,
            bond_index=bond_index,
            bond_attr=bond_attr,
        ),
        dict(atom_count),
    )
