"""BFS subgraph masking, GeoSSL's atom-masking augmentation (the port's
NumPy copy of ``geossl_tpu/data/masking.py``; reference
``Geom3D/datasets/datasets_3D.py:24-67``).

Keep a random BFS tree of ``int(N·(1-mask_ratio)) + 1`` nodes over the bond
graph, restarting from a random unvisited node when the frontier empties;
drop everything else and relabel. Runs on the host per molecule; the same
``numpy.random.Generator`` state gives the same subgraph as the JAX
package's NumPy path.
"""

from __future__ import annotations

import numpy as np

from geossl_tpu_torch.data.store import MolRecord


def bfs_subgraph_indices(rng: np.random.Generator, num_nodes: int,
                         bond_index: np.ndarray,
                         mask_ratio: float) -> np.ndarray:
    """The sorted kept-node indices (reference ``subgraph`` :24-44)."""
    sub_num = int(num_nodes * (1 - mask_ratio))
    neighbors = [[] for _ in range(num_nodes)]
    if bond_index is not None and bond_index.size:
        for k in range(bond_index.shape[1]):
            neighbors[int(bond_index[0, k])].append(int(bond_index[1, k]))

    idx_sub = [int(rng.integers(num_nodes))]
    in_sub = np.zeros(num_nodes, bool)
    in_sub[idx_sub[0]] = True
    idx_neigh = set(n for n in neighbors[idx_sub[0]] if not in_sub[n])

    # reference loop: `while len(idx_sub) <= sub_num` keeps sub_num+1 nodes
    while len(idx_sub) <= sub_num:
        if len(idx_neigh) == 0:
            remaining = np.where(~in_sub)[0]
            if len(remaining) == 0:
                break
            idx_neigh = {int(rng.choice(remaining))}
        sample = int(rng.choice(sorted(idx_neigh)))
        idx_sub.append(sample)
        in_sub[sample] = True
        idx_neigh = (idx_neigh | set(neighbors[sample])) - set(idx_sub)

    return np.array(sorted(idx_sub), dtype=np.int64)


def apply_bfs_mask(record: MolRecord, rng: np.random.Generator,
                   mask_ratio: float) -> MolRecord:
    """The BFS-sampled induced subgraph of ``record``, relabeled."""
    if mask_ratio <= 0 or record.num_atoms <= 1:
        return record
    keep = bfs_subgraph_indices(rng, record.num_atoms, record.bond_index,
                                mask_ratio)
    relabel = -np.ones(record.num_atoms, np.int64)
    relabel[keep] = np.arange(len(keep))
    bond = record.bond_index
    if bond is not None and bond.size:
        src, dst = bond
        ok = (relabel[src] >= 0) & (relabel[dst] >= 0)
        bond = np.stack([relabel[src[ok]], relabel[dst[ok]]]).astype(np.int32)
    return MolRecord(
        atom_type=record.atom_type[keep],
        positions=record.positions[keep],
        chirality=None if record.chirality is None else record.chirality[keep],
        bond_index=bond,
        y=record.y,
        forces=None if record.forces is None else record.forces[keep],
    )


def make_bfs_transform(mask_ratio: float):
    """Loader transform applying BFS masking (``pretrain_GeoSSL.py:296``)."""

    def transform(record: MolRecord, rng: np.random.Generator) -> MolRecord:
        return apply_bfs_mask(record, rng, mask_ratio)

    return transform
