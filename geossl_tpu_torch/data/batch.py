"""Dense padded molecular batches as torch tensors (counterpart of
``geossl_tpu/data/batch.py``).

* ``atom_type  [B, N] int64`` index-coded atom types, 0 on padding
* ``positions  [B, N, 3] float32``
* ``node_mask  [B, N] bool``  True for real atoms
* ``graph_mask [B] bool``     True for real graphs, False for the empty slots
  that pad a partial batch
* ``forces     [B, N, 3] float32`` MD17's force labels, 0 on padding (only
  when the loader packs them)
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

import torch


@dataclass
class DenseMolBatch:
    atom_type: torch.Tensor
    positions: torch.Tensor
    node_mask: torch.Tensor
    y: Optional[torch.Tensor] = None  # [B, T]
    graph_mask: Optional[torch.Tensor] = None  # [B]
    forces: Optional[torch.Tensor] = None  # [B, N, 3]

    @property
    def batch_size(self) -> int:
        return self.atom_type.shape[0]

    @property
    def max_atoms(self) -> int:
        return self.atom_type.shape[1]

    def num_atoms(self) -> torch.Tensor:
        return self.node_mask.sum(dim=1)

    def to(self, device, non_blocking: bool = False) -> "DenseMolBatch":
        """The batch with every tensor on ``device``."""
        return replace(self, **{
            f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in fields(self) if getattr(self, f.name) is not None})

    def pin_memory(self) -> "DenseMolBatch":
        """The batch in page-locked host memory, from which ``to(cuda,
        non_blocking=True)`` copies without the host waiting."""
        return replace(self, **{
            f.name: getattr(self, f.name).pin_memory()
            for f in fields(self) if getattr(self, f.name) is not None})


@dataclass
class DualMolBatch:
    """A padded batch of (active, inactive) structure pairs for LEP, both
    towers at one padded width (reference
    ``Geom3D/dataloaders/dataloaders_LEP.py:6-68``)."""

    active: DenseMolBatch
    inactive: DenseMolBatch
    y: torch.Tensor  # [B] float binary labels

    @property
    def max_atoms(self) -> int:
        return self.active.max_atoms

    def to(self, device, non_blocking: bool = False) -> "DualMolBatch":
        return DualMolBatch(self.active.to(device, non_blocking),
                            self.inactive.to(device, non_blocking),
                            self.y.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "DualMolBatch":
        return DualMolBatch(self.active.pin_memory(),
                            self.inactive.pin_memory(), self.y.pin_memory())
