"""Typed model configuration (counterpart of ``geossl_tpu/config.py``).

Same defaults as the JAX package, for both backbones (SchNet and PaiNN).
``use_pallas`` has no counterpart: the device of the tensors decides
between kernel and plain version.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class SchNetConfig:
    """SchNet hyperparameters (reference ``Geom3D/models/schnet.py:17-30``,
    CLI defaults ``examples/config.py:111-115``)."""

    hidden_channels: int = 128
    num_filters: int = 128
    num_interactions: int = 6
    num_gaussians: int = 51
    cutoff: float = 10.0
    node_class: int = 9
    readout: str = "mean"  # {"mean", "add"}


@dataclass(frozen=True)
class PaiNNConfig:
    """PaiNN hyperparameters (reference ``Geom3D/models/painn.py:125-142``,
    CLI defaults ``examples/config.py:118-121``)."""

    n_atom_basis: int = 128  # == emb_dim in the reference scripts
    n_interactions: int = 3
    n_rbf: int = 20
    cutoff: float = 5.0
    readout: str = "add"  # {"mean", "add"}
    max_z: int = 9  # node_class passed as max_z (pretrain_GeoSSL.py:39)
    shared_interactions: bool = False
    shared_filters: bool = False
    epsilon: float = 1e-8


@dataclass(frozen=True)
class ModelConfig:
    model_3d: str = "schnet"  # {"schnet", "painn"}
    emb_dim: int = 128
    schnet: SchNetConfig = field(default_factory=SchNetConfig)
    painn: PaiNNConfig = field(default_factory=PaiNNConfig)
    compute_dtype: str = "float32"
    filter_mxu: str = "f32"
    # keep each atom's k nearest in-cutoff neighbors (torch_cluster's
    # max_num_neighbors); None keeps full neighborhoods
    max_neighbors: Optional[int] = None
    # occupancy-gated pair tiles: "auto" from N=128 up, "on", "off"
    sparse_tiles: str = "auto"
    # pair-grid model parallelism: "pair" runs each message pass on this
    # rank's j-stripe of the pair grid (parallel/pair_parallel.py)
    pair_axis: Optional[str] = None

    def __post_init__(self):
        # argparse validates CLI input; this catches direct construction
        # with a typo (e.g. 'bf-16'), which would otherwise run f32
        if self.filter_mxu not in ("f32", "bf16"):
            raise ValueError(f"filter_mxu must be 'f32' or 'bf16', got "
                             f"{self.filter_mxu!r}")
        if self.model_3d not in ("schnet", "painn"):
            raise ValueError(f"model_3d must be 'schnet' or 'painn', "
                             f"got {self.model_3d!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.compute_dtype!r}")
        if self.sparse_tiles not in ("auto", "on", "off"):
            raise ValueError(f"sparse_tiles must be 'auto', 'on' or 'off', "
                             f"got {self.sparse_tiles!r}")
        if self.max_neighbors is not None and self.max_neighbors <= 0:
            raise ValueError(f"max_neighbors must be positive or None, got "
                             f"{self.max_neighbors}")

    @property
    def backbone(self):
        return self.schnet if self.model_3d == "schnet" else self.painn
