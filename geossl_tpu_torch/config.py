"""Typed configuration (counterpart of ``geossl_tpu/config.py``): the
backbones' hyperparameters, the pretraining, data and training knobs, and
the presets of the reference's published sweeps.

Same defaults as the JAX package, for both backbones (SchNet and PaiNN).
``ModelConfig.use_pallas`` has no counterpart: the device of the tensors
decides between kernel and plain version.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


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


@dataclass(frozen=True)
class GeoSSLConfig:
    """GeoSSL pretraining knobs (``examples/config.py:148-158``)."""

    option: str = "DDM"  # {"DDM", "EBM_NCE", "InfoNCE", "RR"}
    mu: float = 0.0  # view-noise mean     (GeoSSL_mu)
    sigma: float = 0.3  # view-noise stddev (GeoSSL_sigma)
    atom_masking_ratio: float = 0.3  # BFS subgraph mask ratio
    # NCSN / denoising distance matching (SM_* flags):
    sm_sigma_begin: float = 10.0
    sm_sigma_end: float = 0.01
    sm_num_noise_level: int = 50
    sm_noise_type: str = "symmetry"  # {"symmetry", "random"}
    sm_anneal_power: float = 2.0
    # Contrastive:
    T: float = 0.1  # InfoNCE temperature (config.py:171)
    normalize: bool = False
    # RR autoencoder:
    ae_loss: str = "l2"  # {"l1", "l2", "cosine"}
    detach_target: bool = True
    # beta (config.py:182) weights the KL term of GraphMVP's VAE variant;
    # the plain AutoEncoder the RR objective uses ignores it, as upstream.
    beta: float = 1.0


@dataclass(frozen=True)
class SSLHeadConfig:
    """Baseline SSL objective knobs (``examples/config.py:123-130``)."""

    charge_masking_ratio: float = 0.3
    distance_sample_ratio: float = 1.0
    torsion_angle_sample_ratio: float = 0.001


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "QM9"
    task: str = "alpha"
    data_root: str = "data"
    # padded bucket sizes: every batch's atom axis is padded to one of these
    bucket_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    # train-split z-normalization of targets is applied by the drivers
    split: str = "customized_01"
    seed: int = 42


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 128
    md17_train_batch_size: int = 5  # scripts/finetune/submit_finetune_md17_*.sh
    epochs: int = 100
    lr: float = 1e-4
    decay: float = 0.0  # Adam weight decay
    lr_scheduler: str = "CosineAnnealingLR"  # or "none", "StepLR"
    lr_decay_factor: float = 0.5
    lr_decay_step_size: int = 100
    min_lr: float = 1e-6
    loss: str = "mae"  # {"mae", "mse"} for regression fine-tunes
    md17_energy_coeff: float = 0.05
    md17_force_coeff: float = 0.95
    seed: int = 42
    eval_batch_size: int = 128
    num_data_shards: int = 1  # data-parallel devices


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    geossl: GeoSSLConfig = field(default_factory=GeoSSLConfig)
    ssl: SSLHeadConfig = field(default_factory=SSLHeadConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    output_model_dir: str = ""
    input_model_file: str = ""

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# Presets of the reference's published sweeps (SURVEY.md §2.7); no driver
# reads them, as in the JAX package.


def preset_pretrain_ddm(model_3d: str = "schnet") -> Config:
    """GeoSSL-DDM pretraining on Molecule3D
    (``scripts/pretrain_GeoSSL_DDM/submit_pretrain_GeoSSL_DDM.sh:2-28``)."""
    return Config(
        model=ModelConfig(model_3d=model_3d),
        geossl=GeoSSLConfig(option="DDM"),
        data=DataConfig(dataset="Molecule3D_1000000"),
        train=TrainConfig(batch_size=128, epochs=100, lr=5e-4),
    )


def preset_finetune_qm9(model_3d: str = "schnet", task: str = "mu") -> Config:
    """QM9 fine-tune (``scripts/finetune/submit_finetune_qm9_schnet.sh:6-16``)."""
    return Config(
        model=ModelConfig(model_3d=model_3d),
        data=DataConfig(dataset="QM9", task=task, split="customized_01"),
        train=TrainConfig(batch_size=128, epochs=1000, lr=5e-4, loss="mae"),
    )


def preset_finetune_md17(model_3d: str = "schnet",
                         task: str = "aspirin") -> Config:
    """MD17 fine-tune (``scripts/finetune/submit_finetune_md17_schnet.sh:9-19``)."""
    return Config(
        model=ModelConfig(model_3d=model_3d),
        data=DataConfig(dataset="MD17", task=task),
        train=TrainConfig(batch_size=128, md17_train_batch_size=5,
                          epochs=1000, lr=5e-4),
    )


def preset_finetune_lba(model_3d: str = "schnet") -> Config:
    """Atom3D LBA (``scripts/finetune/submit_finetune_lba_lep_schnet.sh:8-33``)."""
    return Config(
        model=ModelConfig(model_3d=model_3d),
        data=DataConfig(dataset="LBA", split="atom3d_lba_split30"),
        train=TrainConfig(batch_size=64, epochs=300, lr=1e-4),
    )


def preset_finetune_lep(model_3d: str = "schnet") -> Config:
    """Atom3D LEP (``scripts/finetune/submit_finetune_lba_lep_schnet.sh:28-33``)."""
    return Config(
        model=ModelConfig(model_3d=model_3d),
        data=DataConfig(dataset="LEP"),
        train=TrainConfig(batch_size=16, epochs=300, lr=1e-4),
    )
