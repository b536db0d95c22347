"""Backbone and head construction (the part of ``geossl_tpu/train/common.py``
that serving needs; the training plumbing comes with the training slice)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from geossl_tpu_torch.config import ModelConfig
from geossl_tpu_torch.models.common import init_linear_
from geossl_tpu_torch.models.schnet import SchNet


class LinearHead(nn.Linear):
    """``graph_pred_linear`` for SchNet tasks: ``nn.Linear(emb, 1)``
    (``finetune_qm9.py:113``), returning ``[B]``."""

    def __init__(self, emb_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(emb_dim, 1)
        init_linear_(self, generator)

    def forward(self, x):
        return super().forward(x)[..., 0]


def make_head(model_3d: str, emb_dim: int,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    if model_3d != "schnet":
        raise NotImplementedError(f"{model_3d!r} heads are not ported yet")
    return LinearHead(emb_dim, generator)


def make_backbone(cfg: ModelConfig,
                  generator: Optional[torch.Generator] = None) -> SchNet:
    s = cfg.schnet
    sparse = {"auto": "auto", "on": True, "off": False}[cfg.sparse_tiles]
    return SchNet(
        hidden_channels=cfg.emb_dim,
        num_filters=s.num_filters,
        num_interactions=s.num_interactions,
        num_gaussians=s.num_gaussians,
        cutoff=s.cutoff,
        node_class=s.node_class,
        readout=s.readout,
        max_neighbors=cfg.max_neighbors,
        sparse=sparse,
        generator=generator,
    )
