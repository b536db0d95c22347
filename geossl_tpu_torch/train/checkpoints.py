"""Checkpoints in torch format (counterpart of
``geossl_tpu/train/checkpoints.py``).

The backbone checkpoint is the reference's transfer contract
(``pretrain_GeoSSL.py:48-65``): ``torch.save({"model": state_dict})`` as
``model.pth`` on the best epoch-mean train loss and ``model_final.pth`` at
the end; ``serve.Predictor.from_checkpoint`` and the reference load it as
it is. The resume state (model, heads, optimizer, schedule, epoch, best
metric, driver scalars) is one ``state.pth``. ``load_checkpoint`` also
reads the JAX package's msgpack ``.ckpt`` files (``utils/flax_msgpack``:
the tree of numpy arrays that the JAX drivers wrote;
``utils/torch_import.state_from_flax`` turns it into the port's
state_dicts). The port writes only ``.pth``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    """Write ``tree`` (state_dicts and scalars) with its tensors on the CPU;
    a killed job never leaves a torn file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_cpu(tree), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A ``.pth`` tree on the CPU, or a JAX ``.ckpt`` tree (numpy arrays and
    scalars, flax's layout)."""
    if path.endswith(".ckpt"):
        from geossl_tpu_torch.utils import flax_msgpack

        return flax_msgpack.load(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def save_train_state(path: str, state: Dict[str, Any], epoch: int,
                     best_metric: float = float("inf"),
                     extra: Dict[str, float] | None = None) -> None:
    """Full state for a mid-training resume: ``state`` maps names to
    state_dicts (modules, optimizer, lr schedule)."""
    save_checkpoint(path, {
        "state": state, "epoch": int(epoch), "best_metric": float(best_metric),
        "extra": {k: float(v) for k, v in (extra or {}).items()}})


def load_train_state(path: str):
    """(state dict of state_dicts, epoch, best metric, extra scalars)."""
    payload = load_checkpoint(path)
    return (payload["state"], int(payload["epoch"]),
            float(payload.get("best_metric", float("inf"))),
            dict(payload.get("extra", {})))


class BestModelSaver:
    """Best-by-metric and final checkpoints, lower is better (the
    reference's ``save_model``, ``pretrain_GeoSSL.py:48-65``)."""

    def __init__(self, output_dir: str, best_name: str = "model.pth",
                 final_name: str = "model_final.pth"):
        self.output_dir = output_dir
        self.best_name = best_name
        self.final_name = final_name
        self.best_metric = float("inf")

    def maybe_save_best(self, metric: float, tree) -> bool:
        """Save when ``metric`` is strictly below the best so far (a NaN
        never wins). ``tree`` may be a zero-argument callable, so that an
        epoch that does not improve copies nothing from the device."""
        if not self.output_dir or not metric < self.best_metric:
            return False
        self.best_metric = metric
        save_checkpoint(os.path.join(self.output_dir, self.best_name),
                        tree() if callable(tree) else tree)
        return True

    def save_final(self, tree: Dict[str, Any]) -> None:
        if self.output_dir:
            save_checkpoint(os.path.join(self.output_dir, self.final_name), tree)
