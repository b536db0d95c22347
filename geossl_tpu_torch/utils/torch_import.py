"""Weights in and out of the port (its own copy of the mapping in
``geossl_tpu/utils/torch_import.py``).

* ``schnet_state_dict_from_flax`` / ``painn_state_dict_from_flax`` /
  ``head_state_dict_from_flax`` (every head, LEP's dual one too, and the
  charge and torsion heads) / ``ncsn_state_dict_from_flax`` (and the
  ``_v1_``/``_v2_`` heads) / ``autoencoder_state_dict_from_flax`` (with its
  ``batch_stats``) / ``distance_head_state_dict_from_flax`` /
  ``infograph_state_dict_from_flax`` turn the JAX package's param trees
  (numpy arrays, flax ``[in, out]`` kernels) into the port's state_dicts
  (torch ``[out, in]`` weights, the reference's key names), keeping the
  arrays' dtype. ``baseline_state_dict_from_flax`` carries a whole
  baseline-pretraining tree (``model``, ``head`` or contextpred's second
  backbone ``context_model``) through them.
* ``load_torch_checkpoint`` reads a reference ``.pth`` of either backbone:
  a bare backbone state_dict or ``{"model": ..., "graph_pred_linear": ...}``.
* ``state_from_flax`` turns a JAX ``.ckpt`` tree (``train/checkpoints.
  load_checkpoint``) into the same ``{"model", "graph_pred_linear"?,
  "y_mean"?, "y_std"?}`` state; ``load_model_state`` reads either file kind
  by its extension.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# keys a reference SchNet state_dict holds that are not parameters here: the
# filter network registered a second time as the CFConv's ``nn`` and the
# derived buffers (distance offsets, masses, the atomref initial value)
_DERIVED = (".conv.nn.", "distance_expansion.", "atomic_mass",
            "initial_atomref", "radial_basis.", "cutoff_fn.")


def _t(a, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(a)
    return torch.tensor(a.T if transpose else a)


def _linear(p, bias: bool = True) -> Dict[str, torch.Tensor]:
    """A flax ``nn.Dense``'s params -> ``nn.Linear``'s."""
    out = {"weight": _t(p["kernel"], transpose=True)}
    if bias:
        out["bias"] = _t(p["bias"])
    return out


def _dense(tree, bias: bool = True) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Dense`` wrapper (one ``nn.Dense`` inside)."""
    return _linear(tree["Dense_0"], bias)


def schnet_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX ``models.SchNet`` params -> ``geossl_tpu_torch`` SchNet
    state_dict (the layout of the JAX package's ``schnet_params_to_torch``)."""
    sd = {"embedding.weight": _t(tree["Embed_0"]["embedding"])}
    n = sum(1 for k in tree if k.startswith("InteractionBlock_"))
    for k in range(n):
        blk, p = tree[f"InteractionBlock_{k}"], f"interactions.{k}."
        sd[p + "mlp.0.weight"] = _t(blk["filter_w1"], transpose=True)
        sd[p + "mlp.0.bias"] = _t(blk["filter_b1"])
        sd[p + "mlp.2.weight"] = _t(blk["filter_w2"], transpose=True)
        sd[p + "mlp.2.bias"] = _t(blk["filter_b2"])
        sd[p + "conv.lin1.weight"] = _dense(blk["Dense_0"], bias=False)["weight"]
        for name, sub in (("conv.lin2.", "Dense_1"), ("lin.", "Dense_2")):
            for kk, v in _dense(blk[sub]).items():
                sd[p + name + kk] = v
    for name, sub in (("lin1.", "Dense_0"), ("lin2.", "Dense_1"),
                      ("dipole_lin.", "Dense_2")):
        if sub in tree:
            for kk, v in _dense(tree[sub]).items():
                sd[name + kk] = v
    if "atomref" in tree:
        sd["atomref.weight"] = _t(tree["atomref"])
    return sd


def painn_state_dict_from_flax(tree, n_interactions=None
                               ) -> Dict[str, torch.Tensor]:
    """JAX ``models.PaiNN`` params -> ``geossl_tpu_torch`` PaiNN state_dict
    (the layout of the JAX package's ``painn_params_to_torch``). A
    ``shared_interactions`` tree holds one block for all layers: pass
    ``n_interactions`` to repeat it under every layer's keys."""
    sd = {"embedding.weight": _t(tree["embedding"]),
          "filter_net.weight": _t(tree["filter_kernel"], transpose=True),
          "filter_net.bias": _t(tree["filter_bias"])}
    shared = "PaiNNInteraction_shared" in tree
    if shared and n_interactions is None:
        raise ValueError("a shared_interactions tree needs n_interactions")
    n = n_interactions or sum(1 for k in tree
                              if k.startswith("PaiNNInteraction_"))
    for k in range(n):
        tag = "shared" if shared else k
        blk, mix = tree[f"PaiNNInteraction_{tag}"], tree[f"PaiNNMixing_{tag}"]
        i, m = f"interactions.{k}.interatomic_context_net.", f"mixing.{k}."
        for j in range(2):
            for kk, v in _dense(blk[f"Dense_{j}"]).items():
                sd[f"{i}{j}.{kk}"] = v
            for kk, v in _dense(mix[f"Dense_{j}"]).items():
                sd[f"{m}intraatomic_context_net.{j}.{kk}"] = v
        sd[m + "mu_channel_mix.weight"] = _dense(mix["mu_channel_mix"],
                                                 bias=False)["weight"]
    return sd


def head_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX ``LinearHead`` (or LEP's ``DualHead``, the same layout) params
    -> ``nn.Linear(emb, 1)`` (``DualHead``'s ``Linear(2·emb, 1)``)
    state_dict; JAX ``PaiNNHead`` params -> the halving MLP's ``0.*``,
    ``1.*``, ..."""
    if "HalvingMLP_0" in tree:
        return {f"{name.split('_')[1]}.{kk}": v
                for name, sub in tree["HalvingMLP_0"].items()
                for kk, v in _dense(sub).items()}
    return _dense(tree["Dense_0"])


def ncsn_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX ``objectives.ncsn.NCSNv3`` params -> the port's ``NCSNv3``
    state_dict: the ten head weights under their own names and shapes, and
    ``out0_h`` as ``nn.Linear(emb, emb, bias=False)``."""
    sd = {k: _t(v) for k, v in tree.items() if k != "out0_h"}
    sd["out0_h.weight"] = _t(tree["out0_h"]["kernel"], transpose=True)
    return sd


def _mlp(tree, prefix: str) -> Dict[str, torch.Tensor]:
    """A flax ``MLP``'s ``Dense_k`` layers -> ``{prefix}layers.{k}.*``."""
    return {f"{prefix}layers.{k}.{kk}": v
            for k in range(len(tree))
            for kk, v in _linear(tree[f"Dense_{k}"]).items()}


def ncsn_v1_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX ``NCSNv1`` params -> the port's ``NCSNv1`` (``output_mlp``)."""
    return _mlp(tree["MLP_0"], "output_mlp.")


def ncsn_v2_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX ``NCSNv2`` params -> the port's ``NCSNv2``: ``distance_mlp``
    (``MLP_0``), ``out0_h``, ``out0_d`` and ``output_mlp`` (``MLP_1``)."""
    sd = {**_mlp(tree["MLP_0"], "distance_mlp."),
          **_mlp(tree["MLP_1"], "output_mlp."),
          "out0_h.weight": _t(tree["out0_h"]["kernel"], transpose=True)}
    sd.update({f"out0_d.{k}": v for k, v in _linear(tree["out0_d"]).items()})
    return sd


def autoencoder_state_dict_from_flax(params, batch_stats=None
                                     ) -> Dict[str, torch.Tensor]:
    """JAX ``AutoEncoder`` params (and its ``batch_stats``) -> the port's
    ``AutoEncoder``: ``fc_layers.0`` (``Dense_0``), ``fc_layers.1``
    (``MaskedBatchNorm_0``: scale as ``weight``, its running mean and
    variance) and ``fc_layers.3`` (``Dense_1``)."""
    bn = params["MaskedBatchNorm_0"]
    sd = {"fc_layers.1.weight": _t(bn["scale"]),
          "fc_layers.1.bias": _t(bn["bias"])}
    for k, sub in ((0, "Dense_0"), (3, "Dense_1")):
        sd.update({f"fc_layers.{k}.{kk}": v
                   for kk, v in _linear(params[sub]).items()})
    if batch_stats is not None:
        stats = batch_stats["MaskedBatchNorm_0"]
        sd["fc_layers.1.running_mean"] = _t(stats["mean"])
        sd["fc_layers.1.running_var"] = _t(stats["var"])
    return sd


def distance_head_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX ``DistancePredictor`` params (one ``kernel`` [2F, 1]) -> the
    port's ``DistancePredictor`` (``nn.Linear(2F, 1)``)."""
    return {"weight": _t(tree["kernel"], transpose=True),
            "bias": _t(tree["bias"])}


def infograph_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """JAX ``InfoGraphDiscriminator`` params -> the port's (``weight``
    [H, H] in the same orientation: ``summary @ weight``)."""
    return {"weight": _t(tree["weight"])}


def baseline_state_dict_from_flax(objective: str, tree, model_3d: str
                                  ) -> Dict[str, torch.Tensor]:
    """A JAX ``pretrain_baselines`` param tree -> the port's ``Baseline``
    state_dict: ``model`` (and contextpred's ``context_model``) through the
    backbone's converter, ``head`` through its own."""
    backbone = (painn_state_dict_from_flax if model_3d == "painn"
                else schnet_state_dict_from_flax)
    head = {"distance": distance_head_state_dict_from_flax,
            "infograph": infograph_state_dict_from_flax}.get(
                objective, head_state_dict_from_flax)
    sd = {}
    for name, conv in (("model", backbone), ("context_model", backbone),
                       ("head", head)):
        if name in tree:
            sd.update({f"{name}.{k}": v for k, v in conv(tree[name]).items()})
    return sd


def _backbone(sd: Dict) -> Dict[str, torch.Tensor]:
    for key in ("state_dict", "model"):
        if isinstance(sd.get(key), dict):
            sd = sd[key]
    for pre in ("module.", "molecule_model_3D."):
        if sd and all(k.startswith(pre) for k in sd):
            sd = {k[len(pre):]: v for k, v in sd.items()}
    if not any(k.startswith(("interactions.0.mlp.", "filter_net."))
               for k in sd):
        raise ValueError("state_dict is neither a reference SchNet nor a "
                         f"PaiNN backbone (keys: {sorted(sd)[:8]}...)")
    return {k: v.float() for k, v in sd.items()
            if not any(tag in k for tag in _DERIVED)}


def load_torch_checkpoint(path: str) -> dict:
    """``.pth`` -> ``{"model": state_dict[, "graph_pred_linear": head]
    [, "y_mean", "y_std"]}``."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: expected a state_dict or a dict of them")
    out = {}
    head = raw.get("graph_pred_linear")
    if isinstance(head, dict):
        out["graph_pred_linear"] = {k: v.float() for k, v in head.items()}
    for key in ("y_mean", "y_std"):
        if key in raw:
            out[key] = float(raw[key])
    body = {k: v for k, v in raw.items()
            if k not in ("graph_pred_linear", "y_mean", "y_std")}
    out["model"] = _backbone(body)
    return out


def backbone_kind(tree) -> str:
    """'schnet' or 'painn': the backbone a JAX param tree holds, by its
    keys."""
    if "Embed_0" in tree or "InteractionBlock_0" in tree:
        return "schnet"
    if "filter_kernel" in tree or any(k.startswith("PaiNNInteraction_")
                                      for k in tree):
        return "painn"
    raise ValueError("the checkpoint's 'model' tree is neither a SchNet nor "
                     f"a PaiNN backbone (keys: {sorted(tree)[:8]}...)")


def state_from_flax(tree, cfg) -> dict:
    """A JAX checkpoint tree (``{"model": backbone[, "graph_pred_linear":
    head][, "y_mean", "y_std"], ...}``) -> ``{"model": state_dict[,
    "graph_pred_linear": head state_dict][, "y_mean", "y_std"]}`` for a
    backbone of ``cfg``. Raises when the tree holds the other backbone than
    ``cfg.model_3d``; the other keys that pretraining checkpoints carry
    (objective heads, statistics) are ignored, as the JAX loaders ignore
    them."""
    kind = backbone_kind(tree["model"])
    if kind != cfg.model_3d:
        raise ValueError(f"the checkpoint holds a {kind} backbone, but the "
                         f"configuration asks for model_3d={cfg.model_3d!r}")
    if kind == "painn":
        shared = "PaiNNInteraction_shared" in tree["model"]
        model = painn_state_dict_from_flax(
            tree["model"], cfg.painn.n_interactions if shared else None)
    else:
        model = schnet_state_dict_from_flax(tree["model"])
    out = {"model": model}
    if isinstance(tree.get("graph_pred_linear"), dict):
        out["graph_pred_linear"] = head_state_dict_from_flax(
            tree["graph_pred_linear"])
    for key in ("y_mean", "y_std"):
        if key in tree:
            out[key] = float(tree[key])
    return out


def load_model_state(path: str, cfg) -> dict:
    """A JAX ``.ckpt`` (through :func:`state_from_flax`) or a reference
    ``.pth``/``.pt`` (:func:`load_torch_checkpoint`) -> the state a
    Predictor or a fine-tune's ``--input_model_file`` loads."""
    if path.endswith(".ckpt"):
        from geossl_tpu_torch.train.checkpoints import load_checkpoint

        return state_from_flax(load_checkpoint(path), cfg)
    if path.endswith((".pth", ".pt")):
        return load_torch_checkpoint(path)
    raise ValueError(f"{path!r}: want a JAX .ckpt or a torch .pth/.pt "
                     "checkpoint")
