"""Sealed serving artifacts (counterpart of ``geossl_tpu/export.py``).

A :class:`~geossl_tpu_torch.serve.Predictor` is **sealed** into one zip:
each per-batch function it serves with is exported once per shape by
``torch.export`` (non-strict) and saved as a program, beside the weights
and the batching metadata. :class:`SealedPredictor` replays the artifact
with the Predictor's public API without building a model: no backbone
``nn.Module``, no ``make_backbone``. Only the host-side bucketing, packing
and ordering run in Python (``serve._Passes``, shared with the Predictor).

    pred = Predictor.from_checkpoint("runs/x/model.pth", cfg)
    seal(pred, "model.sealed", modes=("predict", "embed"))
    SealedPredictor.load("model.sealed").predict(store)

* **Programs.** One per (mode, bucket) for ``predict``, ``embed`` and
  ``forces``, and one per (bucket_active, bucket_inactive) over
  ``pair_buckets`` for ``pairs``, each ``programs/<name>.pt2``. The
  kernels appear in them as the ``torch.library`` custom ops of
  ``ops/_launch.kernel_op`` (``geossl_torch::*``); the route of each bucket
  (whole stack up to ``*_STACK_MAX_N``, per-block kernels above, the
  occupancy gating from N=128) is fixed when it is exported, since it
  depends on N only. The forces programs hold the first-order backward
  kernels: the ``torch.autograd.grad`` of ``-dE/dpos`` is traced into them.
* **The graph-slot dimension** is dynamic (``torch.export.Dim``, from 8 to
  ``batch_size`` slots), so a sealed pass packs a partial chunk into
  ``ceil8(count)`` slots as the live Predictor does. (With ``batch_size``
  at most 8 every chunk has ``batch_size`` slots and the dimension is
  static.)
* **Weights once.** ``weights.pt`` holds the backbone's and the head's
  state (``model.*``, ``head.*``) and the kernels' prepared layouts
  (``filter_weights``/``stacked_weights``); every program takes them as
  inputs (``torch.func.functional_call``), so none holds a copy.
* ``meta.json``: ``format_version`` 1, modes, buckets, ``pair_buckets``,
  ``batch_size``, ``model_3d``, ``emb_dim``, the head's kind, ``y_mean``,
  ``y_std`` (also traced into the programs), ``spatial_sort``, ``device``
  (``cuda`` or ``cpu``: the Predictor's) and the torch version.

A ``cuda`` artifact needs a card: loading it without one raises, it never
runs on the CPU. A ``cpu`` artifact (sealed from ``Predictor(device=
"cpu")``) holds the plain versions. A shape outside the sealed ladder, a
mode that was not sealed and another ``format_version`` raise. A
backbone-only checkpoint seals only ``embed``; a LEP (dual-head) one
``embed`` and ``pairs``.

CLI: ``python -m geossl_tpu_torch.export --ckpt runs/x/model.pth --out
m.sealed [--model_3d painn] [--modes ...] [--device cpu]``, then
``python -m geossl_tpu_torch.serve --ckpt m.sealed --input mols.sdf``.
"""

from __future__ import annotations

import argparse
import io
import json
import zipfile
from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils import _pytree as pytree

from geossl_tpu_torch.serve import SLOT_MULTIPLE, Predictor, _Passes

FORMAT_VERSION = 1
ALL_MODES = ("predict", "embed", "forces", "pairs")
# the per-batch function each mode exports, and the head it needs
_MODE_FN = {"predict": ("_predict_fn", "single"), "embed": ("_embed_fn", None),
            "forces": ("_energy_forces_fn", "single"),
            "pairs": ("_pair_logit_fn", "dual")}


class _Served(nn.Module):
    """The Predictor's backbone and head under one root, so that
    ``functional_call`` swaps the parameters of both for a program's weight
    inputs."""

    def __init__(self, model: nn.Module, head: Optional[nn.Module]):
        super().__init__()
        self.model = model
        if head is not None:
            self.head = head

    def forward(self, fn, prep, batch):
        return fn(prep, *batch)


class _Program(nn.Module):
    """One per-batch function as ``forward(weights, prep, batch)``. The
    backbone is kept out of the module's attributes, so that export lifts
    no parameter into the program: every weight is an input."""

    def __init__(self, served: _Served, fn):
        super().__init__()
        self.__dict__["_served"] = served
        self.__dict__["_fn"] = fn

    def forward(self, weights, prep, batch):
        return torch.func.functional_call(self._served, weights,
                                          (self._fn, prep, batch))


def _example(n: int, slots: int, device) -> tuple:
    """(atom_type, positions, node_mask) of ``slots`` graphs at bucket size
    ``n``: the shapes and dtypes ``data/bucketing.pack_batch`` gives."""
    gen = torch.Generator().manual_seed(0)
    atom_type = torch.randint(1, 9, (slots, n), generator=gen)
    positions = torch.randn((slots, n, 3), generator=gen) * 2.0
    node_mask = torch.ones((slots, n), dtype=torch.bool)
    return tuple(t.to(device) for t in (atom_type, positions, node_mask))


def _export(program: nn.Module, args: tuple, dynamic_shapes, backward: bool):
    """``torch.export`` (non-strict) of ``program``. A program that takes
    ``torch.autograd.grad`` inside (``backward``: the forces) is traced at
    the ATen level after autograd (``pre_dispatch=False``, export's older
    IR): the pre-dispatch tracing of ``torch.export.export`` runs autograd's
    backward formulas outside the tracer, so their scalar constants (the 2
    of sqrt's derivative) end up as fake tensors in the program's constants
    and export refuses it."""
    if not backward:
        return torch.export.export(program, args,
                                   dynamic_shapes=dynamic_shapes, strict=False)
    from torch.export._trace import _export as export_aten

    return export_aten(program, args, dynamic_shapes=dynamic_shapes,
                       strict=False, pre_dispatch=False)


def seal(pred: Predictor, path: str,
         modes: Sequence[str] = ("predict", "embed"),
         pair_buckets: Optional[Sequence[int]] = None) -> Dict[str, int]:
    """Export ``pred``'s per-batch functions into a sealed artifact at
    ``path``; ``pair_buckets`` (default: the whole ladder) limits the
    ``pairs`` programs, one per (bucket_active, bucket_inactive). Returns
    each program's size in bytes. A mode whose head the checkpoint lacks
    raises as serving it would."""
    bad = [m for m in modes if m not in ALL_MODES]
    if bad:
        raise ValueError(f"unknown modes {bad}; choose from {ALL_MODES}")
    if pred.num_devices > 1:
        raise ValueError("sealing a multi-device Predictor is not supported; "
                         "build it with num_devices=None")
    for m in modes:
        if _MODE_FN[m][1] is not None:
            pred._require_head(_MODE_FN[m][1])
    pb = tuple(sorted(pair_buckets or pred.bucket_sizes)) \
        if "pairs" in modes else ()
    unknown = [n for n in pb if n not in pred.bucket_sizes]
    if unknown:
        raise ValueError(f"pair_buckets {unknown} are not in the predictor's "
                         f"ladder {pred.bucket_sizes}")
    served = _Served(pred.model, pred.head)
    weights = {k: v.detach() for k, v in served.state_dict().items()}
    prep = pred._prep
    bs = pred.batch_size
    slots = torch.export.Dim("slots", min=SLOT_MULTIPLE, max=bs) \
        if bs > SLOT_MULTIPLE else None
    # an example slot count unlike any static size of the model (a hint
    # equal to one could make export specialise the dimension to it)
    ex_slots = max(SLOT_MULTIPLE, bs - SLOT_MULTIPLE) if slots else bs
    static = (pytree.tree_map(lambda _: None, weights),
              pytree.tree_map(lambda _: None, prep))

    def export(fn_name, *buckets) -> bytes:
        batch = sum((_example(n, ex_slots, pred.device) for n in buckets), ())
        dyn = (*static, tuple({0: slots} if slots else None for _ in batch))
        # opt_einsum's contraction-path search compares the sizes of the
        # plain versions' einsums, which would specialise the dimension
        with torch.backends.opt_einsum.flags(enabled=False):
            ep = _export(_Program(served, getattr(pred, fn_name)),
                         (weights, prep, batch), dyn,
                         backward=fn_name == "_energy_forces_fn")
        # export keeps its example inputs (the weights among them) and
        # would save them into every program
        ep.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        return buf.getvalue()

    programs: Dict[str, bytes] = {}
    for mode in modes:
        fn_name = _MODE_FN[mode][0]
        if mode == "pairs":
            for na in pb:
                for ni in pb:
                    programs[f"pairs_{na}x{ni}"] = export(fn_name, na, ni)
        else:
            for n in pred.bucket_sizes:
                programs[f"{mode}_{n}"] = export(fn_name, n)
    meta = {
        "format_version": FORMAT_VERSION,
        "modes": sorted(modes),
        "bucket_sizes": list(pred.bucket_sizes),
        "pair_buckets": list(pb),
        "batch_size": bs,
        "model_3d": pred.cfg.model_3d,
        "emb_dim": pred.emb_dim,
        "head": pred.head_kind,
        "y_mean": pred.y_mean,
        "y_std": pred.y_std,
        "spatial_sort": pred.spatial_sort,
        "device": pred.device.type,
        "torch_version": torch.__version__,
    }
    buf = io.BytesIO()
    torch.save({"weights": {k: v.cpu() for k, v in weights.items()},
                "prep": pytree.tree_map(lambda t: t.detach().cpu(), prep)},
               buf)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr("weights.pt", buf.getvalue())
        for name, blob in programs.items():
            z.writestr(f"programs/{name}.pt2", blob)
    return {k: len(v) for k, v in programs.items()}


class SealedPredictor(_Passes):
    """Serve a sealed artifact with the Predictor's public API (``predict``,
    ``embed``, ``predict_forces``, ``predict_pairs``), model-free: the pass
    logic is the Predictor's, the per-batch functions call the program of
    the batch's shape, each loaded on first use."""

    def __init__(self, meta: dict, weights: dict, prep, programs: dict):
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"unsupported artifact format_version "
                             f"{meta.get('format_version')} (this build reads "
                             f"{FORMAT_VERSION})")
        if meta["device"] == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("this artifact was sealed for a CUDA device and "
                               "none is available (it never runs on the "
                               "CPU); seal from Predictor(device='cpu') for "
                               "a CPU artifact")
        # the programs call the kernels' custom ops: register them
        from geossl_tpu_torch.ops import cfconv, ncsn, painn  # noqa: F401

        self.meta = meta
        self.device = torch.device(meta["device"])
        self.modes = tuple(meta["modes"])
        self.batch_size = int(meta["batch_size"])
        self.bucket_sizes = tuple(meta["bucket_sizes"])
        self.spatial_sort = meta["spatial_sort"]
        self.emb_dim = int(meta["emb_dim"])
        self.head_kind = meta["head"]
        self.y_mean, self.y_std = float(meta["y_mean"]), float(meta["y_std"])
        self._weights = {k: v.to(self.device) for k, v in weights.items()}
        self._prep = pytree.tree_map(lambda t: t.to(self.device), prep)
        self._blobs = programs
        self._loaded: Dict[str, object] = {}

    @classmethod
    def load(cls, path: str) -> "SealedPredictor":
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read("meta.json"))
            state = torch.load(io.BytesIO(z.read("weights.pt")),
                               map_location="cpu", weights_only=True)
            programs = {name[len("programs/"):-len(".pt2")]: z.read(name)
                        for name in z.namelist()
                        if name.startswith("programs/")
                        and name.endswith(".pt2")}
        return cls(meta, state["weights"], state["prep"], programs)

    def _program(self, name: str):
        prog = self._loaded.get(name)
        if prog is None:
            blob = self._blobs.get(name)
            if blob is None:
                mode = name.split("_")[0]
                have = sorted(k for k in self._blobs if k.startswith(mode + "_"))
                raise ValueError(
                    f"the sealed artifact has no program {name!r} (for "
                    f"{mode!r} it has {have or 'none: the mode was not sealed'}"
                    "); re-seal with this mode and bucket")
            prog = torch.export.load(io.BytesIO(blob)).module()
            self._loaded[name] = prog
        return prog

    def _call(self, name, prep, batch):
        return self._program(name)(self._weights, prep, batch)

    def _check_forces(self):
        if "forces" not in self.modes:
            raise ValueError(f"the artifact was sealed without 'forces' (its "
                             f"modes: {list(self.modes)})")

    def _embed_fn(self, prep, atom_type, positions, node_mask):
        return self._call(f"embed_{atom_type.shape[1]}", prep,
                          (atom_type, positions, node_mask))

    def _predict_fn(self, prep, atom_type, positions, node_mask):
        return self._call(f"predict_{atom_type.shape[1]}", prep,
                          (atom_type, positions, node_mask))

    def _energy_forces_fn(self, prep, atom_type, positions, node_mask):
        return self._call(f"forces_{atom_type.shape[1]}", prep,
                          (atom_type, positions, node_mask))

    def _pair_logit_fn(self, prep, za, pa, ma, zi, pi, mi):
        return self._call(f"pairs_{za.shape[1]}x{zi.shape[1]}", prep,
                          (za, pa, ma, zi, pi, mi))


# -- CLI -----------------------------------------------------------------------


def build_parser():
    p = argparse.ArgumentParser(
        description="Seal a checkpoint into a serving artifact (torch.export "
                    "programs, weights and metadata in one zip).")
    p.add_argument("--ckpt", required=True,
                   help="torch .pth/.pt or JAX model[_final].ckpt")
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--model_3d", default="schnet", choices=["schnet", "painn"])
    p.add_argument("--modes", nargs="+", default=["predict", "embed"],
                   choices=list(ALL_MODES))
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--bucket", type=int, nargs="+",
                   default=[32, 64, 128, 256, 512])
    p.add_argument("--pair_bucket", type=int, nargs="+", default=None,
                   help="limit the 'pairs' programs to these buckets "
                        "(default: the whole ladder, quadratic in its length)")
    p.add_argument("--spatial_sort", default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the kernels) or cpu (the plain "
                        "versions): the device the artifact runs on")
    return p


def main(argv=None):
    from geossl_tpu_torch.config import ModelConfig

    args = build_parser().parse_args(argv)
    pred = Predictor.from_checkpoint(
        args.ckpt, ModelConfig(model_3d=args.model_3d),
        batch_size=args.batch_size, bucket_sizes=args.bucket,
        spatial_sort=args.spatial_sort, device=args.device)
    sizes = seal(pred, args.out, modes=args.modes,
                 pair_buckets=args.pair_bucket)
    total = sum(sizes.values())
    print(f"sealed {len(sizes)} programs ({total / 1e6:.2f} MB) -> {args.out}")
    for name in sorted(sizes):
        print(f"  {name}: {sizes[name] / 1e3:.1f} kB")


if __name__ == "__main__":
    main()
