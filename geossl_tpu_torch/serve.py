"""Batched inference on trained SchNet or PaiNN weights (counterpart of
``geossl_tpu/serve.py``).

* :class:`Predictor` buckets and pads incoming molecules (every batch is
  padded to ``batch_size`` with empty graph slots), runs each bucket through
  the backbone's whole-stack kernel (``schnet_stack`` / ``painn_stack``) up
  to the backbone's ``*_STACK_MAX_N`` and through its per-block kernels
  (CFConv / the PaiNN message pass) above, and returns results in input
  order.
  Each packed batch is uploaded once; all results come back in one
  device-to-host copy at the end of a pass.
* ``predict`` (scalar property, denormalized with ``y_mean``/``y_std``) and
  ``embed`` (pooled graph representation).
* CLI: ``python -m geossl_tpu_torch.serve [--model_3d painn] --ckpt
  model.pth --input store.npz --mode predict --output preds.csv``.

Work runs on the CUDA device unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from geossl_tpu_torch.config import ModelConfig
from geossl_tpu_torch.data.bucketing import assign_buckets, pack_batch
from geossl_tpu_torch.data.store import MolStore
from geossl_tpu_torch.models import painn, schnet
from geossl_tpu_torch.train.common import make_backbone, make_head

# The largest bucket each backbone serves through its whole-stack kernel
# (0: none; at most the kernels' shape limit, ops/cfconv.STACK_MAX_N =
# ops/painn.STACK_MAX_N = 128), set on the H100 by
# chip_smoke.py's ``serving_route:`` line (PERF.md): the stack is the faster
# route for both backbones at N = 32, 64 and 128. The JAX package's
# STACK_MAX_N (its choice on the TPU) does not route the port.
SCHNET_STACK_MAX_N = 128
PAINN_STACK_MAX_N = 128


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; raises when that is a CUDA
    device and none is available (never runs on the CPU unasked)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain versions on the CPU")
    return device


def _chunks(idx: np.ndarray, size: int):
    for s in range(0, len(idx), size):
        yield idx[s:s + size]


class Predictor:
    """Batched prediction from a backbone state (``cfg.model_3d`` says
    which): ``{"model": backbone state_dict[, "graph_pred_linear": head
    state_dict][, "y_mean", "y_std"]}``. Without a head only :meth:`embed`
    is available."""

    def __init__(self, cfg: ModelConfig, state: dict,
                 y_mean: Optional[float] = None, y_std: Optional[float] = None,
                 batch_size: int = 128,
                 bucket_sizes: Sequence[int] = (32, 64, 128, 256, 512),
                 spatial_sort: str = "auto", device=None):
        if spatial_sort not in ("auto", "on", "off"):
            raise ValueError(f"spatial_sort must be auto/on/off, got "
                             f"{spatial_sort!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        # the initial draw is overwritten by the state
        init = torch.Generator().manual_seed(0)
        self.model = make_backbone(cfg, init)
        self.model.load_state_dict(state["model"])
        self.model.to(self.device).eval()
        self.head = None
        if state.get("graph_pred_linear") is not None:
            self.head = make_head(cfg.model_3d, cfg.emb_dim, init)
            self.head.load_state_dict(state["graph_pred_linear"])
            self.head.to(self.device).eval()
        self.y_mean = float(state.get("y_mean", 0.0) if y_mean is None
                            else y_mean)
        self.y_std = float(state.get("y_std", 1.0) if y_std is None
                           else y_std)
        self.batch_size = batch_size
        self.bucket_sizes = tuple(sorted(bucket_sizes))
        self.spatial_sort = spatial_sort
        if cfg.model_3d == "painn":
            self._stack_apply = painn.fused_stack_apply
            self._stack_max_n = PAINN_STACK_MAX_N
            self._stackable = True
        else:
            self._stack_apply = schnet.fused_stack_apply
            self._stack_max_n = SCHNET_STACK_MAX_N
            # the stack kernel keeps h at one width
            self._stackable = (self.model.num_filters
                               == self.model.hidden_channels)
        # the kernels' [in, out] weight layouts, made once for fixed weights
        with torch.no_grad():
            self._filters = self.model.filter_weights()
            self._stacked = (self.model.stacked_weights() if self._stackable
                             else None)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[ModelConfig] = None,
                        **kw) -> "Predictor":
        """Load a reference-format torch ``.pth``/``.pt``."""
        if not path.endswith((".pth", ".pt")):
            raise ValueError(f"{path!r}: only torch .pth/.pt checkpoints load "
                             "here (msgpack .ckpt loading is not ported yet)")
        from geossl_tpu_torch.utils.torch_import import load_torch_checkpoint

        return cls(cfg or ModelConfig(), load_torch_checkpoint(path), **kw)

    # -- internals --------------------------------------------------------------

    def _maybe_sort(self, store: MolStore) -> MolStore:
        if self.spatial_sort == "off" or len(store) == 0:
            return store
        if self.spatial_sort == "auto" and int(store.num_atoms().max()) < 128:
            return store
        from geossl_tpu_torch.data.transforms import spatial_sort_store

        return spatial_sort_store(store)

    def _batches(self, store: MolStore):
        """Yield (indices, batch on the device); one shape per bucket."""
        bucket_of = assign_buckets(store.num_atoms(), self.bucket_sizes)
        for b in np.unique(bucket_of):
            for chunk in _chunks(np.nonzero(bucket_of == b)[0], self.batch_size):
                records = [store.get(int(i)) for i in chunk]
                batch = pack_batch(records, int(b), self.batch_size)
                yield chunk, batch.to(self.device)

    def stack_route(self, n: int) -> bool:
        """True when a batch padded to ``n`` atoms goes through the
        whole-stack kernel (the backbone's ``*_STACK_MAX_N``), False when
        through the per-block kernels."""
        return self._stackable and n <= self._stack_max_n

    def _graph_repr(self, batch):
        """Pooled representation [B, F], by the route of
        :meth:`stack_route`."""
        args = (batch.atom_type, batch.positions, batch.node_mask)
        if self.stack_route(batch.max_atoms):
            graph, _ = self._stack_apply(self.model, *args,
                                         stacked=self._stacked)
        else:
            graph, _ = self.model(*args, filters=self._filters)
        return graph

    @torch.inference_mode()
    def _run(self, store: MolStore, fn, width: int) -> np.ndarray:
        store = self._maybe_sort(store)
        out = np.zeros((len(store), width), np.float32)
        if len(store) == 0:
            return out
        idx, results = [], []
        for chunk, batch in self._batches(store):
            idx.append(chunk)
            results.append(fn(batch)[: len(chunk)].reshape(len(chunk), width))
        # one device-to-host copy for the whole pass
        out[np.concatenate(idx)] = torch.cat(results).cpu().numpy()
        return out

    def _require_head(self):
        if self.head is None:
            raise ValueError(
                "checkpoint has no 'graph_pred_linear' head: this is a "
                "backbone-only checkpoint; use embed(), or load a fine-tune "
                "checkpoint for predict()")

    # -- public API ---------------------------------------------------------------

    def embed(self, store: MolStore) -> np.ndarray:
        """Pooled graph representations, [M, emb], input order."""
        return self._run(store, self._graph_repr, self.cfg.emb_dim)

    def predict(self, store: MolStore) -> np.ndarray:
        """Scalar predictions (denormalized), [M], input order."""
        self._require_head()

        def fn(batch):
            return self.head(self._graph_repr(batch)) * self.y_std + self.y_mean

        return self._run(store, fn, 1)[:, 0]


# -- CLI -----------------------------------------------------------------------


def load_input_store(path: str) -> MolStore:
    if path.endswith(".npz"):
        return MolStore.load(path)
    raise ValueError(f"unsupported input {path!r} (want a .npz MolStore; "
                     ".sdf input is not ported yet)")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True, help="reference-format .pth")
    p.add_argument("--model_3d", default="schnet", choices=["schnet", "painn"],
                   help="the backbone of the checkpoint, at its default "
                        "configuration")
    p.add_argument("--input", required=True, help=".npz MolStore")
    p.add_argument("--output", default="-", help="CSV path or - for stdout")
    p.add_argument("--mode", default="predict", choices=["predict", "embed"])
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--bucket", type=int, nargs="+",
                   default=[32, 64, 128, 256, 512])
    p.add_argument("--spatial_sort", default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    pred = Predictor.from_checkpoint(
        args.ckpt, ModelConfig(model_3d=args.model_3d),
        batch_size=args.batch_size, bucket_sizes=args.bucket,
        spatial_sort=args.spatial_sort, device=args.device)
    store = load_input_store(args.input)
    rows = pred.predict(store) if args.mode == "predict" else pred.embed(store)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        for i, v in enumerate(rows):
            if args.mode == "predict":
                out.write(f"{i},{v}\n")
            else:
                out.write(",".join([str(i)] + [f"{x:.6g}" for x in v]) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()


if __name__ == "__main__":
    main()
