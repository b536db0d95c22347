"""Batched inference on trained SchNet or PaiNN weights (counterpart of
``geossl_tpu/serve.py``).

* :class:`Predictor` buckets and pads incoming molecules (a full chunk
  fills ``batch_size`` graph slots; a partial one is packed to its own
  count rounded up to a multiple of 8: the port compiles nothing, so
  unlike the JAX package's static shapes it need not pad a small bucket to
  ``batch_size``), runs each bucket through
  the backbone's whole-stack kernel (``schnet_stack`` / ``painn_stack``) up
  to the backbone's ``*_STACK_MAX_N`` and through its per-block kernels
  (CFConv / the PaiNN message pass) above (a bfloat16 model, and SchNet
  with ``filter_mxu='bf16'``, at every bucket: the stacks compute in f32,
  as the JAX package routes bf16), and returns results in input order.
  Each packed batch is uploaded once; all results come back in one
  device-to-host copy at the end of a pass.
* ``predict`` (scalar property, denormalized with ``y_mean``/``y_std``),
  ``embed`` (pooled graph representation), ``predict_forces`` (MD17:
  energies and forces ``-dE/dpos``, through the per-block kernels and
  their first-order backwards at every bucket) and ``predict_pairs`` (LEP
  dual-tower probabilities: pairs grouped by (bucket_active,
  bucket_inactive), both towers by the route of their own bucket).
* The pass logic (bucketing, packing into :func:`batch_slots`, input
  order, the one fetch) calls four per-batch functions, ``_embed_fn``,
  ``_predict_fn``, ``_energy_forces_fn`` and ``_pair_logit_fn``; the
  sealed artifacts' ``export.SealedPredictor`` replaces them by exported
  programs.
* Checkpoints: the port's or the reference's ``.pth``/``.pt``, or a JAX
  ``model[_final].ckpt`` (``utils/torch_import.load_model_state``). A
  ``graph_pred_linear.weight`` of shape ``[1, 2·emb]`` is LEP's
  ``DualHead``, any other head the backbone's single head.
* Input: an ``.npz`` MolStore or a raw ``.sdf`` file (:func:`store_from_sdf`).
* CLI: ``python -m geossl_tpu_torch.serve [--model_3d painn] --ckpt
  model.pth|model.ckpt|m.sealed --input store.npz|mols.sdf --mode
  predict|embed|forces|pairs [--input_inactive inactive.npz] --output
  preds.csv``.

Work runs on the CUDA device unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version. With
``num_devices=n`` (``serve --num_devices n``) one process serves on n
devices (``cuda:0`` .. ``cuda:n-1``; n copies on the CPU): the weights are
made once on each, each packed batch is split over them by rows and the
rows come back in order; the batch size is rounded up to a multiple of n,
as the JAX package's data mesh does.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from geossl_tpu_torch.config import ModelConfig
from geossl_tpu_torch.data.bucketing import (
    assign_buckets,
    find_native_packer,
    native_batch,
    pack_batch,
)
from geossl_tpu_torch.data.store import MolRecord, MolStore
from geossl_tpu_torch.models import painn, schnet
from geossl_tpu_torch.ops import cfconv
from geossl_tpu_torch.train.common import (
    DualHead,
    check_kernel_limits,
    make_backbone,
    make_head,
)

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


# A partial chunk is packed to its count rounded up to a multiple of this,
# so that a pass sees few batch shapes (and later CUDA graphs few graphs).
SLOT_MULTIPLE = 8


def _chunks(idx: np.ndarray, size: int):
    for s in range(0, len(idx), size):
        yield idx[s:s + size]


def batch_slots(count: int, batch_size: int) -> int:
    """Graph slots of a packed chunk of ``count`` molecules: ``count``
    rounded up to a multiple of ``SLOT_MULTIPLE``, at most
    ``batch_size``."""
    return min(batch_size, -(-count // SLOT_MULTIPLE) * SLOT_MULTIPLE)


def head_kind(state: dict, emb_dim: int) -> Optional[str]:
    """None (no head), 'dual' (LEP's ``DualHead``: ``graph_pred_linear.
    weight`` of shape [1, 2·emb]) or 'single' (the backbone's own head)."""
    head = state.get("graph_pred_linear")
    if head is None:
        return None
    weight = head.get("weight")
    if weight is not None and tuple(weight.shape) == (1, 2 * emb_dim):
        return "dual"
    return "single"


class _Passes:
    """The pass logic shared by :class:`Predictor` and the sealed
    ``export.SealedPredictor``: bucketing, packing, input order and the one
    device-to-host copy per pass, around the per-batch functions
    ``_embed_fn``, ``_predict_fn``, ``_energy_forces_fn`` and
    ``_pair_logit_fn`` (each takes ``self._prep`` and the packed tensors).
    A subclass sets ``device``, ``batch_size``, ``bucket_sizes``,
    ``spatial_sort``, ``emb_dim``, ``head_kind`` ('single', 'dual' or None)
    and ``_prep``."""

    def _maybe_sort(self, store: MolStore) -> MolStore:
        if self.spatial_sort == "off" or len(store) == 0:
            return store
        if self.spatial_sort == "auto" and int(store.num_atoms().max()) < 128:
            return store
        from geossl_tpu_torch.data.transforms import spatial_sort_store

        return spatial_sort_store(store)

    def _packer(self, store: MolStore):
        """``pack(chunk, n, slots)``: the molecules ``chunk`` of ``store``
        padded to ``n`` atoms in ``slots`` graph slots, on the device. The
        C++ packer packs straight from the store's flat arrays (converted
        once per pass), NumPy's ``pack_batch`` under ``GEOSSL_NO_NATIVE=1``
        (the same arrays); on CUDA the batch is uploaded from pinned memory
        without waiting for the copy."""
        native = find_native_packer()
        flat = None if native is None else native.StoreArrays(store)
        cuda = torch.device(self.device).type == "cuda"

        def pack(chunk, n: int, slots: int):
            if native is None:
                batch = pack_batch([store.get(int(i)) for i in chunk], n,
                                   slots)
            else:
                batch = native_batch(native.pack_batch_from_store(
                    flat, chunk, n, slots))
            if cuda:
                return batch.pin_memory().to(self.device, non_blocking=True)
            return batch.to(self.device)
        return pack

    def _batches(self, store: MolStore):
        """Yield (indices, batch on the device), each chunk in
        :func:`batch_slots` graph slots."""
        bucket_of = assign_buckets(store.num_atoms(), self.bucket_sizes)
        pack = self._packer(store)
        for b in np.unique(bucket_of):
            for chunk in _chunks(np.nonzero(bucket_of == b)[0], self.batch_size):
                yield chunk, pack(chunk, int(b),
                                  batch_slots(len(chunk), self.batch_size))

    @torch.inference_mode()
    def _run(self, store: MolStore, fn, width: int) -> np.ndarray:
        store = self._maybe_sort(store)
        out = np.zeros((len(store), width), np.float32)
        if len(store) == 0:
            return out
        idx, results = [], []
        for chunk, batch in self._batches(store):
            idx.append(chunk)
            res = fn(self._prep, batch.atom_type, batch.positions,
                     batch.node_mask)
            results.append(res[: len(chunk)].reshape(len(chunk), width))
        # one device-to-host copy for the whole pass
        out[np.concatenate(idx)] = torch.cat(results).cpu().numpy()
        return out

    def _require_head(self, want: str = "single"):
        """Raise unless the head is of kind ``want`` ('single': predict and
        forces; 'dual': predict_pairs)."""
        if self.head_kind is None:
            raise ValueError(
                "checkpoint has no 'graph_pred_linear' head: this is a "
                "backbone-only checkpoint; use embed(), or load a fine-tune "
                "checkpoint for predict()")
        if self.head_kind != want:
            raise ValueError(
                "the checkpoint's head is LEP's dual head (graph_pred_linear "
                "[1, 2*emb]): use predict_pairs()" if self.head_kind == "dual" else
                "predict_pairs needs LEP's dual head (graph_pred_linear "
                "[1, 2*emb]); this checkpoint has a single-tower head: use "
                "predict()")

    def _check_forces(self):
        """Raise when forces cannot be served (a hook for subclasses)."""

    # -- public API ---------------------------------------------------------------

    def embed(self, store: MolStore) -> np.ndarray:
        """Pooled graph representations, [M, emb], input order."""
        return self._run(store, self._embed_fn, self.emb_dim)

    def predict(self, store: MolStore) -> np.ndarray:
        """Scalar predictions (denormalized), [M], input order."""
        self._require_head()
        return self._run(store, self._predict_fn, 1)[:, 0]

    def predict_forces(self, store: MolStore):
        """(energies [M], forces [sum_N, 3]): the denormalized prediction E
        and ``-dE/dpos`` (MD17), in the store's order and flat atom layout
        (no spatial sort). Every bucket goes through the per-block kernels,
        whose first-order backwards give the position gradient (the
        whole-stack kernels have none); no graph is kept for a second
        order."""
        self._require_head()
        self._check_forces()
        energies = np.zeros(len(store), np.float32)
        forces = np.zeros((int(store.offsets[-1]), 3), np.float32)
        if len(store) == 0:
            return energies, forces
        idx, es, fs = [], [], []
        for chunk, batch in self._batches(store):
            e, f = self._energy_forces_fn(self._prep, batch.atom_type,
                                          batch.positions, batch.node_mask)
            idx.append(chunk)
            es.append(e[:len(chunk)])
            fs.append(f[batch.node_mask])  # real atoms, molecule order
        idx = np.concatenate(idx)
        # one device-to-host copy of each; the atoms of the molecules idx
        # land at their flat offsets
        energies[idx] = torch.cat(es).cpu().numpy()
        lens = store.offsets[idx + 1] - store.offsets[idx]
        firsts = np.repeat(store.offsets[idx] - (np.cumsum(lens) - lens), lens)
        forces[firsts + np.arange(lens.sum())] = torch.cat(fs).cpu().numpy()
        return energies, forces

    @torch.inference_mode()
    def predict_pairs(self, active: MolStore, inactive: MolStore) -> np.ndarray:
        """LEP dual-tower probabilities, [M], input order: pair i is
        ``active[i]`` against ``inactive[i]``. Pairs are grouped by
        (bucket_active, bucket_inactive) and cut into chunks of
        ``batch_size``; each tower takes the route of its own bucket."""
        self._require_head("dual")
        if len(active) != len(inactive):
            raise ValueError(f"store lengths differ: {len(active)} vs "
                             f"{len(inactive)}")
        out = np.zeros(len(active), np.float32)
        if len(active) == 0:
            return out
        active, inactive = self._maybe_sort(active), self._maybe_sort(inactive)
        na = assign_buckets(active.num_atoms(), self.bucket_sizes)
        ni = assign_buckets(inactive.num_atoms(), self.bucket_sizes)
        keys = na.astype(np.int64) * (max(self.bucket_sizes) + 1) + ni
        idx, results = [], []
        pack_a, pack_i = self._packer(active), self._packer(inactive)
        for k in np.unique(keys):
            for chunk in _chunks(np.nonzero(keys == k)[0], self.batch_size):
                slots = batch_slots(len(chunk), self.batch_size)
                ba = pack_a(chunk, int(na[chunk[0]]), slots)
                bi = pack_i(chunk, int(ni[chunk[0]]), slots)
                logit = self._pair_logit_fn(
                    self._prep, ba.atom_type, ba.positions, ba.node_mask,
                    bi.atom_type, bi.positions, bi.node_mask)
                idx.append(chunk)
                results.append(torch.sigmoid(logit[:len(chunk)]))
        # one device-to-host copy for the whole pass
        out[np.concatenate(idx)] = torch.cat(results).cpu().numpy()
        return out


class Predictor(_Passes):
    """Batched prediction from a backbone state (``cfg.model_3d`` says
    which): ``{"model": backbone state_dict[, "graph_pred_linear": head
    state_dict][, "y_mean", "y_std"]}``. Without a head only :meth:`embed`
    is available; with LEP's dual head only :meth:`embed` and
    :meth:`predict_pairs`."""

    def __init__(self, cfg: ModelConfig, state: dict,
                 y_mean: Optional[float] = None, y_std: Optional[float] = None,
                 batch_size: int = 128,
                 bucket_sizes: Sequence[int] = (32, 64, 128, 256, 512),
                 spatial_sort: str = "auto", device=None,
                 num_devices: Optional[int] = None):
        if spatial_sort not in ("auto", "on", "off"):
            raise ValueError(f"spatial_sort must be auto/on/off, got "
                             f"{spatial_sort!r}")
        self.device = resolve_device(device)
        self.num_devices = num_devices or 1
        devices = self._devices(self.num_devices)
        self.device = devices[0]
        batch_size += (-batch_size) % self.num_devices
        self.cfg = cfg
        self.emb_dim = cfg.emb_dim
        self.batch_size = batch_size
        self.bucket_sizes = tuple(sorted(bucket_sizes))
        self.spatial_sort = spatial_sort
        # the stack kernels compute in f32: a bf16 model (and, for SchNet,
        # bf16 filter products) takes the per-block kernels at every
        # bucket, as the JAX package's serving routes bf16
        f32 = cfg.compute_dtype == "float32"
        if cfg.model_3d == "painn":
            self._stack_apply = painn.fused_stack_apply
            self._stack_max_n = PAINN_STACK_MAX_N
            self._stackable = f32
        else:
            self._stack_apply = schnet.fused_stack_apply
            self._stack_max_n = SCHNET_STACK_MAX_N
            # the stack kernel keeps h at one width, up to its F (above
            # it, every bucket takes the per-block kernels' column blocks)
            self._stackable = (f32 and cfg.filter_mxu == "f32"
                               and cfg.schnet.num_filters == cfg.emb_dim
                               and cfg.emb_dim <= cfconv.KERNEL_F)
        routes = [self.stack_route(n) for n in self.bucket_sizes]
        check_kernel_limits(cfg, self.device, backward=False,
                            per_block=not all(routes), stack=any(routes))
        # the initial draw is overwritten by the state
        init = torch.Generator().manual_seed(0)
        self.model = make_backbone(cfg, init)
        self.model.load_state_dict(state["model"])
        # serving trains nothing: only predict_forces' positions take a
        # gradient
        self.model.to(self.device).eval().requires_grad_(False)
        self.head_kind = head_kind(state, cfg.emb_dim)
        self.head = None
        if self.head_kind is not None:
            self.head = (DualHead(cfg.emb_dim, init)
                         if self.head_kind == "dual"
                         else make_head(cfg.model_3d, cfg.emb_dim, init))
            self.head.load_state_dict(state["graph_pred_linear"])
            self.head.to(self.device).eval().requires_grad_(False)
        self.y_mean = float(state.get("y_mean", 0.0) if y_mean is None
                            else y_mean)
        self.y_std = float(state.get("y_std", 1.0) if y_std is None
                           else y_std)
        # the kernels' [in, out] weight layouts, made once for fixed
        # weights: (per-block filter weights, whole-stack weights or None)
        with torch.no_grad():
            self._prep = (self.model.filter_weights(),
                          self.model.stacked_weights() if self._stackable
                          else None)
        # one single-device Predictor per further device; this one is the
        # first device's
        self._replicas = [self] + [
            Predictor(cfg, state, self.y_mean, self.y_std, batch_size,
                      bucket_sizes, spatial_sort, device=d)
            for d in devices[1:]]
        if self.num_devices > 1:
            for name in ("_embed_fn", "_predict_fn", "_energy_forces_fn",
                         "_pair_logit_fn"):
                setattr(self, name, self._spread(getattr(Predictor, name)))

    def _devices(self, n: int) -> list:
        """The ``n`` devices of a multi-device Predictor: ``cuda:0`` ..
        ``cuda:n-1`` on CUDA (in range of the cards, as JAX's mesh), n
        times the CPU."""
        if n == 1:
            return [self.device]
        cards = torch.cuda.device_count() if self.device.type == "cuda" \
            else None
        if n < 1 or cards is not None and n > cards:
            raise ValueError(f"--num_devices {n} out of range: this process "
                             f"sees {cards} device(s)")
        if cards is not None:
            return [torch.device("cuda", k) for k in range(n)]
        return [self.device] * n

    def _spread(self, fn):
        """Per-batch function ``fn`` over the replicas: each takes its
        share of the batch's rows (the first rows the first device's), and
        the results come back in row order on the first device."""
        def spread(prep, *tensors):
            outs = []
            for rep, *part in zip(self._replicas, *(
                    torch.tensor_split(t, len(self._replicas))
                    for t in tensors)):
                if part[0].shape[0]:
                    outs.append(fn(rep, rep._prep, *(
                        t.to(rep.device, non_blocking=True) for t in part)))
            if isinstance(outs[0], tuple):
                return tuple(torch.cat([o[k].to(self.device) for o in outs])
                             for k in range(len(outs[0])))
            return torch.cat([o.to(self.device) for o in outs])
        return spread

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[ModelConfig] = None,
                        **kw) -> "Predictor":
        """Load a torch ``.pth``/``.pt`` or a JAX ``.ckpt`` of
        ``cfg.model_3d``'s backbone."""
        from geossl_tpu_torch.utils.torch_import import load_model_state

        cfg = cfg or ModelConfig()
        return cls(cfg, load_model_state(path, cfg), **kw)

    def stack_route(self, n: int) -> bool:
        """True when a batch padded to ``n`` atoms goes through the
        whole-stack kernel (the backbone's ``*_STACK_MAX_N``; SchNet's
        stack also needs F <= ``ops/cfconv.KERNEL_F``), False when
        through the per-block kernels."""
        return self._stackable and n <= self._stack_max_n

    def _graph_repr(self, prep, atom_type, positions, node_mask):
        """Pooled representation [B, F], by the route of
        :meth:`stack_route`."""
        filters, stacked = prep
        args = (atom_type, positions, node_mask)
        if self.stack_route(atom_type.shape[1]):
            graph, _ = self._stack_apply(self.model, *args, stacked=stacked)
        else:
            graph, _ = self.model(*args, filters=filters)
        return graph

    def _check_forces(self):
        check_kernel_limits(self.cfg, self.device, backward=True)

    # -- per-batch functions (export.seal exports them) ---------------------------

    def _embed_fn(self, prep, atom_type, positions, node_mask):
        return self._graph_repr(prep, atom_type, positions, node_mask)

    def _predict_fn(self, prep, atom_type, positions, node_mask):
        graph = self._graph_repr(prep, atom_type, positions, node_mask)
        return self.head(graph) * self.y_std + self.y_mean

    def _energy_forces_fn(self, prep, atom_type, positions, node_mask):
        """(E [B], forces -dE/dpos [B,N,3]) through the per-block kernels."""
        with torch.enable_grad():
            pos = positions.detach().requires_grad_(True)
            graph, _ = self.model(atom_type, pos, node_mask, filters=prep[0])
            e = self.head(graph) * self.y_std + self.y_mean
            (grad,) = torch.autograd.grad(e.sum(), pos)
        return e.detach(), -grad

    def _pair_logit_fn(self, prep, za, pa, ma, zi, pi, mi):
        return self.head(self._graph_repr(prep, za, pa, ma),
                                self._graph_repr(prep, zi, pi, mi))


# -- CLI -----------------------------------------------------------------------


def store_from_sdf(path: str) -> MolStore:
    """A multi-molecule SDF file as a MolStore (atom types, positions,
    chirality, bond_index), through the dependency-free parser
    (``data/structio.iter_sdf_blocks``, ``data/featurize.
    sdf_block_to_arrays``). An unparseable block raises with its index:
    prediction i must mean input i."""
    from geossl_tpu_torch.data.featurize import sdf_block_to_arrays
    from geossl_tpu_torch.data.structio import iter_sdf_blocks

    records = []
    for i, block in enumerate(iter_sdf_blocks(path)):
        try:
            arrays = sdf_block_to_arrays(block)[0]
        except (ValueError, IndexError) as e:
            raise ValueError(f"unparseable SDF block #{i} in {path}") from e
        records.append(MolRecord(
            atom_type=arrays["atom_type"], positions=arrays["positions"],
            chirality=arrays["chirality"], bond_index=arrays["bond_index"]))
    return MolStore.from_records(records)


def load_input_store(path: str) -> MolStore:
    """An ``.npz`` MolStore cache, or a raw ``.sdf`` file."""
    if path.endswith(".npz"):
        return MolStore.load(path)
    if path.endswith(".sdf"):
        return store_from_sdf(path)
    raise ValueError(f"unsupported input {path!r} (want .npz or .sdf)")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True,
                   help="torch .pth/.pt, JAX model[_final].ckpt, or a "
                        "sealed artifact (.sealed, export.py)")
    p.add_argument("--model_3d", default="schnet", choices=["schnet", "painn"],
                   help="the backbone of the checkpoint, at its default "
                        "configuration")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the backbone's compute dtype (the drivers' flag; "
                        "bfloat16 serves through the per-block kernels)")
    p.add_argument("--filter_mxu", default="f32", choices=["f32", "bf16"],
                   help="SchNet's CFConv filter products on bf16 operands "
                        "(the drivers' flag)")
    p.add_argument("--input", required=True, help=".npz MolStore or .sdf")
    p.add_argument("--input_inactive", default=None,
                   help="the second (inactive-conformation) store for "
                        "--mode pairs: LEP dual-tower serving")
    p.add_argument("--output", default="-", help="CSV path or - for stdout")
    p.add_argument("--mode", default="predict",
                   choices=["predict", "embed", "forces", "pairs"],
                   help="forces: one row per molecule, its index, energy "
                        "and its atoms' forces (x,y,z joined by ';'); "
                        "pairs: one probability per (active, inactive) pair")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--bucket", type=int, nargs="+",
                   default=[32, 64, 128, 256, 512])
    p.add_argument("--spatial_sort", default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions (a "
                        "sealed artifact runs on the device it was sealed "
                        "for)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="serve on this many devices from one process "
                        "(default: one device)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "pairs" and not args.input_inactive:
        # before --output is opened: open(..., "w") would truncate an
        # existing results file
        raise SystemExit("--mode pairs needs --input_inactive")
    if args.ckpt.endswith(".sealed"):
        # the programs, weights and batching knobs all come from the
        # artifact
        from geossl_tpu_torch.export import SealedPredictor

        pred = SealedPredictor.load(args.ckpt)
    else:
        pred = Predictor.from_checkpoint(
            args.ckpt, dataclasses.replace(
                ModelConfig(model_3d=args.model_3d),
                compute_dtype=args.compute_dtype, filter_mxu=args.filter_mxu),
            batch_size=args.batch_size, bucket_sizes=args.bucket,
            spatial_sort=args.spatial_sort, device=args.device,
            num_devices=args.num_devices)
    store = load_input_store(args.input)
    if args.mode == "forces":
        rows, forces = pred.predict_forces(store)
    elif args.mode == "pairs":
        rows = pred.predict_pairs(store, load_input_store(args.input_inactive))
    else:
        rows = (pred.predict if args.mode == "predict" else pred.embed)(store)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        for i, v in enumerate(rows):
            if args.mode in ("predict", "pairs"):
                out.write(f"{i},{v}\n")
            elif args.mode == "forces":
                s, t = store.offsets[i], store.offsets[i + 1]
                fx = ";".join(f"{a:.6g},{b:.6g},{c:.6g}"
                              for a, b, c in forces[s:t])
                out.write(f"{i},{v},{fx}\n")
            else:
                out.write(",".join([str(i)] + [f"{x:.6g}" for x in v]) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()


if __name__ == "__main__":
    main()
