"""ctypes bindings of the C++ host runtime (``geossl_native.cpp``; the port's
counterpart of ``geossl_tpu/native/packing.py``).

The library is built with ``g++`` and the JAX package's flags (``-O3
-march=native -shared -fPIC``: the same flags keep ``radius_edges``' float
compares identical) on first use, never at import, into the git-ignored
``native/_build/``. Its file name carries a hash of the source and the
flags; the compiler writes a temporary file that is then renamed, so
several processes may build at once. A failed build or load raises with
the compiler's output: nothing falls back quietly.

``GEOSSL_NO_NATIVE=1`` is the explicit opt-out, read on every call of
:func:`enabled`: the callers (``data/bucketing``, ``data/masking``,
``data/qm9``, serving, LEP's pair loader) then take their NumPy paths,
which stay the plain versions. ctypes releases the interpreter lock while
the library runs, so a packer on a background thread (``parallel/mesh.
prefetch``) runs beside the training loop.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "geossl_native.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX = "g++"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def enabled() -> bool:
    """False under ``GEOSSL_NO_NATIVE=1``: the callers pack in NumPy."""
    return not os.environ.get("GEOSSL_NO_NATIVE")


def lib_path(build_dir: Optional[str] = None) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir or BUILD_DIR,
                        f"libgeossl_native-{h.hexdigest()[:12]}.so")


def build(build_dir: Optional[str] = None, cxx: Optional[str] = None) -> str:
    """The library's path (in ``build_dir``, default :data:`BUILD_DIR`),
    compiled by ``cxx`` (default :data:`CXX`) first if it is missing;
    raises ``RuntimeError`` with the compiler's output if the compile
    fails."""
    build_dir, cxx = build_dir or BUILD_DIR, cxx or CXX
    path = lib_path(build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *FLAGS, SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the C++ host runtime did not build "
                           f"({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"the C++ host runtime did not build ({' '.join(cmd)}, exit "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}"
            "(GEOSSL_NO_NATIVE=1 packs in NumPy instead)")
    os.replace(tmp, path)
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32, f32, u8, u64, dbl = (
        ctypes.c_int64, ctypes.c_int32, ctypes.c_float, ctypes.c_uint8,
        ctypes.c_uint64, ctypes.c_double)
    P = ctypes.POINTER
    lib.pack_batch.argtypes = [
        P(i32), P(f32), P(i64), P(f32), i64, P(i64), i64, i64, i64,
        P(i32), P(f32), P(u8), P(u8), P(f32)]
    lib.pack_batch.restype = None
    lib.pack_batch_bfs.argtypes = [
        P(i32), P(f32), P(i64), P(i32), P(i32), P(i64), P(f32), i64,
        P(i64), i64, i64, i64, dbl, u64,
        P(i32), P(f32), P(u8), P(u8), P(f32)]
    lib.pack_batch_bfs.restype = None
    lib.bfs_subgraph.argtypes = [i64, P(i32), P(i32), i64, dbl, u64, P(i64)]
    lib.bfs_subgraph.restype = i64
    lib.radius_edges.argtypes = [P(f32), i64, dbl, P(i32), P(i32), i64]
    lib.radius_edges.restype = i64
    lib.scan_sdf_file.argtypes = [
        ctypes.c_char_p, P(i32), P(f32), i64, P(i32), P(i32), P(i32),
        i64, P(i64), P(i64), P(i64), P(u8), i64]
    lib.scan_sdf_file.restype = i64
    return lib


def load() -> ctypes.CDLL:
    """The library, built and loaded on first use; raises if either fails."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = _declare(ctypes.CDLL(path))
            except OSError as e:
                raise RuntimeError(f"the C++ host runtime at {path} did not "
                                   f"load: {e}") from e
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class StoreArrays:
    """A MolStore's flat arrays in the contiguous types the C side reads,
    converted once per store (not once per batch); ``store`` is kept for
    its offsets. ``bonds`` also converts the bond graph (the fused BFS
    pack reads it)."""

    def __init__(self, store, bonds: bool = False):
        self.offsets = np.ascontiguousarray(store.offsets, np.int64)
        self.atom_type = np.ascontiguousarray(store.atom_type, np.int32)
        self.positions = np.ascontiguousarray(store.positions, np.float32)
        self.y = None
        if store.y is not None:
            self.y = np.ascontiguousarray(
                np.asarray(store.y, np.float32).reshape(len(store), -1))
        self.bond_src = self.bond_dst = self.bond_offsets = None
        if bonds:
            if store.bond_index is None or store.bond_offsets is None:
                raise ValueError("the fused BFS pack needs the store's bonds")
            bond = np.asarray(store.bond_index)
            self.bond_src = np.ascontiguousarray(bond[0], np.int32)
            self.bond_dst = np.ascontiguousarray(bond[1], np.int32)
            self.bond_offsets = np.ascontiguousarray(store.bond_offsets,
                                                     np.int64)

    def __len__(self) -> int:
        return len(self.offsets) - 1


def _arrays(store, bonds=False) -> StoreArrays:
    if isinstance(store, StoreArrays):
        return store
    return StoreArrays(store, bonds)


def _check_bounds(flat: StoreArrays, indices: np.ndarray, n_max: int,
                  batch_size: int):
    """The C side copies n atoms into n_max-wide rows with no bound check;
    validate here, once per call, O(batch)."""
    if len(indices) > batch_size:
        raise ValueError(
            f"pack: {len(indices)} molecules > batch_size {batch_size}")
    if len(indices) and (indices.min() < 0 or indices.max() >= len(flat)):
        raise ValueError(f"pack: a molecule index outside 0..{len(flat) - 1}")
    sizes = flat.offsets[indices + 1] - flat.offsets[indices]
    if len(sizes) and int(sizes.max()) > n_max:
        raise ValueError(
            f"pack: molecule with {int(sizes.max())} atoms exceeds the "
            f"n_max={n_max} bucket (bad bucket assignment upstream)")


def _outputs(flat: StoreArrays, n_max: int, batch_size: int):
    y_dim = 0 if flat.y is None else flat.y.shape[1]
    return (np.empty((batch_size, n_max), np.int32),
            np.empty((batch_size, n_max, 3), np.float32),
            np.empty((batch_size, n_max), np.uint8),
            np.empty((batch_size,), np.uint8),
            np.empty((batch_size, y_dim), np.float32) if y_dim else None,
            y_dim)


def _y_ptrs(flat: StoreArrays, out_y):
    if out_y is None:
        null = ctypes.POINTER(ctypes.c_float)()
        return null, null
    return _ptr(flat.y, ctypes.c_float), _ptr(out_y, ctypes.c_float)


def pack_batch_from_store(store, indices: np.ndarray, n_max: int,
                          batch_size: int):
    """Pack molecules ``indices`` of ``store`` (a MolStore or its
    :class:`StoreArrays`) into ``batch_size`` slots of ``n_max`` atoms.
    Returns (atom [B,N] int32, pos [B,N,3], node_mask [B,N] bool,
    graph_mask [B] bool, y [B,T] or None): the NumPy ``pack_batch``'s
    arrays, bit for bit."""
    lib = load()
    flat = _arrays(store)
    indices = np.ascontiguousarray(indices, np.int64)
    _check_bounds(flat, indices, n_max, batch_size)
    atom, pos, node_mask, graph_mask, out_y, y_dim = _outputs(
        flat, n_max, batch_size)
    y_in, y_out = _y_ptrs(flat, out_y)
    lib.pack_batch(
        _ptr(flat.atom_type, ctypes.c_int32),
        _ptr(flat.positions, ctypes.c_float),
        _ptr(flat.offsets, ctypes.c_int64), y_in, y_dim,
        _ptr(indices, ctypes.c_int64), len(indices), batch_size, n_max,
        _ptr(atom, ctypes.c_int32), _ptr(pos, ctypes.c_float),
        _ptr(node_mask, ctypes.c_uint8), _ptr(graph_mask, ctypes.c_uint8),
        y_out)
    return atom, pos, node_mask.view(bool), graph_mask.view(bool), out_y


def pack_batch_bfs_from_store(store, indices: np.ndarray, n_max: int,
                              batch_size: int, mask_ratio: float,
                              rng: np.random.Generator):
    """Fused BFS mask and pack (GeoSSL pretraining's atom masking): each
    molecule's kept atoms, relabelled in order, packed as
    :func:`pack_batch_from_store` packs. One seed per batch is drawn from
    ``rng``, as the JAX package's native path draws it."""
    lib = load()
    flat = _arrays(store, bonds=True)
    indices = np.ascontiguousarray(indices, np.int64)
    _check_bounds(flat, indices, n_max, batch_size)
    atom, pos, node_mask, graph_mask, out_y, y_dim = _outputs(
        flat, n_max, batch_size)
    y_in, y_out = _y_ptrs(flat, out_y)
    seed = int(rng.integers(0, 2**63 - 1))
    lib.pack_batch_bfs(
        _ptr(flat.atom_type, ctypes.c_int32),
        _ptr(flat.positions, ctypes.c_float),
        _ptr(flat.offsets, ctypes.c_int64),
        _ptr(flat.bond_src, ctypes.c_int32),
        _ptr(flat.bond_dst, ctypes.c_int32),
        _ptr(flat.bond_offsets, ctypes.c_int64), y_in, y_dim,
        _ptr(indices, ctypes.c_int64), len(indices), batch_size, n_max,
        float(mask_ratio), seed,
        _ptr(atom, ctypes.c_int32), _ptr(pos, ctypes.c_float),
        _ptr(node_mask, ctypes.c_uint8), _ptr(graph_mask, ctypes.c_uint8),
        y_out)
    return atom, pos, node_mask.view(bool), graph_mask.view(bool), out_y


def bfs_subgraph_indices(rng: np.random.Generator, num_nodes: int,
                         bond_index: Optional[np.ndarray],
                         mask_ratio: float) -> np.ndarray:
    """The sorted kept-node indices of one random BFS subgraph (one seed
    drawn from ``rng``)."""
    lib = load()
    seed = int(rng.integers(0, 2**63 - 1))
    if bond_index is None or bond_index.size == 0:
        src = dst = np.zeros(0, np.int32)
    else:
        src = np.ascontiguousarray(bond_index[0], np.int32)
        dst = np.ascontiguousarray(bond_index[1], np.int32)
        if src.min() < 0 or max(src.max(), dst.max()) >= num_nodes:
            raise ValueError(f"bfs: a bond outside 0..{num_nodes - 1}")
    out = np.empty(num_nodes, np.int64)
    n = lib.bfs_subgraph(num_nodes, _ptr(src, ctypes.c_int32),
                         _ptr(dst, ctypes.c_int32), len(src),
                         float(mask_ratio), seed, _ptr(out, ctypes.c_int64))
    return out[:n]


def radius_edges(positions: np.ndarray, r: float) -> np.ndarray:
    """[N,3] -> [E,2] ordered pairs (i != j) closer than ``r``."""
    lib = load()
    pos = np.ascontiguousarray(positions, np.float32)
    n = pos.shape[0]
    cap = n * (n - 1)
    src = np.empty(cap, np.int32)
    dst = np.empty(cap, np.int32)
    cnt = lib.radius_edges(_ptr(pos, ctypes.c_float), n, float(r),
                           _ptr(src, ctypes.c_int32),
                           _ptr(dst, ctypes.c_int32), cap)
    return np.stack([src[:cnt], dst[:cnt]], axis=1).astype(np.int64)


def scan_sdf_file(path: str):
    """Scan a whole V2000 SDF file in one native call.

    Returns ``(ok [M] bool, atom_type_flat, pos_flat [sumN,3],
    atom_offsets [M+1], bond_index [2, sumE], bond_type_flat [sumE],
    bond_offsets [M+1], byte_offsets [M+1])``, each block's spans empty
    where ``ok`` is False (a V3000 or unparseable block: the caller parses
    its byte span ``byte_offsets[i]:byte_offsets[i+1]`` in Python). The
    arrays equal ``featurize.sdf_block_to_arrays``'s for the ok blocks.
    The buffer caps come from the file size and grow 4x if a file
    overflows them."""
    lib = load()
    size = os.path.getsize(path)
    # structural bounds from the file size: an atom line is >= 30 bytes and
    # a newline, a bond line >= 9 and a newline, a block >= ~40 bytes
    atom_cap = size // 30 + 64
    bond_cap = 2 * (size // 10) + 64
    max_mols = size // 40 + 64
    for _ in range(8):
        atom_type = np.empty(atom_cap, np.int32)
        pos = np.empty((atom_cap, 3), np.float32)
        bond_src = np.empty(bond_cap, np.int32)
        bond_dst = np.empty(bond_cap, np.int32)
        bond_type = np.empty(bond_cap, np.int32)
        atom_offsets = np.empty(max_mols + 1, np.int64)
        bond_offsets = np.empty(max_mols + 1, np.int64)
        byte_offsets = np.empty(max_mols + 1, np.int64)
        ok = np.empty(max_mols, np.uint8)
        n = lib.scan_sdf_file(
            path.encode(), _ptr(atom_type, ctypes.c_int32),
            _ptr(pos, ctypes.c_float), atom_cap,
            _ptr(bond_src, ctypes.c_int32), _ptr(bond_dst, ctypes.c_int32),
            _ptr(bond_type, ctypes.c_int32), bond_cap,
            _ptr(atom_offsets, ctypes.c_int64),
            _ptr(bond_offsets, ctypes.c_int64),
            _ptr(byte_offsets, ctypes.c_int64),
            _ptr(ok, ctypes.c_uint8), max_mols)
        if n != -2:
            break
        atom_cap *= 4
        bond_cap *= 4
        max_mols *= 4
    if n < 0:
        raise OSError(f"scan_sdf_file({path!r}) failed with code {n}")
    n_atoms = int(atom_offsets[n])
    n_bonds = int(bond_offsets[n])
    return (ok[:n].astype(bool), atom_type[:n_atoms].copy(),
            pos[:n_atoms].copy(), atom_offsets[:n + 1].copy(),
            np.stack([bond_src[:n_bonds], bond_dst[:n_bonds]]),
            bond_type[:n_bonds].copy(), bond_offsets[:n + 1].copy(),
            byte_offsets[:n + 1].copy())
