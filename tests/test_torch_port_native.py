"""The port's C++ host runtime (``geossl_tpu_torch/native``) against the JAX
package's (``geossl_tpu/native``) on the CPU, bitwise, with the same NumPy
seeds: the padded-batch packer, the fused BFS mask and pack, the BFS
subgraph, radius edges and the SDF scanner; then every caller of the
packer on its default (native) path against the JAX package's default
path: ``BucketedLoader`` epochs without a transform and with the BFS mask,
LEP's pair loader, the serving pack. ``GEOSSL_NO_NATIVE=1`` turns the
port's packer off; a build that fails raises instead of falling back.
"""

import types

import numpy as np
import pytest
import torch

from geossl_tpu import serve as jserve
from geossl_tpu.data import bucketing as jbucket
from geossl_tpu.data import masking as jmask
from geossl_tpu.data import synthetic as jsyn
from geossl_tpu.native import packing as jpacking
from geossl_tpu_torch import serve as tserve
from geossl_tpu_torch.data import bucketing as tbucket
from geossl_tpu_torch.data import masking as tmask
from geossl_tpu_torch.data.bucketing import pack_batch
from geossl_tpu_torch.data.store import MolStore
from geossl_tpu_torch.native import packing as tpacking
from tests import test_ingestion as ING

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """Both runtimes built (the JAX package's silently falls back when it
    cannot build: these tests need it)."""
    assert jpacking.available(), "the JAX package's C++ runtime did not build"
    tpacking.load()


def _port_store(s) -> MolStore:
    return MolStore(s.atom_type, s.positions, s.offsets, s.chirality,
                    s.bond_index, s.bond_offsets, s.y)


@pytest.fixture(scope="module")
def stores():
    j = jsyn.synthetic_molecule3d(60, seed=11, max_atoms=70)
    return j, _port_store(j)


def _chunks(store, ladder, size=8):
    bucket_of = jbucket.assign_buckets(store.num_atoms(), ladder)
    for b in ladder:
        idx = np.nonzero(bucket_of == b)[0]
        for s in range(0, len(idx), size):
            yield b, idx[s:s + size]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_pack_batch_from_store_matches_jax_and_numpy(stores):
    js, ts = stores
    flat = tpacking.StoreArrays(ts)
    for b, idx in _chunks(js, (32, 64, 128)):
        want = jpacking.pack_batch_from_store(js, idx, b, 8)
        _assert_same(tpacking.pack_batch_from_store(ts, idx, b, 8), want)
        _assert_same(tpacking.pack_batch_from_store(flat, idx, b, 8), want)
        plain = pack_batch([ts.get(int(i)) for i in idx], b, 8)
        np.testing.assert_array_equal(plain.positions.numpy(), want[1])
        np.testing.assert_array_equal(plain.node_mask.numpy(), want[2])
        np.testing.assert_array_equal(plain.y.numpy(), want[4])


def test_pack_refuses_what_the_c_side_would_overrun(stores):
    _, ts = stores
    big = int(np.argmax(ts.num_atoms()))
    with pytest.raises(ValueError, match="exceeds the n_max"):
        tpacking.pack_batch_from_store(ts, np.array([big]), 32, 4)
    with pytest.raises(ValueError, match="batch_size"):
        tpacking.pack_batch_from_store(ts, np.arange(5), 128, 4)
    with pytest.raises(ValueError, match="index outside"):
        tpacking.pack_batch_from_store(ts, np.array([len(ts)]), 128, 4)


@pytest.mark.parametrize("ratio", [0.3, 0.6])
def test_fused_bfs_pack_matches_jax(stores, ratio):
    js, ts = stores
    flat = tpacking.StoreArrays(ts, bonds=True)
    for k, (b, idx) in enumerate(_chunks(js, (32, 64, 128))):
        want = jpacking.pack_batch_bfs_from_store(
            js, idx, b, 8, ratio, np.random.default_rng(k))
        got = tpacking.pack_batch_bfs_from_store(
            flat, idx, b, 8, ratio, np.random.default_rng(k))
        _assert_same(got, want)


def test_bfs_subgraph_and_radius_edges_match_jax(stores):
    js, _ = stores
    for i in range(len(js)):
        rec = js.get(i)
        for ratio in (0.3, 0.6):
            np.testing.assert_array_equal(
                tpacking.bfs_subgraph_indices(np.random.default_rng(i),
                                              rec.num_atoms, rec.bond_index,
                                              ratio),
                jpacking.bfs_subgraph_indices(np.random.default_rng(i),
                                              rec.num_atoms, rec.bond_index,
                                              ratio))
        for r in (1.5, 5.0):
            np.testing.assert_array_equal(
                tpacking.radius_edges(rec.positions, r),
                jpacking.radius_edges(rec.positions, r))
    # no bonds: restarts only
    np.testing.assert_array_equal(
        tpacking.bfs_subgraph_indices(np.random.default_rng(1), 9, None, 0.5),
        jpacking.bfs_subgraph_indices(np.random.default_rng(1), 9, None, 0.5))


def test_apply_bfs_mask_takes_the_native_bfs(stores, monkeypatch):
    """The per-record mask draws through the C++ BFS as the JAX package's
    default path does, and through the NumPy BFS (the JAX package's NumPy
    path) under GEOSSL_NO_NATIVE."""
    js, ts = stores
    for native in (True, False):
        if not native:
            monkeypatch.setenv("GEOSSL_NO_NATIVE", "1")
            monkeypatch.setattr(jpacking, "available", lambda: False)
        for i in range(0, len(js), 7):
            want = jmask.apply_bfs_mask(js.get(i), np.random.default_rng(i),
                                        0.3)
            got = tmask.apply_bfs_mask(ts.get(i), np.random.default_rng(i),
                                       0.3)
            for name in ("atom_type", "positions", "bond_index"):
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(want, name))
    assert tmask.make_bfs_transform(0.3).bfs_mask_ratio == 0.3


def _sdf_blocks():
    mols = [
        (["C", "H", "H", "O"], [(0, 0, 0), (1.09, 0, 0), (-0.3, 1.02, 0),
                                (0.1, -0.2, 1.3)], [(0, 1, 1), (0, 2, 1),
                                                    (0, 3, 2)]),
        (["N", "Cl", "Br"], [(0, 0, 0), (1.7, 0, 0), (-1.9, 0.1, 0)],
         [(0, 1, 1), (0, 2, 1)]),
        (["C", "F"], [(0, 0, 0), (1.35, 0, 0)], [(0, 5, 1)]),  # bad bond
        (["S", "P", "C"], [(0, 0, -1.5), (2.1, 0.3, 0), (0.4, -1.4, 0.2)],
         [(0, 1, 4), (1, 2, 2)]),
    ]
    blocks = [ING.make_mol_block(e, c, b, name=f"m{i}")
              for i, (e, c, b) in enumerate(mols)]
    v3000 = "\n".join(["v3", "", "", "  0  0  0  0  0  0  0  0  0  0999 V3000",
                       "M  V30 BEGIN CTAB", "M  V30 COUNTS 1 0 0 0 0",
                       "M  END"])
    return blocks[:2] + [v3000] + blocks[2:]


def test_scan_sdf_file_matches_jax(tmp_path):
    path = tmp_path / "x.sdf"
    path.write_text("".join(b + "\n$$$$\n" for b in _sdf_blocks()) + "\n")
    got, want = (m.scan_sdf_file(str(path)) for m in (tpacking, jpacking))
    _assert_same(got, want)
    assert got[0].tolist() == [True, True, False, False, True]


@pytest.mark.parametrize("bfs", [None, 0.3], ids=["plain", "bfs0.3"])
def test_bucketed_loader_matches_jax_default_path(stores, bfs):
    """Epochs batch for batch against the JAX loader's default path (its
    C++ packer; with the BFS mask, its fused BFS pack)."""
    js, ts = stores
    jl = jbucket.BucketedLoader(js, 8, (32, 64, 128), shuffle=True, seed=5,
                                transform=None if bfs is None
                                else jmask.make_bfs_transform(bfs))
    tl = tbucket.BucketedLoader(ts, 8, (32, 64, 128), seed=5,
                                transform=None if bfs is None
                                else tmask.make_bfs_transform(bfs))
    assert jl._native is not None and tl._native is not None
    for epoch in (1, 2):
        jbs, tbs = list(jl.epoch(epoch)), list(tl.epoch(epoch))
        assert len(jbs) == len(tbs) == len(tl)
        for jb, tb in zip(jbs, tbs):
            assert tb.atom_type.dtype == torch.int64
            for name in ("atom_type", "positions", "node_mask", "graph_mask",
                         "y"):
                np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                              np.asarray(getattr(jb, name)))


def test_loader_packs_in_numpy_when_told_or_with_forces(stores, monkeypatch):
    """GEOSSL_NO_NATIVE and with_forces take the record path (MD17 packs its
    forces in NumPy, as the JAX loader does); a rotation transform too."""
    _, ts = stores
    assert tbucket.BucketedLoader(ts, 8, (128,), with_forces=True)._native \
        is None
    assert tbucket.BucketedLoader(
        ts, 8, (128,), transform=lambda r, rng: r)._native is None
    monkeypatch.setenv("GEOSSL_NO_NATIVE", "1")
    assert tbucket.BucketedLoader(ts, 8, (128,))._native is None
    assert tbucket.find_native_packer() is None


def test_dual_loader_matches_jax_lep_native_pairs():
    from geossl_tpu.train import finetune_lep as jlep
    from geossl_tpu_torch.train import finetune_lep as tlep

    act, inact, labels = jsyn.synthetic_lep(13, max_atoms=70)
    jl = jlep.DualLoader(act, inact, labels, 4, (32, 64, 128), shuffle=True,
                         seed=3)
    tl = tlep.DualLoader(_port_store(act), _port_store(inact), labels, 4,
                         (32, 64, 128), shuffle=True, seed=3)
    assert jl._native is not None and tl._native is not None
    for jb, tb in zip(jl.epoch(1), tl.epoch(1)):
        np.testing.assert_array_equal(tb.y.numpy(), np.asarray(jb.y))
        for tower in ("active", "inactive"):
            for name in ("atom_type", "positions", "node_mask", "graph_mask"):
                np.testing.assert_array_equal(
                    getattr(getattr(tb, tower), name).numpy(),
                    np.asarray(getattr(getattr(jb, tower), name)))


def test_serving_pack_matches_jax(stores, monkeypatch):
    """``_Passes._packer`` (shared by the Predictor and the sealed
    predictor) against the JAX Predictor's native ``_pack``, and against
    the NumPy pack under GEOSSL_NO_NATIVE."""
    js, ts = stores
    jself = types.SimpleNamespace(_native=jpacking, batch_size=8)
    tself = types.SimpleNamespace(device="cpu")
    pack = tserve._Passes._packer(tself, ts)
    monkeypatch.setenv("GEOSSL_NO_NATIVE", "1")
    plain = tserve._Passes._packer(tself, ts)
    for b, idx in _chunks(js, (32, 64, 128)):
        want = jserve.Predictor._pack(jself, js, idx, b)
        for got in (pack(idx, b, 8), plain(idx, b, 8)):
            for name in ("atom_type", "positions", "node_mask", "graph_mask"):
                np.testing.assert_array_equal(getattr(got, name).numpy(),
                                              np.asarray(getattr(want, name)))


def test_failed_build_raises(tmp_path, monkeypatch, stores):
    """A compiler that fails raises with its output, at the first use; no
    caller falls back to NumPy."""
    _, ts = stores
    with pytest.raises(RuntimeError, match="did not build"):
        tpacking.build(str(tmp_path / "b1"), cxx="false")
    monkeypatch.setattr(tpacking, "_lib", None)
    monkeypatch.setattr(tpacking, "BUILD_DIR", str(tmp_path / "b2"))
    monkeypatch.setattr(tpacking, "CXX", "false")
    with pytest.raises(RuntimeError, match="did not build"):
        tbucket.BucketedLoader(ts, 8, (128,))
    with pytest.raises(RuntimeError, match="did not build"):
        tmask.apply_bfs_mask(ts.get(0), np.random.default_rng(0), 0.3)


def test_build_is_cached_by_a_hash_of_source_and_flags(tmp_path):
    path = tpacking.build(str(tmp_path))
    assert path == tpacking.lib_path(str(tmp_path))
    assert tpacking.build(str(tmp_path)) == path  # no second compile
    assert [p.name for p in tmp_path.iterdir()] == [path.split("/")[-1]]
