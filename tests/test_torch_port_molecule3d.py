"""The port's Molecule3D build and its data command against the JAX
package's: the synthetic raw writer byte for byte; the corpus built from
raw shards (the C++ scanner with its rescue of rejected blocks, and the
per-block parser) bitwise against both JAX builds, in full and at a limit
that ends mid-shard; ``process_molecule3d``'s head subsets; the pandas-free
``properties.csv`` reader; caches read across packages; and
``python -m geossl_tpu_torch data`` for every dataset on the raw fixtures
the port's tests write, each cache against the JAX command's."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from geossl_tpu.data import __main__ as jdata_cli
from geossl_tpu.data import lep as jlep
from geossl_tpu.data import molecule3d as jm3d
from geossl_tpu.data import synthetic as jsyn
from geossl_tpu.data.store import MolStore as JMolStore
from geossl_tpu_torch import __main__ as front
from geossl_tpu_torch.data import lep as tlep
from geossl_tpu_torch.data import molecule3d as tm3d
from geossl_tpu_torch.data import synthetic as tsyn
from geossl_tpu_torch.data.store import MolStore
from tests import test_ingestion as ING
from tests import test_torch_port_md17 as MD17
from tests import test_torch_port_qm9 as QM9
from tests.test_torch_port_data import assert_same_store

# Six test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

ARRAYS = ("atom_type", "positions", "offsets", "chirality", "bond_index",
          "bond_offsets", "y")
RAW = dict(num_molecules=400, seed=5, max_atoms=40, bad_every=17)
# a V3000 block: the C++ scanner rejects it, sdf_block_to_arrays reads it
V3000 = """rescued
  synthetic

  0  0  0     0  0            999 V3000
M  V30 BEGIN CTAB
M  V30 COUNTS 3 0 0 0 0
M  V30 BEGIN ATOM
M  V30 1 C 0.1 0.0 0.0 0
M  V30 2 O 1.2 0.0 0.3 0
M  V30 3 Cl 0.0 1.3 0.0 0
M  V30 END ATOM
M  V30 END CTAB
M  END
$$$$
"""
# the rescued block opens the second shard; an empty field in one row
RESCUE_SHARD, EMPTY_ROW = 1, 7


def assert_bitwise(got, want):
    for name in ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype.kind == "f":  # NaN == NaN bit for bit
            g, w = g.view(f"u{g.itemsize}"), w.view(f"u{w.itemsize}")
        np.testing.assert_array_equal(g, w, err_msg=name)


def write_tree(root):
    """The synthetic raw tree, with the V3000 block at the head of the
    second shard (its properties row inserted at its global index) and an
    empty field in one properties row."""
    tsyn.write_synthetic_molecule3d_raw(root, **RAW)
    raw = os.path.join(root, "raw")
    first = os.path.join(raw, tm3d.SDF_SHARDS[RESCUE_SHARD])
    with open(first) as f:
        text = f.read()
    with open(first, "w") as f:
        f.write(V3000 + text)
    with open(os.path.join(raw, "properties.csv")) as f:
        rows = f.read().splitlines()
    at = 1 + RAW["num_molecules"] // 4 * RESCUE_SHARD  # header, shard 0
    rows.insert(at, ",".join(["9999"] + ["0.5"] * 8))
    fields = rows[1 + EMPTY_ROW].split(",")
    fields[3] = ""
    rows[1 + EMPTY_ROW] = ",".join(fields)
    with open(os.path.join(raw, "properties.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("m3d"))
    write_tree(root)
    return root


def test_raw_writer_matches_jax_byte_for_byte(tmp_path):
    for name, write in (("jax", jsyn.write_synthetic_molecule3d_raw),
                        ("port", tsyn.write_synthetic_molecule3d_raw)):
        write(str(tmp_path / name), **RAW)
    names = sorted(os.listdir(tmp_path / "jax" / "raw"))
    assert names == sorted(tm3d.SDF_SHARDS + ["properties.csv"])
    for n in names:
        assert (tmp_path / "port" / "raw" / n).read_bytes() == \
            (tmp_path / "jax" / "raw" / n).read_bytes(), n
    assert tm3d.SDF_SHARDS == jm3d.SDF_SHARDS


@pytest.mark.parametrize("limit", [None, 150])
def test_builds_match_jax_bitwise(tree, monkeypatch, limit):
    """Native (with the rescue), per-block, and both JAX builds."""
    raw = os.path.join(tree, "raw")
    props = pd.read_csv(os.path.join(raw, "properties.csv")).to_numpy(
        dtype=np.float32)[:, 1:]
    native = tm3d.build_molecule3d(tree, limit=limit)
    jax_native = jm3d._build_molecule3d_native(raw, props, limit)
    jax_build = jm3d.build_molecule3d(tree, limit=limit)
    monkeypatch.setenv("GEOSSL_NO_NATIVE", "1")
    per_block = tm3d.build_molecule3d(tree, limit=limit)
    for other in (jax_native, jax_build, per_block):
        assert_bitwise(native, other)
    n_blocks = RAW["num_molecules"] + 1
    n_bad = RAW["num_molecules"] // RAW["bad_every"]
    assert len(native) == (limit or n_blocks - n_bad)
    assert np.isnan(native.y).sum() == 1
    # the rescued V3000 block: three atoms (C, O, Cl), no bonds, its row
    k = RAW["num_molecules"] // 4 * RESCUE_SHARD
    k -= sum(1 for i in range(k) if i % RAW["bad_every"] == RAW["bad_every"] - 1)
    rec = native.get(k)
    np.testing.assert_array_equal(rec.atom_type, [1, 3, 7])
    assert rec.bond_index.shape == (2, 0)
    np.testing.assert_array_equal(rec.y, np.full(8, 0.5, np.float32))


def test_properties_reader_reads_empty_fields_as_pandas(tmp_path):
    path = tmp_path / "properties.csv"
    path.write_text("cid,a,b,c\n0,1.5,,2.25\n1,,3.0,-1e-3\n2,0.1,0.2,0.3\n")
    want = pd.read_csv(path).to_numpy(dtype=np.float32)[:, 1:]
    got = tm3d.read_properties(str(path))
    assert got.dtype == np.float32 and np.isnan(got).sum() == 2
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    path.write_text("cid,a\n0,0.1234567\n")  # one row stays two-dimensional
    np.testing.assert_array_equal(tm3d.read_properties(str(path)),
                                  pd.read_csv(path).to_numpy(np.float32)[:, 1:])


@pytest.mark.parametrize("native", [True, False])
def test_missing_shard_raises(tmp_path, monkeypatch, native):
    tsyn.write_synthetic_molecule3d_raw(str(tmp_path), 40, seed=1)
    os.remove(os.path.join(tmp_path, "raw", tm3d.SDF_SHARDS[2]))
    if not native:
        monkeypatch.setenv("GEOSSL_NO_NATIVE", "1")
    with pytest.raises(FileNotFoundError, match="missing"):
        tm3d.build_molecule3d(str(tmp_path))
    # a limit reached before the missing shard does not need it
    assert len(tm3d.build_molecule3d(str(tmp_path), limit=5)) == 5


def test_process_subsets_idempotent_and_cross_package(tmp_path):
    root = str(tmp_path / "port")
    tsyn.write_synthetic_molecule3d_raw(root, 60, seed=2, bad_every=7)
    full = tm3d.process_molecule3d(root, subsets=(3, 5))
    proc = os.path.join(root, "processed")
    names = sorted(os.listdir(proc))
    assert names == ["molecule3d_3_store.npz", "molecule3d_5_store.npz",
                     "molecule3d_store.npz"]
    stamps = {n: os.stat(os.path.join(proc, n)).st_mtime_ns for n in names}
    blobs = {n: open(os.path.join(proc, n), "rb").read() for n in names}
    again = tm3d.process_molecule3d(root, subsets=(3, 5))
    assert_bitwise(again, full)
    assert {n: os.stat(os.path.join(proc, n)).st_mtime_ns
            for n in names} == stamps
    for k in (3, 5):
        head = MolStore.load(os.path.join(proc, f"molecule3d_{k}_store.npz"))
        assert_bitwise(head, tm3d.build_molecule3d(root, limit=k))
        # the JAX package reads the port's cache, and loads it as its own
        assert_same_store(JMolStore.load(os.path.join(
            proc, f"molecule3d_{k}_store.npz")), head)
        assert_same_store(jm3d.load_molecule3d(root, subset=k), head)
    with pytest.raises(ValueError, match="exceeds the corpus"):
        tm3d.process_molecule3d(root, subsets=(len(full) + 1,))
    # the port reads a cache the JAX package built, byte for byte the same
    jroot = str(tmp_path / "jax")
    jsyn.write_synthetic_molecule3d_raw(jroot, 60, seed=2, bad_every=7)
    jm3d.process_molecule3d(jroot, subsets=(3, 5))
    for n in names:
        assert open(os.path.join(jroot, "processed", n), "rb").read() == \
            blobs[n], n
    assert_bitwise(tm3d.load_molecule3d(jroot, subset=None), full)


def test_load_builds_on_a_cache_miss(tmp_path):
    root = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="raw files"):
        tm3d.load_molecule3d(root, subset=4)
    tsyn.write_synthetic_molecule3d_raw(root, 24, seed=3)
    got = tm3d.load_molecule3d(root, subset=4)
    assert len(got) == 4
    assert os.path.exists(os.path.join(root, "processed",
                                       "molecule3d_4_store.npz"))
    assert_bitwise(tm3d.load_molecule3d(root, subset=4), got)


def _lep_items():
    """LEP items with hydrogens in both parts (``--lep_droph`` drops them)."""
    items = []
    for s, lab in enumerate("AIAIA"):
        item = ING.make_lep_item(label=lab, n_prot=20, n_lig=5, seed=s)
        for key in ("atoms_active", "atoms_inactive"):
            el = item[key]["element"]
            for i in range(0, len(el), 3):
                el[i] = "H"
        items.append(item)
    return items


def _write_fixture(dataset, root):
    if dataset == "molecule3d":
        tsyn.write_synthetic_molecule3d_raw(root, 48, seed=4, bad_every=9)
    elif dataset == "qm9":
        QM9._write_raw(root)
    elif dataset == "md17":
        MD17._write_raw(root, "md17_aspirin.npz")
    elif dataset == "lba":
        ING.write_lba_raw(root, pdb_ids=("3def", "1abc", "2xyz"),
                          labels=(5.0, 4.5, 7.25))
    else:  # the LMDB reader is stubbed: the lmdb package is optional
        for split in ("train", "val", "test"):
            os.makedirs(os.path.join(root, "raw", "split-by-protein", "data",
                                     split))


CLI_CASES = [("molecule3d", ["--subset", "20"]), ("molecule3d", []),
             ("qm9", []), ("md17", ["--task", "aspirin"]), ("lba", []),
             ("lep", ["--lep_split", "val"]), ("lep", ["--lep_droph"])]


@pytest.mark.parametrize("dataset,extra", CLI_CASES)
def test_data_command_writes_the_jax_caches(tmp_path, monkeypatch, capsys,
                                            dataset, extra):
    items = _lep_items()
    for mod in (tlep, jlep):
        monkeypatch.setattr(mod, "read_lmdb_items", lambda folder: iter(items))
    roots = {}
    for name in ("jax", "port"):
        roots[name] = str(tmp_path / name)
        _write_fixture(dataset, roots[name])
    argv = [dataset, *extra]
    jdata_cli.main(argv + ["--root", roots["jax"]])
    want_out = capsys.readouterr().out.splitlines()
    assert front.main(["data", *argv, "--root", roots["port"]]) == 0
    # the command's own lines (a loader's warnings before them may differ)
    got_out = capsys.readouterr().out.splitlines()
    n_lines = 3 if dataset == "lep" and "--lep_split" not in extra else 1
    assert got_out[-n_lines:] == want_out[-n_lines:]
    proc = {n: os.path.join(r, "processed") for n, r in roots.items()}
    names = sorted(os.listdir(proc["jax"]))
    assert names and sorted(os.listdir(proc["port"])) == names
    for n in names:
        a, b = (os.path.join(proc[k], n) for k in ("port", "jax"))
        if n.endswith(".npz"):
            assert_same_store(MolStore.load(a), JMolStore.load(b))
        elif n.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), n
    if "--lep_droph" in extra:  # the hydrogens are gone
        store = MolStore.load(os.path.join(proc["port"], "lep_train_active.npz"))
        kept = tlep.item_to_records(items[0])[0].num_atoms
        assert len(store.atom_type) < kept * len(items)
