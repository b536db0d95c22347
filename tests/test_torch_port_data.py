"""geossl_tpu_torch host data layer against the JAX package: the same seed
gives the same arrays (store, synthetic sets, bucketing, Morton sort), and
the port imports nothing of JAX or of geossl_tpu."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from geossl_tpu.data import bucketing as jbucket
from geossl_tpu.data import synthetic as jsyn
from geossl_tpu.data import transforms as jtrans
from geossl_tpu.data.store import MolStore as JMolStore
from geossl_tpu_torch.data import bucketing as tbucket
from geossl_tpu_torch.data import synthetic as tsyn
from geossl_tpu_torch.data import transforms as ttrans
from geossl_tpu_torch.data.store import MolStore as TMolStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE_FIELDS = ("atom_type", "positions", "offsets", "chirality", "bond_index",
                "bond_offsets", "y", "forces")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "geossl_tpu")


def assert_same_store(a, b):
    for name in STORE_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)
            assert x.dtype == y.dtype, name


@pytest.mark.parametrize("make", [
    lambda m: m.synthetic_qm9(12, seed=3),
    lambda m: m.synthetic_molecule3d(10, seed=1, max_atoms=100),
    lambda m: m.synthetic_lba(3, seed=2, max_atoms=300),
], ids=["qm9", "molecule3d", "lba"])
def test_synthetic_sets_match_jax(make):
    assert_same_store(make(tsyn), make(jsyn))


def test_store_npz_round_trip_both_ways(tmp_path):
    jstore = jsyn.synthetic_qm9(6, seed=0)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jstore.save(jpath)
    tstore = TMolStore.load(jpath)
    assert_same_store(tstore, jstore)
    tstore.save(tpath)
    assert_same_store(JMolStore.load(tpath), jstore)
    rec_t, rec_j = tstore.get(4), jstore.get(4)
    np.testing.assert_array_equal(rec_t.positions, rec_j.positions)
    np.testing.assert_array_equal(rec_t.bond_index, rec_j.bond_index)
    assert rec_t.num_atoms == rec_j.num_atoms


def test_bucketing_and_pack_batch_match_jax():
    store = jsyn.synthetic_molecule3d(9, seed=4, max_atoms=60)
    sizes = store.num_atoms()
    ladder = (32, 64)
    np.testing.assert_array_equal(tbucket.assign_buckets(sizes, ladder),
                                  jbucket.assign_buckets(sizes, ladder))
    assert tbucket.pick_bucket(33, ladder) == jbucket.pick_bucket(33, ladder)
    with pytest.raises(ValueError, match="largest bucket"):
        tbucket.assign_buckets(np.array([70]), ladder)
    records = [store.get(i) for i in range(4)]
    jb = jbucket.pack_batch(records, 64, batch_size=6)
    tb = tbucket.pack_batch(records, 64, batch_size=6)
    for name in ("atom_type", "positions", "node_mask", "graph_mask", "y"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert tb.batch_size == 6 and tb.max_atoms == 64
    np.testing.assert_array_equal(tb.num_atoms().numpy(),
                                  [r.num_atoms for r in records] + [0, 0])


def test_morton_sort_matches_jax():
    store = jsyn.synthetic_lba(3, seed=5, max_atoms=200)
    for i in range(len(store)):
        pos = store.get(i).positions
        np.testing.assert_array_equal(ttrans.morton_order(pos),
                                      jtrans.morton_order(pos))
    assert_same_store(ttrans.spatial_sort_store(store),
                      jtrans.spatial_sort_store(store))


def _forbidden(module: str) -> bool:
    """Exact match on the package name: geossl_tpu_torch is not geossl_tpu."""
    return module.split(".")[0] in FORBIDDEN


def test_port_import_leaves_jax_out():
    code = ("import sys, geossl_tpu_torch.serve, geossl_tpu_torch.ops.cfconv; "
            "print(' '.join(sorted(sys.modules)))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "geossl_tpu_torch.serve" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_port_sources_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "geossl_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{path}:{node.lineno} {m}" for m in mods if _forbidden(m)]
    assert bad == []
    assert not _forbidden("geossl_tpu_torch.ops") and _forbidden("geossl_tpu.ops")
