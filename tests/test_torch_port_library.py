"""The library functions of the JAX package that no driver calls, against
their counterparts in the port on numpy-seeded inputs: the config classes
and presets, the scaffold splits (``generate_scaffold`` stubbed alike in
both packages: neither machine has RDKit), the sequence-identity split and
its k-mer neighbours, the concordance index and the OC20-style metrics,
and ``bucket_chunks`` with and without ``drop_last``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from geossl_tpu import config as jconfig
from geossl_tpu.data import bucketing as jbucket
from geossl_tpu.data import splitters as jsplit
from geossl_tpu.utils import metrics as jmetrics
from geossl_tpu_torch import config as tconfig
from geossl_tpu_torch.data import bucketing as tbucket
from geossl_tpu_torch.data import splitters as tsplit
from geossl_tpu_torch.utils import metrics as tmetrics

# Six test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

PRESETS = ("preset_pretrain_ddm", "preset_finetune_qm9",
           "preset_finetune_md17", "preset_finetune_lba",
           "preset_finetune_lep")


def _comparable(cfg):
    """Two JAX model fields have no counterpart in the port:
    ``ModelConfig.use_pallas`` (the tensors' device picks kernel or plain
    version) and ``PaiNNConfig.n_out``, which no JAX module reads."""
    d = dataclasses.asdict(cfg)
    d["model"].pop("use_pallas", None)
    d["model"]["painn"].pop("n_out", None)
    return d


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("model_3d", ["schnet", "painn"])
def test_presets_equal_jax(name, model_3d):
    want = getattr(jconfig, name)(model_3d)
    got = getattr(tconfig, name)(model_3d)
    assert _comparable(got) == _comparable(want)
    assert "use_pallas" in dataclasses.asdict(want)["model"]


def test_config_classes_and_replace_equal_jax():
    for cls in ("GeoSSLConfig", "SSLHeadConfig", "DataConfig", "TrainConfig"):
        assert dataclasses.asdict(getattr(tconfig, cls)()) == \
            dataclasses.asdict(getattr(jconfig, cls)()), cls
    got = tconfig.Config().replace(output_model_dir="out")
    want = jconfig.Config().replace(output_model_dir="out")
    assert _comparable(got) == _comparable(want)
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.output_model_dir = "x"


def _smiles(seed, n=200, scaffolds=23):
    """SMILES stand-ins whose 'scaffold' is their prefix: groups of uneven
    sizes, so that ties, the cut-offs and the permutation all matter."""
    rng = np.random.default_rng(seed)
    weights = rng.pareto(1.2, scaffolds) + 0.05
    groups = rng.choice(scaffolds, n, p=weights / weights.sum())
    return [f"S{g}|mol{i}" for i, g in enumerate(groups)]


@pytest.fixture
def stub_scaffold(monkeypatch):
    def scaffold(smiles, include_chirality=True):
        return smiles.split("|")[0]

    monkeypatch.setattr(jsplit, "generate_scaffold", scaffold)
    monkeypatch.setattr(tsplit, "generate_scaffold", scaffold)


def _same_split(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fracs", [(0.8, 0.1, 0.1), (0.6, 0.2, 0.2)])
def test_scaffold_splits_equal_jax(stub_scaffold, seed, fracs):
    smiles = _smiles(seed)
    _same_split(tsplit.scaffold_split(smiles, *fracs),
                jsplit.scaffold_split(smiles, *fracs))
    _same_split(tsplit.random_scaffold_split(smiles, *fracs, seed=seed),
                jsplit.random_scaffold_split(smiles, *fracs, seed=seed))


def test_generate_scaffold_needs_rdkit_in_both():
    """Neither package imports RDKit before a scaffold is made."""
    try:
        import rdkit  # noqa: F401
    except ImportError:
        for mod in (jsplit, tsplit):
            with pytest.raises(ImportError):
                mod.generate_scaffold("c1ccccc1")
    else:
        assert tsplit.generate_scaffold("c1ccccc1CC") == \
            jsplit.generate_scaffold("c1ccccc1CC")


def _sequences(seed, n=60):
    """Chains drawn from a few families (mutated copies of a root), some
    complexes with two chains, one empty chain list."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    roots = ["".join(rng.choice(letters, rng.integers(8, 40)))
             for _ in range(9)]

    def mutate(s):
        s = list(s)
        for j in rng.choice(len(s), max(1, len(s) // 6), replace=False):
            s[j] = rng.choice(letters)
        return "".join(s)

    out = []
    for i in range(n):
        chains = [mutate(roots[rng.integers(9)])
                  for _ in range(rng.integers(1, 3))]
        out.append(chains if i != 7 else [])
    out[11] = ["ACD"]  # shorter than k: its one "k-mer" is itself
    return out


@pytest.mark.parametrize("cutoff", [0.0, 0.3, 0.6])
def test_kmer_identity_neighbors_equal_jax(cutoff):
    seqs = _sequences(4)
    t = tsplit.kmer_identity_neighbors(seqs, cutoff, k=4)
    j = jsplit.kmer_identity_neighbors(seqs, cutoff, k=4)
    for i in range(len(seqs)):
        assert t(i) == j(i), i


@pytest.mark.parametrize("seed", [0, 5])
def test_identity_split_equals_jax(seed):
    seqs = _sequences(seed)
    find = jsplit.kmer_identity_neighbors(seqs, 0.4, k=4)
    for val, test, fam in ((0.1, 0.1, 5), (0.2, 0.15, 2)):
        _same_split(tsplit.identity_split(len(seqs), find, val, test, fam,
                                          seed=seed),
                    jsplit.identity_split(len(seqs), find, val, test, fam,
                                          seed=seed))


def test_metrics_equal_jax():
    rng = np.random.default_rng(9)
    y = rng.normal(size=50)
    f = y + rng.normal(scale=0.5, size=50)
    f[:5] = f[5]  # ties in f
    y[10:14] = y[14]  # ties in y
    assert tmetrics.concordance_index(y, f) == jmetrics.concordance_index(y, f)
    assert np.isnan(tmetrics.concordance_index(np.ones(4), f[:4]))
    pred_f, true_f = rng.normal(size=(6, 9, 3)), rng.normal(size=(6, 9, 3))
    pred_f[0, 0] = 0.0  # a zero force: the norm's eps clamp
    free = (rng.random((6, 9)) < 0.7).astype(np.float32)
    free[:, 0] = 1.0
    assert tmetrics.force_cosine(pred_f, true_f, free) == \
        jmetrics.force_cosine(pred_f, true_f, free)
    e, pe = rng.normal(size=6), rng.normal(size=6)
    pe[:3] = e[:3] + 0.01
    for eps in (0.02, 0.5):
        assert tmetrics.energy_within_threshold(pe, e, eps) == \
            jmetrics.energy_within_threshold(pe, e, eps)
    near_f = true_f + rng.normal(scale=0.004, size=true_f.shape)
    for forces in (near_f, np.abs(near_f - true_f).sum(-1)):
        want_f = true_f if forces.ndim == 3 else np.zeros(forces.shape)
        for eps, alpha in ((0.02, 0.03), (0.5, 0.01), (2.0, 1.0)):
            got = tmetrics.energy_force_within_threshold(pe, e, forces, want_f,
                                                         eps, alpha)
            assert got == jmetrics.energy_force_within_threshold(
                pe, e, forces, want_f, eps, alpha)


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_bucket_chunks_equal_jax(drop_last, shuffle):
    bucket_of = np.random.default_rng(2).choice([32, 64, 128], 101)
    got = tbucket.bucket_chunks(bucket_of, 8, np.random.default_rng(3),
                                shuffle, drop_last=drop_last)
    want = jbucket.bucket_chunks(bucket_of, 8, np.random.default_rng(3),
                                 shuffle, drop_last=drop_last)
    assert len(got) == len(want)
    for (gb, gi), (wb, wi) in zip(got, want):
        assert gb == wb
        np.testing.assert_array_equal(gi, wi)
    sizes = [len(c) for _, c in got]
    assert (min(sizes) == 8) == drop_last
