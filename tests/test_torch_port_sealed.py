"""Sealed serving artifacts of geossl_tpu_torch (``export.py``) on the CPU:
a CPU artifact against the live Predictor in all four modes, with the
plain versions in its programs (SchNet) and with the kernels' custom ops
(PaiNN, sealed through the kernel route), and the artifact's refusals.

Tolerance: a sealed CPU artifact against the live Predictor within rtol
1e-6 and atol 1e-6 times the output's largest magnitude (the programs are
traced with opt_einsum's path search off: the plain versions' einsums
contract in another order).
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from geossl_tpu_torch import export, serve
from geossl_tpu_torch.config import ModelConfig, PaiNNConfig, SchNetConfig
from geossl_tpu_torch.models.painn import PaiNN
from geossl_tpu_torch.models.schnet import SchNet
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.ops import painn as tpn
from geossl_tpu_torch.serve import Predictor
from geossl_tpu_torch.train.common import DualHead, make_backbone, make_head
from tests.test_torch_port_serve import _store

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)


def _seal_case(model_3d, tmp_path, via_ops):
    """(live single-head Predictor, its artifact, live LEP Predictor, its
    artifact) of one backbone at buckets (32, 64), batch 16, one block.
    With ``via_ops`` every kernel wrapper takes its kernel route while
    sealing (``on_cpu`` False), so the programs hold the custom ops, whose
    CPU implementations run them."""
    if model_3d == "painn":
        cfg = ModelConfig(model_3d="painn", emb_dim=16, painn=PaiNNConfig(
            n_atom_basis=16, n_interactions=1, n_rbf=8))
    else:
        cfg = ModelConfig(emb_dim=16, schnet=SchNetConfig(
            num_filters=16, num_interactions=1, num_gaussians=8))
    gen = torch.Generator().manual_seed(3)
    backbone = make_backbone(cfg, gen).state_dict()
    kw = dict(batch_size=16, bucket_sizes=(32, 64), device="cpu")
    live = Predictor(cfg, {"model": backbone, "graph_pred_linear": make_head(
        model_3d, 16, gen).state_dict(), "y_mean": 0.5, "y_std": 2.0}, **kw)
    lep = Predictor(cfg, {"model": backbone, "graph_pred_linear": DualHead(
        16, gen).state_dict()}, **kw)
    paths = str(tmp_path / "m.sealed"), str(tmp_path / "lep.sealed")
    with pytest.MonkeyPatch.context() as m:
        if via_ops:
            for mod in (tcf, tpn):
                m.setattr(mod, "on_cpu", lambda *a: False)
        export.seal(live, paths[0], modes=("predict", "embed", "forces"))
        export.seal(lep, paths[1], modes=("pairs",), pair_buckets=(64,))
    return live, paths[0], lep, paths[1]


@pytest.fixture(scope="module")
def sealed_cases(tmp_path_factory):
    """``_seal_case`` of each (backbone, via_ops), sealed once per module."""
    cases = {}

    def get(model_3d, via_ops):
        key = (model_3d, via_ops)
        if key not in cases:
            cases[key] = _seal_case(model_3d, tmp_path_factory.mktemp(
                f"{model_3d}{int(via_ops)}"), via_ops)
        return cases[key]
    return get


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("model_3d,via_ops", [("schnet", False),
                                              ("painn", True)],
                         ids=["schnet-plain", "painn-ops"])
def test_sealed_artifact_matches_the_live_predictor(model_3d, via_ops,
                                                    sealed_cases, tmp_path,
                                                    monkeypatch):
    """Two buckets (both routes: the stack at 32, the per-block kernels at
    64), all four modes, partial chunks in ``ceil8(count)`` slots: equal
    to the live Predictor; loading and serving builds no backbone. SchNet's
    CPU artifact holds the plain versions, PaiNN's (sealed through the
    kernel route) the custom ops."""
    live, path, lep, lep_path = sealed_cases(model_3d, via_ops)
    store = _store(21, 3, 60, seed=4)
    active, inactive = _store(19, 33, 60, seed=5), _store(19, 33, 60, seed=6)
    want = {"predict": live.predict(store), "embed": live.embed(store),
            "forces": live.predict_forces(store),
            "pairs": lep.predict_pairs(active, inactive)}

    def boom(*a, **k):
        raise AssertionError("a backbone was built")

    monkeypatch.setattr(SchNet, "__init__", boom)
    monkeypatch.setattr(PaiNN, "__init__", boom)
    monkeypatch.setattr(serve, "make_backbone", boom)
    sealed = export.SealedPredictor.load(path)
    sealed_lep = export.SealedPredictor.load(lep_path)
    _close(sealed.predict(store), want["predict"])
    _close(sealed.embed(store), want["embed"])
    for got, w in zip(sealed.predict_forces(store), want["forces"]):
        _close(got, w)
    _close(sealed_lep.predict_pairs(active, inactive), want["pairs"])
    ops = {str(node.target) for prog in (*sealed._loaded.values(),
                                         *sealed_lep._loaded.values())
           for node in prog.graph.nodes if node.op == "call_function"}
    ours = {op for op in ops if "geossl_torch" in op}
    if via_ops:
        assert {"geossl_torch.painn_stack.default",
                "geossl_torch.painn_fwd.default",
                "geossl_torch.painn_bwd.default"} <= ours
    else:
        assert not ours
    meta = sealed.meta
    assert (meta["format_version"], meta["device"], meta["bucket_sizes"],
            meta["head"]) == (1, "cpu", [32, 64], "single")
    # the sealed CLI path
    npz, csv = str(tmp_path / "mols.npz"), str(tmp_path / "p.csv")
    store.save(npz)
    serve.main(["--ckpt", path, "--input", npz, "--output", csv])
    rows = [line.split(",") for line in open(csv).read().splitlines()]
    _close(np.asarray([float(r[1]) for r in rows], np.float32),
           want["predict"])


def test_sealed_artifact_refusals(sealed_cases, tmp_path, monkeypatch):
    """A shape outside the sealed ladder, a mode that was not sealed,
    another format_version, a cuda artifact without a card, and modes a
    checkpoint's head cannot serve: each raises."""
    live, path, lep, lep_path = sealed_cases("schnet", False)
    sealed_lep = export.SealedPredictor.load(lep_path)
    small, big = _store(2, 3, 20, seed=0), _store(2, 40, 60, seed=1)
    with pytest.raises(ValueError, match=r"pairs_32x64.*\['pairs_64x64'\]"):
        sealed_lep.predict_pairs(small, big)
    with pytest.raises(ValueError, match="embed.*mode was not sealed"):
        sealed_lep.embed(small)
    sealed = export.SealedPredictor.load(path)
    with pytest.raises(ValueError, match="largest bucket 64"):
        sealed.predict(_store(1, 70, 70, seed=2))

    def rewrite(key, value):
        out = str(tmp_path / f"{key}.sealed")
        with zipfile.ZipFile(path) as src, zipfile.ZipFile(out, "w") as dst:
            for name in src.namelist():
                data = src.read(name)
                if name == "meta.json":
                    meta = json.loads(data)
                    meta[key] = value
                    data = json.dumps(meta)
                dst.writestr(name, data)
        return out

    with pytest.raises(ValueError, match="format_version 2"):
        export.SealedPredictor.load(rewrite("format_version", 2))
    cuda = rewrite("device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never runs on the CPU"):
        export.SealedPredictor.load(cuda)
    bare = Predictor(live.cfg, {"model": live.model.state_dict()},
                     batch_size=16, bucket_sizes=(32,), device="cpu")
    with pytest.raises(ValueError, match="backbone-only"):
        export.seal(bare, str(tmp_path / "x.sealed"), modes=("predict",))
    with pytest.raises(ValueError, match="needs LEP's dual head"):
        export.seal(live, str(tmp_path / "x.sealed"), modes=("pairs",))
    with pytest.raises(ValueError, match="not in the predictor's ladder"):
        export.seal(lep, str(tmp_path / "x.sealed"), modes=("pairs",),
                    pair_buckets=(128,))
