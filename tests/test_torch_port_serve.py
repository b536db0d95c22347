"""geossl_tpu_torch.serve on the CPU against the JAX Predictor on converted
weights (rtol 2e-5 / atol 1e-5 in f32, as tests/test_serve.py), plus the
port's device rules: CUDA by default, raise without it, no kernel launch for
CPU tensors."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geossl_tpu.config import ModelConfig as JModelConfig
from geossl_tpu.config import PaiNNConfig as JPaiNNConfig
from geossl_tpu.config import SchNetConfig as JSchNetConfig
from geossl_tpu.serve import Predictor as JPredictor
from geossl_tpu.train import common as jcommon
from geossl_tpu_torch.config import ModelConfig, PaiNNConfig, SchNetConfig
from geossl_tpu_torch.data.store import MolRecord, MolStore
from geossl_tpu_torch.ops import _launch
from geossl_tpu_torch.serve import Predictor, main
from geossl_tpu_torch.train.common import make_backbone, make_head
from geossl_tpu_torch.utils.torch_import import (
    head_state_dict_from_flax,
    painn_state_dict_from_flax,
    schnet_state_dict_from_flax,
)

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

SMALL = dict(num_filters=16, num_interactions=2, num_gaussians=8)


def _store(m, n_lo, n_hi, seed, spread=0.9):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(m):
        n = int(rng.integers(n_lo, n_hi + 1))
        recs.append(MolRecord(
            atom_type=rng.integers(0, 9, n).astype(np.int32),
            positions=np.cumsum(rng.normal(scale=spread, size=(n, 3)),
                                axis=0).astype(np.float32)))
    return MolStore.from_records(recs)


def _jax_params(cfg, seed=0):
    module, _ = jcommon.make_backbone(cfg)
    rng = jax.random.PRNGKey(seed)
    return {"model": jcommon.init_backbone(module, rng, n_max=64),
            "graph_pred_linear": jcommon.LinearHead().init(
                rng, jnp.zeros((2, cfg.emb_dim)))["params"]}


def _port_state(params):
    return {"model": schnet_state_dict_from_flax(params["model"]),
            "graph_pred_linear": head_state_dict_from_flax(
                params["graph_pred_linear"])}


@pytest.mark.parametrize("max_neighbors", [None, 4])
def test_predict_and_embed_match_jax_predictor(max_neighbors):
    """Two buckets with partial chunks, denormalization, input order."""
    jcfg = JModelConfig(emb_dim=16, schnet=JSchNetConfig(**SMALL),
                        max_neighbors=max_neighbors)
    tcfg = ModelConfig(emb_dim=16, schnet=SchNetConfig(**SMALL),
                       max_neighbors=max_neighbors)
    params = _jax_params(jcfg)
    store = _store(11, 3, 60, seed=0)
    kw = dict(y_mean=2.5, y_std=3.0, batch_size=4, bucket_sizes=(32, 64))
    jpred = JPredictor(jcfg, params, **kw)
    tpred = Predictor(tcfg, _port_state(params), device="cpu", **kw)
    got, want = tpred.predict(store), jpred.predict(store)
    assert got.shape == (11,)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(tpred.embed(store), jpred.embed(store),
                               rtol=2e-5, atol=1e-5)


def test_painn_predictor_matches_jax_predictor():
    """PaiNN: the stack route (buckets 32 and 64, up to
    ``serve.PAINN_STACK_MAX_N``) and the per-block route (256) on the CPU
    against the JAX Predictor
    (use_pallas=False) on the same weights, with the halving-MLP head."""
    psmall = dict(n_interactions=2, n_rbf=8)
    jcfg = JModelConfig(model_3d="painn", emb_dim=16,
                        painn=JPaiNNConfig(n_atom_basis=16, **psmall))
    tcfg = ModelConfig(model_3d="painn", emb_dim=16,
                       painn=PaiNNConfig(n_atom_basis=16, **psmall))
    module, _ = jcommon.make_backbone(jcfg)
    rng = jax.random.PRNGKey(4)
    params = {"model": jcommon.init_backbone(module, rng, n_max=64),
              "graph_pred_linear": jcommon.PaiNNHead(16).init(
                  rng, jnp.zeros((2, 16)))["params"]}
    state = {"model": painn_state_dict_from_flax(params["model"]),
             "graph_pred_linear": head_state_dict_from_flax(
                 params["graph_pred_linear"])}
    recs = [_store(7, 3, 60, seed=8).get(i) for i in range(7)] + \
        [_store(2, 130, 160, seed=9, spread=1.5).get(i) for i in range(2)]
    store = MolStore.from_records(recs)
    kw = dict(y_mean=0.5, y_std=2.0, batch_size=4, bucket_sizes=(32, 64, 256))
    jpred = JPredictor(jcfg, params, **kw)
    tpred = Predictor(tcfg, state, device="cpu", **kw)
    np.testing.assert_allclose(tpred.predict(store), jpred.predict(store),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(tpred.embed(store), jpred.embed(store),
                               rtol=2e-5, atol=1e-5)


def test_large_buckets_sorted_in_input_order():
    """Buckets above STACK_MAX_N take the per-block path (symmetric
    dispatch at N=256) after the Morton sort; results stay in input order and
    match per-molecule forwards of the unsorted molecules."""
    cfg = ModelConfig(emb_dim=16, schnet=SchNetConfig(**SMALL))
    gen = torch.Generator().manual_seed(1)
    state = {"model": make_backbone(cfg, gen).state_dict(),
             "graph_pred_linear": make_head("schnet", 16, gen).state_dict()}
    store = _store(3, 100, 200, seed=4, spread=1.5)
    pred = Predictor(cfg, state, batch_size=2, bucket_sizes=(128, 256),
                     device="cpu")
    got = pred.predict(store)
    for i in range(len(store)):
        single = MolStore.from_records([store.get(i)])
        solo = Predictor(cfg, state, batch_size=1, bucket_sizes=(256,),
                         spatial_sort="off", device="cpu")
        np.testing.assert_allclose(got[i], solo.predict(single)[0],
                                   rtol=2e-5, atol=1e-5)


def test_cpu_tensors_launch_no_kernel():
    cfg = ModelConfig(emb_dim=16, schnet=SchNetConfig(**SMALL))
    gen = torch.Generator().manual_seed(2)
    state = {"model": make_backbone(cfg, gen).state_dict()}
    _launch.reset_launch_counts()
    store = _store(4, 20, 140, seed=5)
    emb = Predictor(cfg, state, batch_size=2, bucket_sizes=(32, 64, 128, 256),
                    device="cpu").embed(store)
    assert np.isfinite(emb).all()
    counts = _launch.launch_counts()
    assert {"cfconv_fwd", "cfconv_fwd_sym", "schnet_stack"} <= set(counts)
    assert set(counts.values()) == {0}


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(emb_dim=16, schnet=SchNetConfig(**SMALL))
    state = {"model": make_backbone(cfg, torch.Generator()).state_dict()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(cfg, state)


def test_headless_checkpoint_and_cli(tmp_path, capsys):
    gen = torch.Generator().manual_seed(3)
    cfg = ModelConfig()  # the CLI serves the default configuration
    backbone = make_backbone(cfg, gen).state_dict()
    head = make_head("schnet", cfg.emb_dim, gen).state_dict()
    store = _store(3, 3, 10, seed=6)
    npz = str(tmp_path / "mols.npz")
    store.save(npz)

    headless = str(tmp_path / "backbone.pth")
    torch.save({"model": backbone}, headless)
    pred = Predictor.from_checkpoint(headless, batch_size=2, device="cpu")
    assert pred.embed(store).shape == (3, 128)
    with pytest.raises(ValueError, match="backbone-only"):
        pred.predict(store)
    with pytest.raises(ValueError, match="want a JAX .ckpt or a torch"):
        Predictor.from_checkpoint(str(tmp_path / "model.bin"), device="cpu")

    full = str(tmp_path / "finetuned.pth")
    torch.save({"model": backbone, "graph_pred_linear": head, "y_mean": 1.0,
                "y_std": 2.0}, full)
    csv = str(tmp_path / "preds.csv")
    main(["--ckpt", full, "--input", npz, "--output", csv, "--device", "cpu",
          "--batch_size", "2"])
    rows = [line.split(",") for line in open(csv).read().splitlines()]
    assert [r[0] for r in rows] == ["0", "1", "2"]
    want = Predictor.from_checkpoint(full, batch_size=2,
                                     device="cpu").predict(store)
    np.testing.assert_allclose([float(r[1]) for r in rows], want, rtol=1e-6)
    main(["--ckpt", full, "--input", npz, "--mode", "embed", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and len(lines[0].split(",")) == 129


def test_config_rejects_what_is_not_ported():
    for kw in ({"compute_dtype": "bfloat16"}, {"filter_mxu": "bf16"}):
        with pytest.raises(NotImplementedError):
            ModelConfig(**kw)
    # pair-grid parallelism is ported (tests/test_torch_port_pair_parallel.py)
    assert ModelConfig(pair_axis="pair").pair_axis == "pair"
    with pytest.raises(ValueError):
        ModelConfig(max_neighbors=0)
    s = ModelConfig().schnet
    assert (s.hidden_channels, s.num_filters, s.num_interactions,
            s.num_gaussians, s.cutoff, s.node_class, s.readout) == (
        128, 128, 6, 51, 10.0, 9, "mean")
    p = ModelConfig(model_3d="painn").backbone
    assert (p.n_atom_basis, p.n_interactions, p.n_rbf, p.cutoff, p.readout,
            p.max_z, p.shared_interactions, p.shared_filters, p.epsilon) == (
        128, 3, 20, 5.0, "add", 9, False, False, 1e-8)
    # every field the port has keeps the JAX default (the head's width is
    # fixed at 1, so the port has no n_out)
    ported = dataclasses.asdict(p)
    jax_cfg = dataclasses.asdict(JPaiNNConfig())
    assert ported == {k: jax_cfg[k] for k in ported}
