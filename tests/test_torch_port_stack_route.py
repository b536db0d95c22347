"""Serving's route between the whole-stack kernels and the per-block
kernels, and the SchNet stack's symmetric mode, on the CPU (plain versions).

``serve.Predictor`` takes the stack for a bucket up to the backbone's own
constant (``SCHNET_STACK_MAX_N``, ``PAINN_STACK_MAX_N``), set by the card's
measurement; both routes compute the same function. ``fused_stack_apply``
asks ``schnet_stack`` for one filter per unordered pair exactly when the
graph is symmetric (no ``max_neighbors``), and the kernel's tile scheme
(tiles pi <= pj, each adding its mirrored messages) is the dense sum.
"""

import numpy as np
import pytest
import torch

from geossl_tpu_torch import serve
from geossl_tpu_torch.config import ModelConfig, PaiNNConfig, SchNetConfig
from geossl_tpu_torch.data.store import MolRecord, MolStore
from geossl_tpu_torch.models import schnet as tsn
from geossl_tpu_torch.models.common import cosine_envelope
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.train.common import make_backbone, make_head

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)


def _store(sizes, seed):
    rng = np.random.default_rng(seed)
    return MolStore.from_records([MolRecord(
        atom_type=rng.integers(1, 9, n).astype(np.int32),
        positions=np.cumsum(rng.normal(scale=0.9, size=(n, 3)),
                            axis=0).astype(np.float32)) for n in sizes])


def _cfg(model_3d, max_neighbors=None):
    if model_3d == "painn":
        return ModelConfig(model_3d="painn", emb_dim=16, painn=PaiNNConfig(
            n_atom_basis=16, n_interactions=2, n_rbf=8))
    return ModelConfig(emb_dim=16, max_neighbors=max_neighbors,
                       schnet=SchNetConfig(num_filters=16, num_interactions=2,
                                           num_gaussians=8))


def _state(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"model": make_backbone(cfg, gen).state_dict(),
            "graph_pred_linear": make_head(cfg.model_3d, cfg.emb_dim,
                                           gen).state_dict()}


def test_constants_are_the_measured_routes():
    """The chip's serving_route: line: each backbone's stack is the faster
    route at every stack bucket; both within the kernels' shape limit."""
    assert serve.SCHNET_STACK_MAX_N == 128
    assert serve.PAINN_STACK_MAX_N == 128
    assert max(serve.SCHNET_STACK_MAX_N, serve.PAINN_STACK_MAX_N) \
        <= tcf.STACK_MAX_N


@pytest.mark.parametrize("model_3d,const", [("schnet", "SCHNET_STACK_MAX_N"),
                                            ("painn", "PAINN_STACK_MAX_N")])
@pytest.mark.parametrize("limit", [0, 32, 64, 128])
def test_predictor_takes_the_route_its_constant_names(monkeypatch, model_3d,
                                                      const, limit):
    monkeypatch.setattr(serve, const, limit)
    cfg = _cfg(model_3d)
    pred = serve.Predictor(cfg, _state(cfg), batch_size=4,
                           bucket_sizes=(32, 64, 128), device="cpu")
    assert [pred.stack_route(n) for n in (32, 64, 128, 256)] == \
        [n <= limit for n in (32, 64, 128, 256)]
    calls = []
    stack = pred._stack_apply
    pred._stack_apply = lambda *a, **k: calls.append(a[2].shape[1]) or \
        stack(*a, **k)
    pred.embed(_store([10, 20, 40, 50, 90], seed=1))
    assert calls == [n for n in (32, 64, 128) if n <= limit]


@pytest.mark.parametrize("model_3d,const", [("schnet", "SCHNET_STACK_MAX_N"),
                                            ("painn", "PAINN_STACK_MAX_N")])
def test_both_routes_serve_the_same_molecules(monkeypatch, model_3d, const):
    cfg = _cfg(model_3d)
    state = _state(cfg, seed=2)
    store = _store([5, 17, 30, 33, 60, 64, 70, 120], seed=3)
    out = {}
    for limit in (0, 128):
        monkeypatch.setattr(serve, const, limit)
        pred = serve.Predictor(cfg, state, y_mean=0.5, y_std=2.0,
                               batch_size=4, bucket_sizes=(32, 64, 128),
                               device="cpu")
        out[limit] = (pred.predict(store), pred.embed(store))
    for got, want in zip(out[128], out[0]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("max_neighbors", [None, 4])
def test_fused_stack_apply_asks_for_symmetry_without_max_neighbors(
        monkeypatch, max_neighbors):
    cfg = _cfg("schnet", max_neighbors)
    model = make_backbone(cfg, torch.Generator().manual_seed(4))
    seen = []

    def spy(*a, symmetric=False):
        seen.append(symmetric)
        return tcf.schnet_stack(*a, symmetric=symmetric)

    monkeypatch.setattr(tsn, "schnet_stack", spy)
    rec = _store([12], seed=5).get(0)
    pos = torch.from_numpy(rec.positions)[None]
    z = torch.from_numpy(rec.atom_type).long()[None]
    mask = torch.ones(1, 12, dtype=torch.bool)
    with torch.no_grad():
        tsn.fused_stack_apply(model, z, pos, mask)
    assert seen == [max_neighbors is None]


def _stack_inputs(seed, b=2, n=20, f=16, g=8, layers=2):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.normal(scale=1.5, size=(b, n, 3)))
    dist = torch.cdist(pos, pos)
    env = cosine_envelope(dist, 5.0)
    env = env * (1 - torch.eye(n, dtype=env.dtype))
    h0 = torch.from_numpy(rng.normal(size=(b, n, f)))
    shapes = ((f, f), (g, f), (f,), (f, f), (f,), (f, f), (f,), (f, f), (f,))
    stacked = tuple(torch.from_numpy(rng.normal(scale=0.3, size=(layers, *s)))
                    for s in shapes)
    return dist, env, h0, stacked


def test_plain_stack_is_the_same_in_both_modes_f64():
    dist, env, h0, stacked = _stack_inputs(6)
    assert torch.equal(dist, dist.transpose(1, 2))
    got = [tcf.schnet_stack(dist, env, h0, stacked, 0.0, 5.0, 8,
                            symmetric=sym) for sym in (True, False)]
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], tcf.schnet_stack_reference(
        dist, env, h0, stacked, 0.0, 5.0, 8))


@pytest.mark.parametrize("n", [8, 20, 32])
def test_symmetric_tile_scheme_is_the_dense_message_f64(n):
    """The symmetric kernel's scheme on 8x8 tiles: only tiles pi <= pj get a
    filter; a tile with pi < pj adds w x_j to its rows i and w x_i to its
    rows j. That is the dense sum of the plain version for symmetric
    dist/env."""
    dist, env, h0, stacked = _stack_inputs(7 + n, b=1, n=n)
    wl1, w1, b1, w2, b2 = (t[0] for t in stacked[:5])
    x = h0 @ wl1
    w = tcf.shifted_softplus(tcf.gaussian_smearing(dist, 0.0, 5.0, 8) @ w1
                             + b1) @ w2 + b2
    want = torch.einsum("bijf,bij,bjf->bif", w, env, x)
    got = torch.zeros_like(want)
    nt = -(-n // 8)
    for pi in range(nt):
        for pj in range(pi, nt):
            i, j = slice(8 * pi, 8 * pi + 8), slice(8 * pj, 8 * pj + 8)
            ew = env[:, i, j, None] * w[:, i, j]
            got[:, i] += torch.einsum("bijf,bjf->bif", ew, x[:, j])
            if pi < pj:
                got[:, j] += torch.einsum("bijf,bif->bjf", ew, x[:, i])
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
