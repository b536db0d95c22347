"""geossl_tpu_torch's PaiNN against the JAX package on the CPU, where every
kernel wrapper takes its plain version.

* f64 at rtol 1e-10 (real f64 on the JAX side, built under jax_enable_x64):
  pairwise directions, the plain message pass and its backward (all nine
  cotangents against ``jax.vjp`` of the JAX reference), PaiNN's forward
  (with and without a pair mask and max_neighbors, with an all-padding
  graph slot and a single atom), and the plain whole stack against the
  port's own module forward. The JAX model casts positions, RBF offsets
  and its node output to f32 whatever its parameters' dtype; for the model
  comparisons the test maps those casts to f64 (``f64_casts``: the module's
  ``jnp.float32`` reads as ``float64``), so both sides run real f64.
* f32 against the Pallas kernels in interpret mode, as the JAX package's
  own tests run them: the message pass (gating on and off) and the whole
  stack at rtol 2e-5 / atol 1e-5; the backward at rtol 1e-4 with atol 1e-5
  times the output's largest magnitude (its sums over up to N pairs, and
  dWk's over B*N*N, run in another order).
* Weights carried across: the flax tree, the PaiNN head and a reference
  ``.pth`` written by the JAX package give the same outputs in the port.
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geossl_tpu.models import painn as jpainn
from geossl_tpu.models.painn import PaiNN as JPaiNN
from geossl_tpu.models.painn import fused_stack_apply as j_fused_stack_apply
from geossl_tpu.ops import geometry as jgeo
from geossl_tpu.ops import painn_pallas as jpp
from geossl_tpu.train.common import PaiNNHead as JPaiNNHead
from geossl_tpu.utils.torch_import import (
    painn_params_to_torch,
    save_torch_checkpoint,
)
from geossl_tpu_torch.models.painn import PaiNN, fused_stack_apply
from geossl_tpu_torch.ops import _launch
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.ops import geometry as tgeo
from geossl_tpu_torch.ops import painn as tpn
from geossl_tpu_torch.train.common import PaiNNHead
from geossl_tpu_torch.utils.torch_import import (
    head_state_dict_from_flax,
    load_torch_checkpoint,
    painn_state_dict_from_flax,
)
from tests import test_torch_port_schnet as S
from tests.test_torch_port_ncsn import close

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

F, R, CUT = 16, 20, 5.0
SMALL = dict(n_atom_basis=F, n_interactions=2, n_rbf=R, cutoff=CUT)
NAMES = ("ddist", "dgate", "ddirx", "ddiry", "ddirz", "dx", "dmu", "dwk", "dbk")


class _F64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def f64_casts():
    """The JAX PaiNN's f32 casts read as f64 (inside ``S.x64``)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpainn, "jnp", _F64Numpy())
    try:
        yield
    finally:
        mp.undo()


@pytest.fixture
def jax_f64():
    """Real f64 on the JAX side, the JAX PaiNN's f32 casts included."""
    with S.x64(), f64_casts():
        yield


def _molecules(b=4, n=24, seed=7, dtype=np.float64):
    """S.molecules with slot 2 an empty graph (the last holds one atom)."""
    z, pos, mask = S.molecules(b, n, seed, dtype=dtype, spread=1.3)
    z[2], pos[2], mask[2] = 0, 0.0, False
    return z, pos, mask


def _pair_case(b, n, seed, dtype):
    """Message-pass inputs on real geometry with padding: (dist, gate,
    dirx, diry, dirz, x, mu, wk, bk) as numpy arrays."""
    _, pos, mask = _molecules(b, n, seed, dtype)
    d, direction, pm = tgeo.pairwise_directions(torch.from_numpy(pos),
                                                torch.from_numpy(mask))
    adj = tgeo.radius_adjacency(d, pm, CUT)
    gate = 0.5 * (torch.cos(d * np.pi / CUT) + 1.0) * adj.to(d.dtype)
    rng = np.random.default_rng(seed + 1)
    x, mu = (rng.normal(scale=0.4, size=(b, n, 3 * F)).astype(dtype)
             for _ in range(2))
    wk = rng.normal(scale=0.3, size=(R, 3 * F)).astype(dtype)
    bk = rng.normal(scale=0.1, size=3 * F).astype(dtype)
    dirs = [direction[..., c].numpy().copy() for c in range(3)]
    return (d.numpy(), gate.numpy(), *dirs, x, mu, wk, bk)


def _cotangents(b, n, seed, dtype):
    rng = np.random.default_rng(seed + 2)
    return (rng.normal(size=(b, n, F)).astype(dtype),
            rng.normal(size=(b, n, 3 * F)).astype(dtype))


# -- f64 against the JAX package ---------------------------------------------


def test_pairwise_directions_match_jax_f64():
    _, pos, mask = _molecules()
    with S.x64():
        jd, jdir, jm = jgeo.pairwise_directions(jnp.asarray(pos),
                                                jnp.asarray(mask))
        jd, jdir, jm = map(np.asarray, (jd, jdir, jm))
    tpos = torch.from_numpy(pos).requires_grad_(True)
    td, tdir, tm = tgeo.pairwise_directions(tpos, torch.from_numpy(mask))
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(td.detach().numpy(), jd, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tdir.detach().numpy(), jdir, rtol=1e-10,
                               atol=1e-12)
    # masked directions are 0 with zero (finite) gradient
    (tdir.sum() + td.sum()).backward()
    assert torch.isfinite(tpos.grad).all()
    assert (tpos.grad[2] == 0).all() and (tdir[2] == 0).all()


def test_message_reference_matches_jax_f64():
    args = _pair_case(3, 24, seed=3, dtype=np.float64)
    with S.x64():
        want = jpp.painn_message_reference(*map(jnp.asarray, args), CUT)
        want = [np.asarray(w) for w in want]
    got = tpn.painn_message(*map(torch.from_numpy, args), CUT)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-12)


def test_bwd_reference_matches_jax_vjp_f64():
    args = _pair_case(3, 24, seed=4, dtype=np.float64)
    gq, gmu = _cotangents(3, 24, seed=4, dtype=np.float64)
    with S.x64():
        _, vjp = jax.vjp(lambda *a: jpp.painn_message_reference(*a, CUT),
                         *map(jnp.asarray, args))
        want = [np.asarray(w) for w in vjp((jnp.asarray(gq),
                                            jnp.asarray(gmu)))]
    got = tpn.painn_bwd(*map(torch.from_numpy, (*args, gq, gmu)), CUT)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-12,
                                   err_msg=name)


def _jax_params(module, z, pos, mask, seed=0):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(z),
                         jnp.asarray(pos, jnp.float32),
                         jnp.asarray(mask))["params"]
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)


@pytest.mark.parametrize("kwargs,clean_graph", [
    ({}, False),
    ({}, True),
    ({"max_neighbors": 4}, False),
    ({"shared_interactions": True, "shared_filters": True}, False),
], ids=["default", "pair_mask", "max_neighbors", "shared"])
def test_painn_forward_matches_jax_f64(jax_f64, kwargs, clean_graph):
    z, pos, mask = _molecules()
    pair_mask = None
    if clean_graph:  # DDM's case: the clean graph on perturbed positions
        d, pm = tgeo.pairwise_distances(torch.from_numpy(pos),
                                        torch.from_numpy(mask))
        pair_mask = tgeo.radius_adjacency(d, pm, CUT).numpy()
        pos = pos + np.random.default_rng(1).normal(scale=0.3, size=pos.shape)
    m = JPaiNN(**SMALL, **kwargs)
    params = _jax_params(m, z, pos, mask)
    jg, jh = m.apply({"params": params}, jnp.asarray(z), jnp.asarray(pos),
                     jnp.asarray(mask),
                     None if pair_mask is None else jnp.asarray(pair_mask))
    model = PaiNN(**SMALL, **kwargs).double()
    model.load_state_dict(painn_state_dict_from_flax(params, 2))
    with torch.no_grad():
        g, h = model(torch.from_numpy(z).long(), torch.from_numpy(pos),
                     torch.from_numpy(mask),
                     None if pair_mask is None else torch.from_numpy(pair_mask),
                     plain=True)
    assert h.dtype == torch.float64 and np.asarray(jh).dtype == np.float64
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-12)
    assert (g[2] == 0).all()  # the empty graph slot reads zero


def test_stack_plain_matches_module_forward_f64():
    """The plain whole stack (``painn_stack_reference``) against the port's
    module forward through the per-block dispatcher, both with the kernels'
    RBF; the CPU launches no kernel."""
    z, pos, mask = _molecules()
    model = PaiNN(**SMALL, generator=torch.Generator().manual_seed(4)).double()
    args = (torch.from_numpy(z).long(), torch.from_numpy(pos),
            torch.from_numpy(mask))
    _launch.reset_launch_counts()
    with torch.no_grad():
        _, want = model(*args)
        dist, direction, gate = model.geometry(args[1], args[2])
        q, mu = tpn.painn_stack_infer(
            dist, gate, *(direction[..., c] for c in range(3)),
            model.embed(args[0]), model.stacked_weights(), CUT)
    np.testing.assert_allclose(q.numpy(), want.numpy(), rtol=1e-10, atol=1e-12)
    assert mu.shape == (4, 24, 3 * F)
    assert set(_launch.launch_counts().values()) == {0}


# -- f32 against the Pallas kernels in interpret mode ------------------------


@pytest.mark.parametrize("sparse", [False, True])
def test_message_matches_pallas_interpret(sparse):
    args = _pair_case(3, 24, seed=5, dtype=np.float32)
    want = jpp.painn_message_fused(*map(jnp.asarray, args), CUT, sparse)
    got = tpn.painn_message_fused(*map(torch.from_numpy, args), CUT, sparse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=1e-5)


def test_bwd_matches_pallas_interpret():
    args = _pair_case(3, 24, seed=6, dtype=np.float32)
    gq, gmu = _cotangents(3, 24, seed=6, dtype=np.float32)
    dx, dmu, dwk, dbk, *pair = jpp._bwd_pallas(
        *map(jnp.asarray, args), CUT, jnp.asarray(gq), jnp.asarray(gmu), False)
    got = tpn.painn_bwd(*map(torch.from_numpy, (*args, gq, gmu)), CUT)
    for name, g, w in zip(NAMES, got, (*pair, dx, dmu, dwk, dbk)):
        close(g.numpy(), np.asarray(w).reshape(g.shape))


@pytest.mark.parametrize("kwargs", [{}, {"shared_filters": True}])
def test_fused_stack_apply_matches_pallas_interpret(kwargs):
    z, pos, mask = _molecules(dtype=np.float32)
    m = JPaiNN(**SMALL, **kwargs)
    params = m.init(jax.random.PRNGKey(2), jnp.asarray(z), jnp.asarray(pos),
                    jnp.asarray(mask))["params"]
    jg, jh = j_fused_stack_apply(m, params, jnp.asarray(z), jnp.asarray(pos),
                                 jnp.asarray(mask))
    model = PaiNN(**SMALL, **kwargs)
    model.load_state_dict(painn_state_dict_from_flax(params))
    with torch.no_grad():
        g, h = fused_stack_apply(model, torch.from_numpy(z).long(),
                                 torch.from_numpy(pos), torch.from_numpy(mask))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-5, atol=1e-5)


# -- weights across the packages ---------------------------------------------


def test_state_dict_from_flax_is_the_reference_layout():
    z, pos, mask = _molecules(dtype=np.float32)
    for kwargs in ({}, {"shared_interactions": True}):
        m = JPaiNN(**SMALL, **kwargs)
        params = m.init(jax.random.PRNGKey(3), jnp.asarray(z), jnp.asarray(pos),
                        jnp.asarray(mask))["params"]
        ours = painn_state_dict_from_flax(params, 2)
        model = PaiNN(**SMALL, **kwargs)
        model.load_state_dict(ours)  # strict
        if kwargs:
            assert model.interactions[0] is model.interactions[1]
            with pytest.raises(ValueError, match="n_interactions"):
                painn_state_dict_from_flax(params)
            continue
        ref = painn_params_to_torch(params)
        assert sorted(ours) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_painn_head_matches_jax():
    x = np.random.default_rng(0).normal(size=(5, F)).astype(np.float32)
    jhead = JPaiNNHead(F)
    params = jhead.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    head = PaiNNHead(F)
    head.load_state_dict(head_state_dict_from_flax(params))  # strict
    assert [tuple(p.shape) for p in head.parameters()] == [
        (F // 2, F), (F // 2,), (1, F // 2), (1,)]
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jhead.apply({"params": params},
                                                      jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_reference_pth_round_trip(tmp_path):
    """JAX params and head -> the JAX package's reference-format .pth
    (``save_torch_checkpoint``) -> the port's loader -> strict loads -> the
    same predictions."""
    z, pos, mask = _molecules(dtype=np.float32)
    m = JPaiNN(**SMALL)
    params = m.init(jax.random.PRNGKey(5), jnp.asarray(z), jnp.asarray(pos),
                    jnp.asarray(mask))["params"]
    head = JPaiNNHead(F)
    hparams = head.init(jax.random.PRNGKey(6), jnp.zeros((2, F)))["params"]
    path = str(tmp_path / "painn.pth")
    save_torch_checkpoint(path, {"model": params, "graph_pred_linear": hparams})
    state = torch.load(path, weights_only=True)
    state["model"]["radial_basis.offsets"] = torch.linspace(0, CUT, R)
    torch.save(state, path)
    loaded = load_torch_checkpoint(path)
    model, thead = PaiNN(**SMALL), PaiNNHead(F)
    model.load_state_dict(loaded["model"])
    thead.load_state_dict(loaded["graph_pred_linear"])
    jg, _ = m.apply({"params": params}, jnp.asarray(z), jnp.asarray(pos),
                    jnp.asarray(mask))
    want = head.apply({"params": hparams}, jg)
    with torch.no_grad():
        g, _ = model(torch.from_numpy(z).long(), torch.from_numpy(pos),
                     torch.from_numpy(mask), plain=True)
        got = thead(g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)


# -- dispatch, guards, init ---------------------------------------------------


def test_dispatch_rules_and_guards():
    assert tpn.STACK_MAX_N == jpp.STACK_MAX_N
    for n in (32, 64, 128, 256, 512, 1024):
        assert tpn.sym_profitable(n) == jpp.painn_sym_profitable(n), n
    args = _pair_case(3, 24, seed=8, dtype=np.float32)
    t = list(map(torch.from_numpy, args))
    want = tpn.painn_message_reference(*t, CUT)
    for sym in (False, True):  # the CPU takes the plain version either way
        for g, w in zip(tpn.painn_message(*t, CUT, symmetric=sym), want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    meta = [torch.zeros(a.shape, device="meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        tpn.painn_message_fused(*meta, CUT)
    big = [torch.zeros(1, 256, 256, device="meta")] * 5
    # from N=256 the symmetric route takes the symmetric kernel pair
    with pytest.raises(ValueError, match="painn_fwd_sym: no kernel"):
        tpn.painn_message(*big, torch.zeros(1, 256, 3 * F, device="meta"),
                          torch.zeros(1, 256, 3 * F, device="meta"), *meta[7:],
                          CUT, symmetric=True)
    gq, gmu = (torch.zeros(3, 24, w, device="meta") for w in (F, 3 * F))
    for sym, name in ((False, "painn_bwd"), (True, "painn_bwd_sym")):
        # a double backward, both modes: its backward Function launches the
        # kernel or raises, with no plain fallback
        ctx = SimpleNamespace(symmetric=sym, saved_tensors=meta,
                              consts=(CUT, False))
        with torch.enable_grad(), pytest.raises(
                ValueError, match=f"{name}: no kernel for device meta"):
            tpn._PaiNNMessage.backward(ctx, gq, gmu)
    model = PaiNN(**SMALL)
    with pytest.raises(ValueError, match="per-block"):
        tpn.painn_stack_infer(*big, torch.zeros(1, 256, F),
                              model.stacked_weights(), CUT)
    z = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="float32"):
        fused_stack_apply(model, z, torch.zeros(1, 8, 3, dtype=torch.float64),
                          torch.ones(1, 8, dtype=torch.bool))


def test_init_is_seeded_and_row0_is_gated():
    a = PaiNN(**SMALL, generator=torch.Generator().manual_seed(3))
    b = PaiNN(**SMALL, generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sd = a.state_dict()
    assert sd["filter_net.weight"].shape == (2 * 3 * F, R)
    assert sd["mixing.1.mu_channel_mix.weight"].shape == (2 * F, F)
    assert "mixing.0.mu_channel_mix.bias" not in sd
    assert torch.count_nonzero(sd["filter_net.bias"]) == 0
    z, pos, mask = _molecules(dtype=np.float32)
    args = (torch.from_numpy(z).long(), torch.from_numpy(pos),
            torch.from_numpy(mask))
    assert (args[0][0] == 0).any()  # atom type 0 is in use
    g, _ = a(*args, plain=True)
    g.sum().backward()
    assert a.embedding.weight.grad[0].abs().max() == 0
    assert a.embedding.weight.grad[1:].abs().max() > 0
    with torch.no_grad():
        a.embedding.weight[0] += 1.0
        g2, _ = a(*args, plain=True)
    torch.testing.assert_close(g2, g.detach(), rtol=0, atol=0)
