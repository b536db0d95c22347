"""geossl_tpu_torch geometry, CFConv and SchNet against the JAX package on
the CPU, where every kernel wrapper takes its plain version.

* f64 (real f64 on the JAX side: built under jax_enable_x64, which the suite
  otherwise keeps off) at rtol 1e-10: geometry, the CFConv plain math,
  SchNet forward with and without max_neighbors, up to N=256.
* f32 against the Pallas kernels run in interpret mode, as the JAX package's
  own tests run them: rtol 2e-5 / atol 1e-5 (summation order differs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geossl_tpu.models.schnet import SchNet as JSchNet
from geossl_tpu.models.schnet import fused_stack_apply as j_fused_stack_apply
from geossl_tpu.ops import cfconv_pallas as jcf
from geossl_tpu.ops import geometry as jgeo
from geossl_tpu.utils.torch_import import schnet_params_to_torch
from geossl_tpu_torch.models.schnet import SchNet, fused_stack_apply
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.ops import geometry as tgeo
from geossl_tpu_torch.utils.torch_import import (
    load_torch_checkpoint,
    schnet_state_dict_from_flax,
)

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

SMALL = dict(hidden_channels=16, num_filters=16, num_interactions=2,
             num_gaussians=8, cutoff=5.0)


class x64:
    """Real f64 on the JAX side for the duration of the block."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def molecules(b, n, seed, dtype=np.float64, spread=0.9):
    """Padded random-walk molecules: row 0 full, the others partial, the
    last a single atom."""
    rng = np.random.default_rng(seed)
    z = np.zeros((b, n), np.int32)
    pos = np.zeros((b, n, 3), dtype)
    mask = np.zeros((b, n), bool)
    for i in range(b):
        k = n if i == 0 else (1 if i == b - 1 else int(rng.integers(2, n)))
        z[i, :k] = rng.integers(0, 9, k)
        pos[i, :k] = np.cumsum(rng.normal(scale=spread, size=(k, 3)), 0)
        mask[i, :k] = True
    return z, pos, mask


@pytest.mark.parametrize("max_neighbors", [None, 3])
def test_geometry_matches_jax_f64(max_neighbors):
    z, pos, mask = molecules(3, 24, seed=0)
    with x64():
        jd, jm = jgeo.pairwise_distances(jnp.asarray(pos), jnp.asarray(mask))
        jadj = jgeo.radius_adjacency(jd, jm, 4.0, max_neighbors)
        h = np.random.default_rng(1).normal(size=(3, 24, 5))
        jread = {k: np.asarray(jgeo.readout(jnp.asarray(h), jnp.asarray(mask), k))
                 for k in ("mean", "add")}
        jd = np.asarray(jd)
    td, tm = tgeo.pairwise_distances(torch.from_numpy(pos), torch.from_numpy(mask))
    tadj = tgeo.radius_adjacency(td, tm, 4.0, max_neighbors)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(tadj.numpy(), np.asarray(jadj))
    for k, want in jread.items():
        got = tgeo.readout(torch.from_numpy(h), torch.from_numpy(mask), k)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def _pair_inputs(b, n, seed, dtype, max_neighbors=None, f=16, g=8):
    z, pos, mask = molecules(b, n, seed, dtype=dtype)
    td, tm = tgeo.pairwise_distances(torch.from_numpy(pos), torch.from_numpy(mask))
    adj = tgeo.radius_adjacency(td, tm, 5.0, max_neighbors)
    env = 0.5 * (torch.cos(td * np.pi / 5.0) + 1.0) * adj.to(td.dtype)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(b, n, f)).astype(dtype)
    w = [rng.normal(scale=s, size=shape).astype(dtype) for shape, s in
         (((g, f), 0.5), ((f,), 0.1), ((f, f), 0.3), ((f,), 0.1))]
    return td.numpy(), env.numpy(), x, w


@pytest.mark.parametrize("n,symmetric,max_neighbors", [
    (32, False, None), (64, True, 4), (256, True, None)])
def test_cfconv_plain_matches_jax_reference_f64(n, symmetric, max_neighbors):
    b = 1 if n == 256 else 2
    d, e, x, w = _pair_inputs(b, n, 3, np.float64, max_neighbors)
    with x64():
        want = np.asarray(jcf.cfconv_fused_reference(
            *map(jnp.asarray, (d, e, x, *w)), 0.0, 5.0, 8))
    got = tcf.cfconv(*map(torch.from_numpy, (d, e, x, *w)), 0.0, 5.0, 8,
                     symmetric=symmetric)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n,kernel", [(64, "plain"), (256, "sym")])
def test_cfconv_wrappers_match_pallas_interpret(n, kernel):
    b = 1 if n == 256 else 2
    d, e, x, w = _pair_inputs(b, n, 5, np.float32)
    args = (0.0, 5.0, 8)
    if kernel == "sym":
        want = jcf.cfconv_fused_sym(*map(jnp.asarray, (d, e, x, *w)), *args,
                                    "f32", True)
        got = tcf.cfconv_fused_sym(*map(torch.from_numpy, (d, e, x, *w)),
                                   *args, True)
    else:
        want = jcf.cfconv_fused(*map(jnp.asarray, (d, e, x, *w)), *args, "f32",
                                True)
        got = tcf.cfconv_fused(*map(torch.from_numpy, (d, e, x, *w)), *args,
                               True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)


def test_dispatch_rules_match_jax():
    # SchNet's symmetric route: the JAX package's from N=256 up
    # (jcf.sym_profitable); on the H100, set by measurement, at every N (the
    # meta tensors reach the picked wrapper's device check)
    w = [torch.zeros(s, device="meta") for s in ((8, 16), (16,), (16, 16), (16,))]
    for n in (32, 64, 128, 256, 512, 1024):
        z, x = torch.zeros(1, n, n, device="meta"), torch.zeros(1, n, 16, device="meta")
        with pytest.raises(ValueError, match="cfconv_fwd_sym: no kernel"):
            tcf.cfconv(z, z, x, *w, 0.0, 5.0, 8, symmetric=True)
        with pytest.raises(ValueError, match="cfconv_fwd: no kernel"):
            tcf.cfconv(z, z, x, *w, 0.0, 5.0, 8, symmetric=False)
    assert tcf.STACK_MAX_N == jcf.STACK_MAX_N
    with pytest.raises(ValueError, match="no kernel"):
        tcf.cfconv_fused(*(torch.zeros(1, 8, 8, device="meta"),) * 2,
                         torch.zeros(1, 8, 16, device="meta"),
                         torch.zeros(8, 16, device="meta"),
                         torch.zeros(16, device="meta"),
                         torch.zeros(16, 16, device="meta"),
                         torch.zeros(16, device="meta"), 0.0, 5.0, 8)


def _jax_schnet(kwargs, z, pos, mask, seed=0):
    """JAX SchNet with params cast to f64, applied in x64; returns
    (module, f64 params, graph, node)."""
    m = JSchNet(**SMALL, **kwargs)
    with x64():
        params = m.init(jax.random.PRNGKey(seed), jnp.asarray(z),
                        jnp.asarray(pos, jnp.float32), jnp.asarray(mask))["params"]
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
        g, h = m.apply({"params": params}, jnp.asarray(z), jnp.asarray(pos),
                       jnp.asarray(mask))
        return m, params, np.asarray(g), np.asarray(h)


def _port_schnet(kwargs, params):
    kw = dict(kwargs)
    if "atomref" in kw:
        kw["atomref"] = np.asarray(kw["atomref"])
    model = SchNet(**SMALL, **kw).double()
    model.load_state_dict(schnet_state_dict_from_flax(params))
    return model


@pytest.mark.parametrize("kwargs,b,n", [
    ({}, 3, 32),
    ({"max_neighbors": 5}, 3, 32),
    ({"mean": 0.3, "std": 1.7, "atomref": np.linspace(-1, 1, 9)}, 2, 24),
    ({"dipole": True, "readout": "add"}, 2, 24),
    ({}, 1, 256),
    ({"max_neighbors": 32}, 1, 256),
], ids=["default", "max_neighbors", "atomref", "dipole", "n256",
        "n256_max_neighbors"])
def test_schnet_forward_matches_jax_f64(kwargs, b, n):
    z, pos, mask = molecules(b, n, seed=7, spread=1.3)
    _, params, jg, jh = _jax_schnet(kwargs, z, pos, mask)
    model = _port_schnet(kwargs, params)
    with torch.no_grad():
        g, h = model(torch.from_numpy(z).long(), torch.from_numpy(pos),
                     torch.from_numpy(mask))
    assert h.dtype == torch.float64
    # the JAX dipole branch returns f32 (dipole_readout casts q and pos, and
    # the node output is cast too); everything else stays f64
    tol = 1e-6 if kwargs.get("dipole") else 1e-10
    assert jh.dtype == (np.float32 if kwargs.get("dipole") else np.float64)
    np.testing.assert_allclose(h.numpy(), jh, rtol=tol, atol=tol)
    np.testing.assert_allclose(g.numpy(), jg, rtol=tol, atol=tol)


@pytest.mark.parametrize("kwargs", [{}, {"max_neighbors": 4}])
def test_stack_matches_pallas_interpret_f32(kwargs):
    """Plain whole-stack path vs fused_stack_apply (schnet_stack_infer in
    Pallas interpret mode)."""
    z, pos, mask = molecules(3, 32, seed=2, dtype=np.float32)
    m = JSchNet(**SMALL, **kwargs)
    params = m.init(jax.random.PRNGKey(3), jnp.asarray(z), jnp.asarray(pos),
                    jnp.asarray(mask))["params"]
    jg, jh = j_fused_stack_apply(m, params, jnp.asarray(z), jnp.asarray(pos),
                                 jnp.asarray(mask))
    model = SchNet(**SMALL, **kwargs)
    model.load_state_dict(schnet_state_dict_from_flax(params))
    with torch.no_grad():
        g, h = fused_stack_apply(model, torch.from_numpy(z).long(),
                                 torch.from_numpy(pos), torch.from_numpy(mask))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-5, atol=1e-5)


def test_stack_guards():
    model = SchNet(hidden_channels=16, num_filters=8, num_interactions=1,
                   num_gaussians=4)
    z = torch.zeros(1, 8, dtype=torch.long)
    pos = torch.zeros(1, 8, 3)
    mask = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="num_filters"):
        fused_stack_apply(model, z, pos, mask)
    square = SchNet(**SMALL)
    with pytest.raises(ValueError, match="float32"):
        fused_stack_apply(square, z, pos.double(), mask)
    big = torch.zeros(1, 256, 256)
    with pytest.raises(ValueError, match="per-block"):
        tcf.schnet_stack(big, big, torch.zeros(1, 256, 16),
                         square.stacked_weights(), 0.0, 5.0, 8)


def test_reference_pth_round_trip(tmp_path):
    """JAX params -> the JAX package's reference-layout state_dict -> .pth
    (with the reference's duplicate conv.nn keys and buffers) -> the port's
    loader -> strict load_state_dict -> same forward."""
    z, pos, mask = molecules(2, 20, seed=11, dtype=np.float32)
    m = JSchNet(**SMALL)
    params = m.init(jax.random.PRNGKey(5), jnp.asarray(z), jnp.asarray(pos),
                    jnp.asarray(mask))["params"]
    ref_sd = schnet_params_to_torch(params)
    ours = schnet_state_dict_from_flax(params)
    assert sorted(ours) == sorted(ref_sd)
    for k, v in ref_sd.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    sd = {k: torch.tensor(v) for k, v in ref_sd.items()}
    sd["interactions.0.conv.nn.0.weight"] = sd["interactions.0.mlp.0.weight"]
    sd["distance_expansion.offset"] = torch.linspace(0, 5.0, 8)
    path = str(tmp_path / "ref.pth")
    torch.save({"model": sd}, path)
    loaded = load_torch_checkpoint(path)
    assert "graph_pred_linear" not in loaded
    model = SchNet(**SMALL)
    model.load_state_dict(loaded["model"])  # strict
    jg, _ = m.apply({"params": params}, jnp.asarray(z), jnp.asarray(pos),
                    jnp.asarray(mask))
    with torch.no_grad():
        g, _ = model(torch.from_numpy(z).long(), torch.from_numpy(pos),
                     torch.from_numpy(mask))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-5, atol=1e-5)


def test_init_is_seeded_and_reference_shaped():
    a = SchNet(**SMALL, generator=torch.Generator().manual_seed(3))
    b = SchNet(**SMALL, generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sd = a.state_dict()
    assert sd["interactions.1.mlp.0.weight"].shape == (16, 8)
    assert torch.count_nonzero(sd["lin1.bias"]) == 0
    bound = (6.0 / (16 + 8)) ** 0.5
    assert sd["interactions.0.mlp.0.weight"].abs().max() <= bound


def _fold(c):
    """Both placements folded to one: c + c^T (JAX's tiles are not the
    port's 8x8 ones; each places a pair's two cotangents in its own way)."""
    return c + np.swapaxes(c, -1, -2)


def test_cfconv_bwd_sym_plain_matches_pallas_interpret():
    """The symmetric backward's plain version against JAX's #4
    (``_cfconv_sym_bwd`` over ``_bwd_sym_pallas``, in interpret mode) at
    N=256, f32: ddist/denv folded, dx and the weight gradients as they
    are."""
    d, e, x, w = _pair_inputs(1, 256, 13, np.float32)
    g = np.random.default_rng(14).normal(size=x.shape).astype(np.float32)
    want = jcf._cfconv_sym_bwd(*map(jnp.asarray, (d, e, x, *w, g)), 0.0, 5.0,
                               8, "f32", False)
    got = tcf.cfconv_bwd_sym(*map(torch.from_numpy, (d, e, x, g, *w)), 0.0,
                             5.0, 8)
    for k, (a, b) in enumerate(zip(got, want)):
        a, b = a.numpy(), np.asarray(b)
        if k < 2:
            a, b = _fold(a), _fold(b)
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max(), err_msg=str(k))


def test_cfconv_sym_gradients_through_positions_match_jax():
    """Gradients of a loss through positions -> dist -> env -> the
    symmetric CFConv: the port (its plain version on the CPU) against
    jax.grad of ``cfconv_fused_sym``, whose backward places ddist/denv."""
    n = 256
    z, pos, mask = molecules(1, n, seed=15, dtype=np.float32)
    rng = np.random.default_rng(16)
    x = rng.normal(size=(1, n, 16)).astype(np.float32)
    w = [rng.normal(scale=s, size=shape).astype(np.float32) for shape, s in
         (((8, 16), 0.5), ((16,), 0.1), ((16, 16), 0.3), ((16,), 0.1))]

    def jax_loss(p, *a):
        dd, pm = jgeo.pairwise_distances(p, jnp.asarray(mask))
        env = 0.5 * (jnp.cos(dd * np.pi / 5.0) + 1.0) * (pm & (dd < 5.0))
        return jnp.sum(jnp.tanh(jcf.cfconv_fused_sym(dd, env, *a, 0.0, 5.0, 8)))

    want = jax.grad(jax_loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, (pos, x, *w)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (pos, x, *w)]
    dd, pm = tgeo.pairwise_distances(ins[0], torch.from_numpy(mask))
    env = 0.5 * (torch.cos(dd * np.pi / 5.0) + 1.0) * (pm & (dd < 5.0))
    loss = torch.tanh(tcf.cfconv_fused_sym(dd, env, *ins[1:], 0.0, 5.0,
                                           8)).sum()
    got = torch.autograd.grad(loss, ins)
    for name, a, b in zip(("pos", "x", "w1", "b1", "w2", "b2"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("gated", [False, True])
def test_sym_placement_keeps_position_gradients_f64(gated):
    """The port's 8x8 placement (``place_sym_cotangent``; with gating also
    zero on tiles whose env is all zero, as the kernel writes), applied to
    the plain cotangents, gives the same position gradient as the unplaced
    ones: the contract chip_smoke.py holds the kernel to."""
    import chip_smoke

    z, pos, mask = molecules(2, 60, seed=17, spread=1.6)  # 60: a ragged tile
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.normal(size=(2, 60, 16)))
    g = torch.from_numpy(rng.normal(size=(2, 60, 16)))
    w = [torch.from_numpy(rng.normal(scale=s, size=shape)) for shape, s in
         (((8, 16), 0.5), ((16,), 0.1), ((16, 16), 0.3), ((16,), 0.1))]
    p = torch.from_numpy(pos).requires_grad_(True)
    dd, pm = tgeo.pairwise_distances(p, torch.from_numpy(mask))
    env = 0.5 * (torch.cos(dd * np.pi / 5.0) + 1.0) * \
        tgeo.radius_adjacency(dd, pm, 5.0)
    ddist, denv = tcf.cfconv_bwd_sym_reference(
        dd.detach(), env.detach(), x, g, *w, 0.0, 5.0, 8)[:2]
    placed = [tcf.place_sym_cotangent(c) for c in (ddist, denv)]
    if gated:
        occ = chip_smoke.tile_occupied(env.detach())
        assert not occ.all()
        placed = [torch.where(occ, c, torch.zeros_like(c)) for c in placed]
    assert not torch.equal(placed[1], denv)
    want = torch.autograd.grad((dd, env), p, (ddist, denv), retain_graph=True)
    got = torch.autograd.grad((dd, env), p, placed)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-12,
                               atol=1e-12 * want[0].abs().max().item())


@pytest.mark.parametrize("symmetric", [False, True])
def test_cfconv_function_refuses_double_backward(symmetric):
    """A backward asked to build a graph (MD17 forces) goes through the
    backward Function in both modes of the CFConv Function, which launches
    the kernel or raises: on a device without one it refuses, with no plain
    fallback."""
    from types import SimpleNamespace

    f = tcf.KERNEL_F
    saved = [torch.zeros(s, device="meta") for s in
             ((1, 8, 8), (1, 8, 8), (1, 8, f), (8, f), (f,), (f, f), (f,))]
    ctx = SimpleNamespace(symmetric=symmetric, saved_tensors=saved,
                          consts=(0.0, 5.0, 8, False))
    name = "cfconv_bwd_sym" if symmetric else "cfconv_bwd"
    with torch.enable_grad(), pytest.raises(
            ValueError, match=f"{name}: no kernel for device meta"):
        tcf._CFConv.backward(ctx, torch.zeros(1, 8, f, device="meta"))
