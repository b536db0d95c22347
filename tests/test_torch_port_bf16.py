"""The bfloat16 modes on the CPU: ``--filter_mxu bf16`` and ``--compute_dtype
bfloat16`` against the JAX package on the same inputs and weights.

The JAX package rounds to bf16 in two places, and the port does the same:

* ``mxu='bf16'`` (``cfconv_pallas._dot``): the CFConv filter products take
  bf16 operands with f32 accumulation, in the forward (#1, #3) and in the
  four backward products (#2, #4), nowhere else. The port's plain versions
  round the same operands (``ops/cfconv._dot``); the plain bf16 backward is
  the JAX kernel's backward body written out. Held to the JAX Pallas
  kernels in interpret mode at the JAX package's own fused-vs-reference
  bound for the mode (``tests/test_cfconv_pallas.py::test_bf16_mxu_mode``):
  rtol 2e-3 and atol 2e-3 x the output's largest magnitude; the second
  order (autograd through the casts on both sides, JAX's XLA
  ``_cfconv_bwd_bwd``) at its gradient bound, 5% of the f32 gradient's
  mean magnitude.
* ``compute_dtype='bfloat16'``: SchNet's embedding, residual stream and
  dense layers in bf16 (flax ``Dense`` rounding: product, then bias),
  PaiNN's dense layers; the activations round where XLA rounds on a bf16
  array (bitwise here). SchNet in both modes, PaiNN in ``compute_dtype``
  and a DDM-SchNet step's loss and gradients are held to the JAX package's
  own bf16 bounds (``tests/test_schnet.py``: compute_dtype rtol 0.1 / atol
  0.05, filter_mxu rtol 0.02 / atol 0.01 on outputs; gradients within 5%
  of the f32 gradient's mean magnitude).

Every comparison also checks that the port's bf16 result is nearer to
JAX's bf16 result than JAX's bf16 result is to JAX's f32 result (relative
norms): the port rounds where JAX rounds, not merely somewhere. Also: the
bf16 Predictor's per-block route, the stacks' refusals, the CLI flags on
one CPU step, the kernel ops' schemas with ``mxu`` and the bf16 instances'
own launch counters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from geossl_tpu.config import ModelConfig as JModelConfig
from geossl_tpu.config import SchNetConfig as JSchNetConfig
from geossl_tpu.models.common import shifted_softplus as jssp
from geossl_tpu.models.painn import PaiNN as JPaiNN
from geossl_tpu.models.schnet import SchNet as JSchNet
from geossl_tpu.objectives.ncsn import NCSNv3 as JNCSNv3
from geossl_tpu.ops import cfconv_pallas as jcf
from geossl_tpu.ops import geometry as jgeo
from geossl_tpu.serve import Predictor as JPredictor
from geossl_tpu.train import common as jcommon
from geossl_tpu_torch.config import ModelConfig, SchNetConfig
from geossl_tpu_torch.data.batch import DenseMolBatch
from geossl_tpu_torch.models import common as tcommon
from geossl_tpu_torch.models import painn as tpainn
from geossl_tpu_torch.models import schnet as tschnet
from geossl_tpu_torch.objectives.ncsn import NCSNv3
from geossl_tpu_torch.ops import _launch
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.serve import Predictor
from geossl_tpu_torch.train import pretrain_geossl as PG
from geossl_tpu_torch.utils.torch_import import (
    head_state_dict_from_flax,
    ncsn_state_dict_from_flax,
    painn_state_dict_from_flax,
    schnet_state_dict_from_flax,
)
from tests import test_torch_port_schnet as S

# Six test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

CUT, G, F = 5.0, 8, 16
SMALL = dict(hidden_channels=F, num_filters=F, num_interactions=2,
             num_gaussians=G, cutoff=CUT)
PSMALL = dict(n_atom_basis=F, n_interactions=2, n_rbf=8, cutoff=CUT)
# the JAX package's bounds: mxu='bf16' fused vs reference; SchNet in
# compute_dtype and in filter_mxu against f32; gradients
KERNEL_TOL = dict(rtol=2e-3, atol=2e-3)
MODEL_TOL = {"compute_dtype": dict(rtol=0.1, atol=0.05),
             "filter_mxu": dict(rtol=0.02, atol=0.01)}
GRAD_MEAN = 0.05
BWD_NAMES = ("ddist", "denv", "dx", "dW1", "db1", "dW2", "db2")


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def assert_nearer(port16, jax16, jax32, what):
    """The port's bf16 result is nearer to JAX's bf16 result than JAX's
    bf16 result is to JAX's f32 one. Where hardly any rounded operand
    reaches a result (db2, the sum of qe; b2's second-order cotangent),
    JAX's two modes agree to f32 rounding (1e-6), and the port must agree
    with JAX's bf16 result to f32 rounding too."""
    d_port, d_jax = rel(port16, jax16), rel(jax16, jax32)
    assert d_port < d_jax or (d_jax < 1e-6 and d_port < 1e-6), (
        what, d_port, d_jax)


def assert_scaled(got, want, what, rtol, atol):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * np.abs(want).max(), err_msg=what)


def assert_grad(got, want, want32, what):
    """JAX's gradient bound: mean |got - want| within 5% of mean |f32|."""
    err = np.abs(_np(got) - _np(want)).mean()
    assert err <= GRAD_MEAN * (np.abs(_np(want32)).mean() + 1e-8), (what, err)


# -- the activations and Dense: bitwise where XLA rounds ----------------------


def test_bf16_activations_and_dense_round_where_jax_rounds():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(scale=4, size=4096),
                        rng.uniform(-30, 30, 4096)]).astype(np.float32)
    jv = jnp.asarray(v).astype(jnp.bfloat16)
    tv = torch.from_numpy(v).bfloat16()
    for name, jfn, tfn in (("ssp", jax.jit(jssp), tcommon.shifted_softplus),
                           ("silu", jax.jit(jax.nn.silu), tcommon.silu)):
        got = tfn(tv)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got), _np(jfn(jv)), err_msg=name)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 16)) * 0.3).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    want = jax.jit(lambda a: nn.Dense(16, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": w, "bias": b}}, a))(x)
    lin = torch.nn.Linear(32, 16)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    got = tcommon.linear(lin, torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


# -- #1-#4's plain versions against the JAX Pallas kernels (interpret) -------


def _pair_case(n, seed, max_neighbors=None):
    d, e, x, w = S._pair_inputs(2, n, seed, np.float32, max_neighbors, F, G)
    ct = np.random.default_rng(seed + 5).normal(size=x.shape).astype(
        np.float32)
    return d, e, x, w, ct


@pytest.mark.parametrize("kernel", ["fwd", "bwd", "fwd_sym", "bwd_sym"])
def test_cfconv_bf16_plain_versions_match_pallas_interpret(kernel):
    """Forward outputs and the VJP's seven cotangents (the symmetric one's
    pair cotangents folded: each side places them its own way)."""
    sym = kernel.endswith("sym")
    d, e, x, w, ct = _pair_case(16, 3, None if sym else 4)
    args = (0.0, CUT, G)
    jin = [jnp.asarray(a) for a in (d, e, x, *w)]
    tin = [torch.from_numpy(a) for a in (d, e, x, *w)]
    if kernel.startswith("fwd"):
        jfwd = jcf.cfconv_fused_sym if sym else jcf.cfconv_fused
        tfwd = tcf.cfconv_fused_sym if sym else tcf.cfconv_fused
        got = tfwd(*tin, *args, True, "bf16")
        want, want32 = (jfwd(*jin, *args, m, True) for m in ("bf16", "f32"))
        assert_scaled(got, want, kernel, **KERNEL_TOL)
        assert_nearer(got, want, want32, kernel)
        return
    jbwd = jcf._cfconv_sym_bwd if sym else jcf._cfconv_bwd
    tbwd = tcf.cfconv_bwd_sym if sym else tcf.cfconv_bwd
    got = tbwd(*tin[:3], torch.from_numpy(ct), *tin[3:], *args, False, "bf16")
    want, want32 = (jbwd(*jin, jnp.asarray(ct), *args, m, False)
                    for m in ("bf16", "f32"))
    for k, (a, b, b32) in enumerate(zip(got, want, want32)):
        a, b, b32 = _np(a), _np(b), _np(b32)
        if sym and k < 2:
            a, b, b32 = S._fold(a), S._fold(b), S._fold(b32)
        assert_scaled(a, b, BWD_NAMES[k], **KERNEL_TOL)
        assert_nearer(a, b, b32, BWD_NAMES[k])


def test_cfconv_bf16_plain_backward_is_the_kernel_body_not_autograd():
    """The plain bf16 backward rounds only the products' operands: autograd
    through the casts (which also rounds the cotangents) lies farther from
    the JAX kernel's VJP."""
    d, e, x, w, ct = _pair_case(16, 8, 4)
    args = (0.0, CUT, G)
    tin = [torch.from_numpy(a) for a in (d, e, x, *w)]
    body = tcf.cfconv_bwd_bf16_reference(*tin[:3], torch.from_numpy(ct),
                                         *tin[3:], *args)
    with torch.enable_grad():
        ins = [t.clone().requires_grad_(True) for t in tin]
        out = tcf.cfconv_fused_reference(*ins, *args, "bf16")
        auto = torch.autograd.grad(out, ins, torch.from_numpy(ct))
    want = jcf._cfconv_bwd(*map(jnp.asarray, (d, e, x, *w, ct)), *args,
                           "bf16", False)
    dist_body = sum(rel(a, b) for a, b in zip(body, want))
    dist_auto = sum(rel(a, b) for a, b in zip(auto, want))
    assert dist_body < 0.1 * dist_auto, (dist_body, dist_auto)


def test_cfconv_bf16_second_order_matches_jax():
    """The backward Function's own VJP (MD17's double backward): autograd
    over the plain bf16 forward, as JAX's XLA ``_cfconv_bwd_bwd`` with
    mxu='bf16'; and the CPU route's double backward reaches it."""
    d, e, x, w, ct = _pair_case(12, 11, 4)
    args = (0.0, CUT, G)
    rng = np.random.default_rng(12)
    cts = [rng.normal(size=s).astype(np.float32) for s in
           (d.shape, d.shape, x.shape, w[0].shape, w[1].shape, w[2].shape,
            w[3].shape)]
    res = tuple(map(jnp.asarray, (d, e, x, *w, ct)))
    # bf16 eager: each op rounds to its own dtype (jit's excess precision
    # may fuse some of the casts away); f32, which has no cast, jitted
    jcts = tuple(map(jnp.asarray, cts))
    want = jcf._cfconv_bwd_bwd(*args, "bf16", False, res, jcts)
    want32 = jax.jit(lambda r, c: jcf._cfconv_bwd_bwd(*args, "f32", False, r,
                                                      c))(res, jcts)
    got = tcf.cfconv_bwd_bwd(*map(torch.from_numpy, (d, e, x, ct, *w)),
                             tuple(map(torch.from_numpy, cts)), *args, "bf16")
    # JAX orders (dist, env, x, W1, b1, W2, b2, g), the port g after x
    order = (0, 1, 2, 7, 3, 4, 5, 6)
    # gradients of gradients: both sides round the cotangents at the casts,
    # in another order of ops, so a rounding flip travels further than in
    # the first order; held to the JAX package's gradient bound
    for k, j in enumerate(order):
        assert_grad(got[k], want[j], want32[j], f"second order {k}")
        assert_nearer(got[k], want[j], want32[j], f"second order {k}")
    # the CPU wrapper's double backward: the Function, then autograd
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (d, e, x, *w)]
    out = tcf.cfconv_fused(*ins, *args, False, "bf16")
    first = torch.autograd.grad(out, ins, torch.from_numpy(ct),
                                create_graph=True)
    second = torch.autograd.grad(first, ins, [torch.from_numpy(c) for c in
                                              cts])
    for k in range(7):  # (dist, env, x, W1, b1, W2, b2): JAX's order
        assert_grad(second[k], want[k], want32[k], f"double backward {k}")
        assert_nearer(second[k], want[k], want32[k], f"double backward {k}")


def test_kernel_ops_take_mxu():
    """The ops' schemas carry ``mxu`` (default 'f32'): opcheck of both ops in
    bf16 (their CPU implementations: the plain versions)."""
    g = torch.Generator().manual_seed(0)
    d = torch.rand((2, 8, 8), generator=g) * 3
    d = (d + d.transpose(1, 2)) / 2
    env = torch.rand((2, 8, 8), generator=g)
    filt = [torch.randn(s, generator=g) for s in ((3, 4), (4,), (4, 4), (4,))]
    torch.library.opcheck(_launch.OPS["cfconv_fwd"], (
        d, env, torch.randn((2, 8, 4), generator=g), *filt, 0.0, 5.0, 3,
        False, True, "bf16"))
    torch.library.opcheck(_launch.OPS["cfconv_bwd"], (
        d, env, torch.randn((2, 8, 4), generator=g),
        torch.randn((2, 8, 4), generator=g), *filt, 0.0, 5.0, 3, True,
        True, "bf16"))
    assert "str mxu=\"f32\"" in str(_launch.OPS["cfconv_fwd"]._schema)


def test_bf16_launches_count_under_their_own_names(monkeypatch):
    """On the kernel route (``on_cpu`` monkeypatched False, the launches
    replaced by plain stand-ins) a bf16 launch moves ``<kernel>_bf16`` and
    not the wrapper's count; the launch receives ``mxu``."""
    seen = []

    def fwd(*a):
        seen.append(a[-1])
        return tcf.cfconv_fused_reference(*a[:10], a[-1])

    def bwd(*a):
        seen.append(a[-1])
        return (*tcf.cfconv_bwd_reference(*a[:11], a[-1])[:3],
                torch.cat([t.reshape(-1) for t in tcf.cfconv_bwd_reference(
                    *a[:11], a[-1])[3:]]))
    monkeypatch.setattr(tcf, "on_cpu", lambda *a: False)
    monkeypatch.setattr(tcf, "_cfconv_fwd_kernel", fwd)
    monkeypatch.setattr(tcf, "_cfconv_bwd_kernel", bwd)
    d, e, x, w, ct = _pair_case(8, 2)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (d, e, x, *w)]
    _launch.reset_launch_counts()
    for sym in (False, True):
        out = tcf.cfconv(*ins, 0.0, CUT, G, symmetric=sym, mxu="bf16")
        torch.autograd.grad(out.sum(), ins)
    counts = _launch.launch_counts()
    for name in ("cfconv_fwd", "cfconv_bwd", "cfconv_fwd_sym",
                 "cfconv_bwd_sym"):
        assert counts[name] == 0 and counts[name + "_bf16"] == 1, name
    assert seen == ["bf16"] * 4


# -- the models ------------------------------------------------------------------


def _molecules(b=2, n=16, seed=7):
    z, pos, mask = S.molecules(b, n, seed, dtype=np.float32, spread=1.2)
    return z, pos, mask


def _jax_schnet_params(z, pos, mask):
    m = JSchNet(**SMALL)
    return jax.jit(m.init)(jax.random.PRNGKey(0), jnp.asarray(z),
                           jnp.asarray(pos), jnp.asarray(mask))["params"]


def _jax_out_and_grads(module, params, z, pos, mask):
    """(graph, node, d sum(node^2)/d params) of the JAX module, jitted."""
    def loss(p):
        g, h = module.apply({"params": p}, z, pos, mask)
        return jnp.sum(h.astype(jnp.float32) ** 2), (g, h)

    (_, (g, h)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return g, h, grads


def _port_out_and_grads(model, z, pos, mask, to_port):
    g, h = model(torch.from_numpy(z).long(), torch.from_numpy(pos),
                 torch.from_numpy(mask))
    grads = torch.autograd.grad(torch.sum(h.float() ** 2),
                                list(model.parameters()), allow_unused=True)
    named = {k: gr for (k, _), gr in zip(model.named_parameters(), grads)}
    return g, h, named


@pytest.mark.parametrize("mode", ["filter_mxu", "compute_dtype"])
def test_schnet_bf16_matches_jax(mode):
    """SchNet's outputs and every parameter gradient in each bf16 mode
    against the JAX model in the same mode (Pallas in interpret mode)."""
    z, pos, mask = _molecules()
    params = _jax_schnet_params(z, pos, mask)
    jkw = ({"filter_mxu": "bf16"} if mode == "filter_mxu"
           else {"dtype": jnp.bfloat16})
    tkw = ({"filter_mxu": "bf16"} if mode == "filter_mxu"
           else {"dtype": torch.bfloat16})
    jz, jpos, jmask = jnp.asarray(z), jnp.asarray(pos), jnp.asarray(mask)
    jg, jh, jgr = _jax_out_and_grads(JSchNet(**SMALL, use_pallas=True, **jkw),
                                     params, jz, jpos, jmask)
    # f32: the XLA path (within f32 rounding of the kernels'; it compiles
    # faster)
    jg32, jh32, jgr32 = _jax_out_and_grads(JSchNet(**SMALL), params, jz,
                                           jpos, jmask)
    model = tschnet.SchNet(**SMALL, **tkw)
    model.load_state_dict(schnet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    g, h, grads = _port_out_and_grads(model, z, pos, mask, None)
    assert g.dtype == h.dtype == torch.float32
    tol = MODEL_TOL[mode]
    for what, a, b, b32 in (("graph", g, jg, jg32), ("node", h, jh, jh32)):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=what, **tol)
        assert_nearer(a, b, b32, what)
    want = schnet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jgr))
    want32 = schnet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jgr32))
    port_all = np.concatenate([_np(grads[k]).ravel() for k in want])
    jax_all = np.concatenate([_np(want[k]).ravel() for k in want])
    jax32_all = np.concatenate([_np(want32[k]).ravel() for k in want])
    for k in want:
        assert_grad(grads[k], want[k], want32[k], k)
    assert_nearer(port_all, jax_all, jax32_all, "gradients")


def test_painn_compute_dtype_matches_jax():
    """PaiNN in compute_dtype bf16 (only the dense layers; the message pass
    in f32) against the JAX model with use_pallas (interpret mode)."""
    z, pos, mask = _molecules(seed=9)
    jz, jpos, jmask = jnp.asarray(z), jnp.asarray(pos), jnp.asarray(mask)
    params = jax.jit(JPaiNN(**PSMALL).init)(jax.random.PRNGKey(1), jz, jpos,
                                            jmask)["params"]
    jg, jh, jgr = _jax_out_and_grads(
        JPaiNN(**PSMALL, use_pallas=True, dtype=jnp.bfloat16), params, jz,
        jpos, jmask)
    jg32, jh32, jgr32 = _jax_out_and_grads(JPaiNN(**PSMALL), params, jz,
                                           jpos, jmask)
    model = tpainn.PaiNN(**PSMALL, dtype=torch.bfloat16)
    model.load_state_dict(painn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params), 2))
    g, h, grads = _port_out_and_grads(model, z, pos, mask, None)
    assert g.dtype == h.dtype == torch.float32
    tol = MODEL_TOL["compute_dtype"]
    for what, a, b, b32 in (("graph", g, jg, jg32), ("node", h, jh, jh32)):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=what, **tol)
        assert_nearer(a, b, b32, what)
    want = painn_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgr),
                                      2)
    want32 = painn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jgr32), 2)
    for k in want:
        if k == "embedding.weight":  # row 0 is gated: compare the rest
            grads[k], want[k], want32[k] = (t[1:] for t in (
                grads[k], torch.as_tensor(want[k]), torch.as_tensor(
                    want32[k])))
        assert_grad(grads[k], want[k], want32[k], k)
    port_all = np.concatenate([_np(grads[k]).ravel() for k in want])
    assert_nearer(port_all, np.concatenate([_np(want[k]).ravel()
                                            for k in want]),
                  np.concatenate([_np(want32[k]).ravel() for k in want]),
                  "gradients")


def test_ddm_schnet_step_loss_and_gradients_match_jax():
    """A DDM-SchNet loss under --compute_dtype bfloat16 (the NCSN heads see
    the backbone's output cast to f32), its value and every gradient
    against the JAX loss with the same weights and draws."""
    z, pos, mask = _molecules(b=3, seed=21)
    gm = mask.any(axis=1)
    n = pos.shape[1]
    sel = mask[:, :, None] & mask[:, None, :] & np.triu(np.ones((n, n), bool),
                                                         1)
    rng = np.random.default_rng(100)
    pos2 = (pos + rng.normal(scale=0.3, size=pos.shape)).astype(np.float32)
    draws = []
    for _ in range(2):
        draws += [rng.uniform(0.01, 10.0, size=3).astype(np.float32),
                  rng.normal(size=(3, n, n)).astype(np.float32)]
    head = JNCSNv3(emb_dim=F)
    k = jax.random.split(jax.random.PRNGKey(3), 3)
    params = {"model": _jax_schnet_params(z, pos, mask)}
    h0 = jnp.zeros((3, n, F))
    for name, key in (("NCSN_01", k[1]), ("NCSN_02", k[2])):
        params[name] = jax.jit(head.init)(key, key, h0, jnp.ones((3, n, n)),
                                          jnp.asarray(sel))["params"]

    def jax_loss(p, dtype):
        # bf16 through the Pallas kernels, f32 through the XLA path
        jm = JSchNet(**SMALL, use_pallas=dtype is not None, dtype=dtype)
        xx, mm = jnp.asarray(pos), jnp.asarray(mask)
        d1, _ = jgeo.pairwise_distances(xx, mm)
        _, h1 = jm.apply({"params": p["model"]}, jnp.asarray(z), xx, mm)
        _, h2 = jm.apply({"params": p["model"]}, jnp.asarray(z),
                         jnp.asarray(pos2), mm)
        d2, _ = jgeo.pairwise_distances(jnp.asarray(pos2), mm)
        s1, n1, s2, n2 = map(jnp.asarray, draws)
        ss, gg = jnp.asarray(sel), jnp.asarray(gm)
        l1 = head.apply({"params": p["NCSN_01"]}, None, h1, d2, ss, gg,
                        sigmas=s1, noise=n1)
        l2 = head.apply({"params": p["NCSN_02"]}, None, h2, d1, ss, gg,
                        sigmas=s2, noise=n2)
        return (l1 + l2) / 2

    (want, jgr), (want32, jgr32) = (
        jax.jit(jax.value_and_grad(lambda p, dt=dt: jax_loss(p, dt)))(params)
        for dt in (jnp.bfloat16, None))
    ddm = PG.DDM(tschnet.SchNet(**SMALL, dtype=torch.bfloat16),
                 NCSNv3(emb_dim=F), NCSNv3(emb_dim=F))
    ddm.model.load_state_dict(schnet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params["model"])))
    for name in ("NCSN_01", "NCSN_02"):
        getattr(ddm, name).load_state_dict(ncsn_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, params[name])))
    batch = DenseMolBatch(atom_type=torch.from_numpy(z).long(),
                          positions=torch.from_numpy(pos),
                          node_mask=torch.from_numpy(mask),
                          graph_mask=torch.from_numpy(gm))
    loss = ddm(batch, torch.from_numpy(pos2), torch.from_numpy(sel),
               tuple(torch.from_numpy(a) for a in draws))
    np.testing.assert_allclose(loss.item(), float(want),
                               **MODEL_TOL["compute_dtype"])
    assert abs(loss.item() - float(want)) < abs(float(want) - float(want32))
    grads = dict(zip((k for k, _ in ddm.named_parameters()),
                     torch.autograd.grad(loss, list(ddm.parameters()),
                                         allow_unused=True)))

    def as_port(tree):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        sd = {f"model.{k}": v for k, v in
              schnet_state_dict_from_flax(tree["model"]).items()}
        for name in ("NCSN_01", "NCSN_02"):
            sd.update({f"{name}.{k}": v for k, v in
                       ncsn_state_dict_from_flax(tree[name]).items()})
        return sd

    w16, w32 = as_port(jgr), as_port(jgr32)
    for k in w16:
        assert_grad(grads[k], w16[k], w32[k], k)
    assert_nearer(np.concatenate([_np(grads[k]).ravel() for k in w16]),
                  np.concatenate([_np(w16[k]).ravel() for k in w16]),
                  np.concatenate([_np(w32[k]).ravel() for k in w16]),
                  "gradients")


# -- serving, the stacks, the CLI -----------------------------------------------


_SERVE_SMALL = dict(num_filters=F, num_interactions=2, num_gaussians=G)


def _serve_case():
    """(JAX params, port state, store, Predictor kwargs, the f32 JAX
    Predictor's predictions), made once."""
    from tests.test_torch_port_serve import _store

    if not hasattr(_serve_case, "cached"):
        jcfg = JModelConfig(emb_dim=F, schnet=JSchNetConfig(**_SERVE_SMALL))
        module, _ = jcommon.make_backbone(jcfg)
        rng = jax.random.PRNGKey(2)
        params = {"model": jcommon.init_backbone(module, rng, n_max=64),
                  "graph_pred_linear": jcommon.LinearHead().init(
                      rng, jnp.zeros((2, F)))["params"]}
        state = {"model": schnet_state_dict_from_flax(params["model"]),
                 "graph_pred_linear": head_state_dict_from_flax(
                     params["graph_pred_linear"])}
        store = _store(6, 3, 30, seed=4)
        pkw = dict(y_mean=0.5, y_std=2.0, batch_size=4, bucket_sizes=(32,))
        want32 = JPredictor(jcfg, params, **pkw).predict(store)
        _serve_case.cached = (params, state, store, pkw, want32)
    return _serve_case.cached


@pytest.mark.parametrize("mode", ["filter_mxu", "compute_dtype"])
def test_bf16_predictor_takes_the_per_block_route_and_matches_jax(mode):
    """A bf16 Predictor never routes a bucket to the stack (as JAX serving
    routes bf16 away from it) and predicts what the JAX Predictor predicts
    on the same weights."""
    params, state, store, pkw, want32 = _serve_case()
    kw = {mode: "bf16" if mode == "filter_mxu" else "bfloat16"}
    jcfg = JModelConfig(emb_dim=F, schnet=JSchNetConfig(**_SERVE_SMALL), **kw)
    tcfg = ModelConfig(emb_dim=F, schnet=SchNetConfig(**_SERVE_SMALL), **kw)
    tpred = Predictor(tcfg, state, device="cpu", **pkw)
    assert not any(tpred.stack_route(n) for n in tpred.bucket_sizes)
    got = tpred.predict(store)
    want = JPredictor(jcfg, params, **pkw).predict(store)
    np.testing.assert_allclose(got, want, **MODEL_TOL[mode])
    assert_nearer(got, want, want32, "predict")


def test_stacks_refuse_bf16():
    z, pos, mask = (torch.from_numpy(a) for a in _molecules())
    for model in (tschnet.SchNet(**SMALL, dtype=torch.bfloat16),
                  tschnet.SchNet(**SMALL, filter_mxu="bf16")):
        with pytest.raises(ValueError, match="default config only"):
            tschnet.fused_stack_apply(model, z.long(), pos, mask)
    pm = tpainn.PaiNN(**PSMALL, dtype=torch.bfloat16)
    for fn in (tpainn.fused_stack_apply, tpainn.stack_train_apply):
        with pytest.raises(ValueError, match="no compute dtype"):
            fn(pm, z.long(), pos, mask)
    with pytest.raises(ValueError, match="no bf16 instance"):
        tcf.schnet_stack(torch.zeros(1, 8, 8), torch.zeros(1, 8, 8),
                         torch.zeros(1, 8, F), [], 0.0, CUT, G, mxu="bf16")
    with pytest.raises(ValueError, match="mxu must be"):
        tcf.cfconv_fused_reference(*(torch.zeros(1, 8, 8),) * 2,
                                   torch.zeros(1, 8, F), None, None, None,
                                   None, 0.0, CUT, G, "fp8")


@pytest.mark.parametrize("flags", [["--filter_mxu", "bf16"],
                                   ["--compute_dtype", "bfloat16"]])
def test_cli_takes_the_bf16_flags(tmp_path, flags, capsys):
    """One DDM-SchNet step through the driver on the CPU, in each mode; its
    model.pth serves through a Predictor built with the same flag. A QM9
    fine-tune step takes the flag through train/common, and ``serve`` on a
    published-width checkpoint in the mode."""
    out = tmp_path / "run"
    ddm, losses = PG.main([
        "--synthetic", "--synthetic_size", "8", "--epochs", "1",
        "--batch_size", "8", "--emb_dim", "16", "--num_filters", "16",
        "--num_interactions", "2", "--num_gaussians", "8", "--device", "cpu",
        "--output_model_dir", str(out), *flags])
    assert len(losses) == 1 and np.isfinite(losses).all()
    key, value = flags[0][2:], flags[1]
    assert getattr(ddm.model, "mxu") == "bf16"
    assert (ddm.model.dtype is torch.bfloat16) == (key == "compute_dtype")
    cfg = ModelConfig(emb_dim=16, schnet=SchNetConfig(
        num_filters=16, num_interactions=2, num_gaussians=8), **{key: value})
    state = torch.load(out / "model.pth", weights_only=False)
    pred = Predictor(cfg, state, device="cpu", batch_size=4,
                     bucket_sizes=(32,))
    from geossl_tpu_torch import serve
    from geossl_tpu_torch.train import finetune_qm9 as FQ
    from geossl_tpu_torch.train.common import make_backbone, make_head
    from tests.test_torch_port_serve import _store

    store = _store(3, 3, 20, seed=1)
    assert np.isfinite(pred.embed(store)).all()
    net, best, _, losses = FQ.main([
        "--device", "cpu", "--synthetic", "--synthetic_size", "24",
        "--epochs", "1", "--emb_dim", "16", "--num_filters", "16",
        "--num_interactions", "2", "--num_gaussians", "8", "--batch_size",
        "8", "--output_model_dir", str(tmp_path / "qm9"), *flags])
    assert losses and np.isfinite(losses).all() and np.isfinite(best)
    assert net.model.mxu == "bf16"
    cfg = ModelConfig(**{key: value})
    gen = torch.Generator().manual_seed(0)
    ckpt = str(tmp_path / "full.pth")
    torch.save({"model": make_backbone(cfg, gen).state_dict(),
                "graph_pred_linear": make_head("schnet", 128,
                                               gen).state_dict()}, ckpt)
    npz = str(tmp_path / "mols.npz")
    store.save(npz)
    capsys.readouterr()
    serve.main(["--ckpt", ckpt, "--input", npz, "--device", "cpu",
                "--batch_size", "2", *flags])
    rows = [line.split(",") for line in capsys.readouterr().out.splitlines()]
    assert [r[0] for r in rows] == ["0", "1", "2"]
    assert np.isfinite([float(r[1]) for r in rows]).all()


def test_flops_bound_basis_for_the_bf16_rows():
    """The bf16 rows' products are bounded at the H100's bf16 tensor-core
    peak, the f32 rows' at the TF32 peak (one pass of 3xTF32)."""
    from geossl_tpu_torch.utils import flops

    assert flops.bound_basis("bf16") == (989e12, "bf16_tensor_core+f32")
    assert flops.bound_basis() == (flops.H100_PEAK_TF32,
                                   "tf32_tensor_core+f32")
    with pytest.raises(ValueError):
        flops.bound_basis("fp8")
