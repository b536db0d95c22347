"""PaiNN at any width and any RBF count on the CPU: the message-pass
kernels' zero padding and column blocks (``ops/painn.message_blocks_fwd`` /
``message_blocks_bwd``, #8-#11), the stack's padding (#12) and the
streamed filter product's chunks (R above ``ops/painn.ONE_PASS_R``).

* The real launch functions (``_launch_painn_fwd``, ``_launch_painn_bwd``,
  ``_launch_painn_stack``) with plain stand-ins monkeypatched in for the
  ctypes launches (``_painn_fwd_kernel``, ``_painn_bwd_kernel``,
  ``_painn_stack_kernel``), ``KERNEL_F`` monkeypatched to 16: F = 40 runs
  3 column blocks, F = 12 one padded launch, F = 16 passes straight. Both
  modes against the full-width plain versions in f64 at rtol 1e-12, every
  stand-in call at the kernel's width, k calls (and k counted launches)
  per call, the pair cotangents the block-order sum of the calls'.
* The stack padded (F = 40 into 128, inference and ``save_residuals``)
  against the plain stack at F = 40, and its launch refusing F above
  ``KERNEL_F``, naming F.
* A float64 emulation of the streamed filter product at R = 33 and 64
  (and the chunk layout at more R): each chunk's share of the filter and
  of the backward's dphi, dWk and dbk, the bias row at the end of the last
  chunk, summed as the passes sum them, against the plain filter.
* The DDM-PaiNN slice at emb_dim = n_atom_basis = 40 and n_rbf = 40
  against the JAX package in f64: the loss, every gradient and a 4-step
  Adam trajectory at rtol 1e-10, the port through the stand-ins (3 column
  blocks of 16), the JAX model with ``use_pallas`` and its message pass
  monkeypatched to the kernels' plain reference (both sides then use the
  kernels' RBF; nothing in the JAX package changes).
* Serving's route by width: per block at every bucket above 128, the
  padded stack up to N = 128 below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geossl_tpu.ops import painn_pallas as jpp
from geossl_tpu.train import optim as joptim
from geossl_tpu_torch.ops import _launch
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.ops import painn as tpn
from geossl_tpu_torch.train import optim
from tests import test_torch_port_schnet as S
from tests import test_torch_port_train as T
from tests.test_torch_port_painn import NAMES

torch.set_num_threads(1)

BLOCK = 16  # KERNEL_F in these tests: F = 40 is 3 column blocks
CUT = 5.0
EXACT = dict(rtol=1e-12, atol=1e-12)


def assert_close(got, want, tol, what=""):
    """Elementwise, atol scaled by max|want| (at least 1)."""
    got, want = (np.asarray(t.detach()) for t in (got, want))
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * max(np.abs(want).max(), 1.0),
                               err_msg=what)


def pair_inputs(seed, f, r=12, b=2, n=12):
    """Message-pass inputs in f64 on real geometry with padding: the five
    pair grids (symmetric dist/gate, antisymmetric directions), x, mu, Wk,
    bk and the cotangents gq, gmu."""
    from geossl_tpu_torch.ops import geometry as tgeo

    _, pos, mask = S.molecules(b, n, seed, spread=1.1)
    d, direction, pm = tgeo.pairwise_directions(torch.from_numpy(pos),
                                                torch.from_numpy(mask))
    adj = tgeo.radius_adjacency(d, pm, CUT)
    gate = 0.5 * (torch.cos(d * np.pi / CUT) + 1.0) * adj.to(d.dtype)
    grids = (d, gate, *(direction[..., c].contiguous() for c in range(3)))
    rng = np.random.default_rng(seed)
    shapes = ((b, n, 3 * f), (b, n, 3 * f), (r, 3 * f), (3 * f,), (b, n, f),
              (b, n, 3 * f))
    scales = (0.4, 0.4, 0.3, 0.1, 1.0, 1.0)
    x, mu, wk, bk, gq, gmu = (torch.from_numpy(rng.normal(scale=s, size=sh))
                              for s, sh in zip(scales, shapes))
    return grids, x, mu, wk, bk, gq, gmu


class StandIns:
    """The ctypes launches of ops/painn replaced by their plain versions,
    each reporting the kernel launches the C entry makes (one a filter
    pass), recording the width each call sees and each backward call's
    pair cotangents; every wrapper takes its kernel route (``on_cpu``
    False).
    The symmetric backward's pair cotangents come back placed, as the
    kernel returns them."""

    def __init__(self, monkeypatch):
        self.widths = {}
        self.pairs = []
        monkeypatch.setattr(tpn, "on_cpu", lambda *a: False)
        monkeypatch.setattr(tpn, "KERNEL_F", BLOCK)
        for name, fn in (("_painn_fwd_kernel", self.fwd),
                         ("_painn_bwd_kernel", self.bwd),
                         ("_painn_stack_kernel", self.stack)):
            monkeypatch.setattr(tpn, name, fn)
        _launch.reset_launch_counts()

    def saw(self, name, width):
        self.widths.setdefault(name, []).append(width)

    def fwd(self, dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff, sym,
            sparse):
        self.saw("painn_fwd", x.shape[-1] // 3)
        return (*tpn.painn_message_reference(dist, gate, dirx, diry, dirz, x,
                                             mu, wk, bk, cutoff),
                len(tpn.rbf_chunks(wk.shape[0])))

    def bwd(self, dist, gate, dirx, diry, dirz, x, mu, wk, bk, gq, gmu,
            cutoff, sym, sparse):
        self.saw("painn_bwd", x.shape[-1] // 3)
        out = list(tpn.painn_bwd_reference(dist, gate, dirx, diry, dirz, x,
                                           mu, wk, bk, gq, gmu, cutoff))
        if sym:
            out[:5] = [tcf.place_sym_cotangent(c, k >= 2)
                       for k, c in enumerate(out[:5])]
        self.pairs.append(out[:5])
        return (*out[:7], _launch.flat(out[7:]),
                len(tpn.rbf_chunks(wk.shape[0])))

    def stack(self, name, pair, q0, stacked, cutoff, epsilon, residuals):
        self.saw(name, q0.shape[-1])
        return tpn.painn_stack_reference(*pair, q0, stacked, cutoff, epsilon,
                                         save_residuals=residuals)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("f", [40, 12, 16])
def test_message_launches_equal_the_full_width_plain_versions(
        monkeypatch, f, symmetric):
    """#8-#11's launch functions at F = 40 (3 blocks), 12 (padded) and 16
    (straight) against the plain versions at F, in f64 at rtol 1e-12; each
    call sees the kernel's width, k calls a direction and k counted
    launches; the pair cotangents are the calls' sum in block order."""
    stand = StandIns(monkeypatch)
    grids, x, mu, wk, bk, gq, gmu = pair_inputs(f, f)
    dq, dmu = tpn._launch_painn_fwd(*grids, x, mu, wk, bk, CUT, symmetric,
                                    False)
    want = tpn.painn_message_reference(*grids, x, mu, wk, bk, CUT)
    assert dq.shape == want[0].shape and dmu.shape == want[1].shape
    assert_close(dq, want[0], EXACT, "dq")
    assert_close(dmu, want[1], EXACT, "dmu")
    *got, wgrad = tpn._launch_painn_bwd(*grids, x, mu, wk, bk, gq, gmu, CUT,
                                        symmetric, False)
    got += tpn._split_wgrad(wgrad, wk)
    want = list(tpn.painn_bwd_reference(*grids, x, mu, wk, bk, gq, gmu, CUT))
    if symmetric:
        want[:5] = [tcf.place_sym_cotangent(c, k >= 2)
                    for k, c in enumerate(want[:5])]
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape, name
        assert_close(a, w, EXACT, name)
    k = tpn.feature_blocks(f)
    assert k == {40: 3, 12: 1, 16: 1}[f]
    assert stand.widths == {"painn_fwd": [BLOCK] * k,
                            "painn_bwd": [BLOCK] * k}
    suffix = "_sym" if symmetric else ""
    counts = _launch.launch_counts()
    assert (counts["painn_fwd" + suffix], counts["painn_bwd" + suffix]) \
        == (k, k)
    # the pair cotangents: the calls' own, summed in block order
    for j, name in enumerate(NAMES[:5]):
        total = stand.pairs[0][j]
        for part in stand.pairs[1:]:
            total = total + part[j]
        assert torch.equal(got[j], total), name


@pytest.mark.parametrize("symmetric", [False, True])
def test_wrappers_count_k_launches_and_differentiate(monkeypatch, symmetric):
    """The autograd wrappers at F = 40 through the stand-ins: the gradients
    to x, mu, Wk and bk against autograd through the plain version, 3
    forward and 3 backward launches."""
    StandIns(monkeypatch)
    grids, x, mu, wk, bk, gq, gmu = pair_inputs(5, 40)
    ins = [t.clone().requires_grad_(True) for t in (x, mu, wk, bk)]
    op = tpn.painn_message_fused_sym if symmetric else tpn.painn_message_fused
    dq, dmu = op(*grids, *ins, CUT)
    grads = torch.autograd.grad((dq, dmu), ins, (gq, gmu))
    want_ins = [t.clone().requires_grad_(True) for t in (x, mu, wk, bk)]
    wq, wmu = tpn.painn_message_reference(*grids, *want_ins, CUT)
    want = torch.autograd.grad((wq, wmu), want_ins, (gq, gmu))
    for name, a, w in zip(("dx", "dmu", "dwk", "dbk"), grads, want):
        assert_close(a, w, EXACT, name)
    suffix = "_sym" if symmetric else ""
    counts = _launch.launch_counts()
    assert (counts["painn_fwd" + suffix], counts["painn_bwd" + suffix]) \
        == (3, 3)


@pytest.mark.parametrize("num_r", [12, 40])
def test_counters_add_the_kernel_launches_each_call_reports(monkeypatch,
                                                            num_r):
    """At F = 40 (3 blocks) the counters add what each of the 3 calls a
    direction reports: one launch a call at R = 12, two (the streamed
    passes) at R = 40."""
    StandIns(monkeypatch)
    grids, x, mu, wk, bk, gq, gmu = pair_inputs(8, 40, r=num_r)
    tpn._launch_painn_fwd(*grids, x, mu, wk, bk, CUT, False, False)
    tpn._launch_painn_bwd(*grids, x, mu, wk, bk, gq, gmu, CUT, False, False)
    passes = {12: 1, 40: 2}[num_r]
    counts = _launch.launch_counts()
    assert (counts["painn_fwd"], counts["painn_bwd"]) == (3 * passes,
                                                          3 * passes)


def stack_inputs(seed, f, r=12, layers=2, b=2, n=12):
    """q0 [B,N,F] and the stack's 11 weight stacks, f64."""
    rng = np.random.default_rng(seed)
    shapes = [(f, f), (f,), (f, 3 * f), (3 * f,), (r, 3 * f), (3 * f,),
              (f, 2 * f), (2 * f, f), (f,), (f, 3 * f), (3 * f,)]
    stacked = [torch.from_numpy(rng.normal(scale=0.3, size=(layers, *s)))
               for s in shapes]
    return torch.from_numpy(rng.normal(size=(b, n, f))), stacked


@pytest.mark.parametrize("residuals", [False, True])
def test_stack_padding_equals_the_full_width_plain_stack(residuals):
    """#12 padded (F = 40 into 128): the plain stack on the padded weights,
    cut back, is the plain stack at F = 40; the padded columns stay zero
    (vn's padded entries are sqrt(eps), against zero rows of W1)."""
    grids, *_ = pair_inputs(6, 40)
    f = 40
    q0, stacked = stack_inputs(6, f)
    pq0, pst = tpn.pad_painn_stack(q0, stacked, tpn.KERNEL_F)
    assert pq0.shape[-1] == tpn.KERNEL_F
    got = tpn.painn_stack_reference(*grids, pq0, pst, CUT,
                                    save_residuals=residuals)
    want = tpn.painn_stack_reference(*grids, q0, stacked, CUT,
                                     save_residuals=residuals)
    for k, (a, w) in enumerate(zip(got, want)):
        parts = 1 if k % 2 == 0 else 3
        a = a.reshape(*a.shape[:-1], parts, tpn.KERNEL_F)
        assert not a[..., f:].any(), k
        assert_close(a[..., :f].reshape(w.shape), w, EXACT, str(k))


def test_stack_launch_pads_and_refuses_wider(monkeypatch):
    """#12 at F = 12 (KERNEL_F 16): one launch at the kernel's width, cut
    back, in both modes; above the kernel's width the launch refuses,
    naming F (serving routes per block there)."""
    stand = StandIns(monkeypatch)
    grids, *_ = pair_inputs(7, 12)
    q0, stacked = stack_inputs(7, 12)
    got = tpn.painn_stack_infer(*grids, q0, stacked, CUT)
    assert stand.widths == {"painn_stack": [BLOCK]}
    assert _launch.launch_counts()["painn_stack"] == 1
    want = tpn.painn_stack_reference(*grids, q0, stacked, CUT)
    for a, w in zip(got, want):
        assert_close(a, w, EXACT)
    got = tpn._launch_painn_stack("painn_stack_train", grids, q0, stacked,
                                  CUT, 1e-8, True)
    want = tpn.painn_stack_reference(*grids, q0, stacked, CUT,
                                     save_residuals=True)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert_close(a, w, EXACT)
    q0, stacked = stack_inputs(7, 40, layers=1)
    for name in ("painn_stack", "painn_stack_train"):
        with pytest.raises(ValueError, match=f"F <= {BLOCK}.*F=40"):
            tpn._launch_painn_stack(name, grids, q0, stacked, CUT, 1e-8,
                                    name.endswith("train"))


# -- the streamed filter product's chunks -------------------------------------------


@pytest.mark.parametrize("num_r", [2, 20, 31, 32, 33, 63, 64, 65, 100, 300])
def test_rbf_chunks_cover_the_filter_rows_once(num_r):
    """One chunk up to ONE_PASS_R; above, ceil((R+1)/32) chunks of at most
    32 K rows, contiguous, each RBF row in one chunk, the bias row at the
    end of the last only."""
    chunks = tpn.rbf_chunks(num_r)
    assert len(chunks) == (1 if num_r <= tpn.ONE_PASS_R
                           else -(-(num_r + 1) // 32))
    rows = [r for r0, n, _ in chunks for r in range(r0, r0 + n)]
    assert rows == list(range(num_r))
    assert [bias for *_, bias in chunks] == [False] * (len(chunks) - 1) + [True]
    assert all(n + bias <= 32 for _, n, bias in chunks)


@pytest.mark.parametrize("num_r", [33, 64])
def test_streamed_filter_chunks_sum_to_the_plain_filter_f64(num_r):
    """The kernels' streamed passes, emulated in f64: pass c's A rows are
    [phi rows r0..; 1 if bias] gate (the offsets read from the plain
    version's table), its B rows [Wk rows r0..; bk if bias]. Summed over
    the passes, the partial filters are the plain filter (phi Wk + bk) gate,
    the messages made from them the plain messages; the backward's dphi =
    dwg Wk^T is each chunk's own rows, ddist its sum over the chunks, dWk
    each chunk's rows of phi^T dwg and dbk the last chunk's bias row."""
    grids, x, mu, wk, bk, gq, gmu = pair_inputs(num_r, 8, r=num_r)
    dist, gate = grids[:2]
    offs = tpn.jax_linspace(CUT, num_r, torch.float64)
    delta, coeff = tpn._rbf_consts(CUT, num_r)
    phi = torch.exp(coeff * (dist[..., None] - offs) ** 2)
    plain_w = (phi @ wk + bk) * gate[..., None]
    w = torch.zeros_like(plain_w)
    dq = dmu = 0
    rng = np.random.default_rng(num_r)
    dwg = torch.from_numpy(rng.normal(size=plain_w.shape)) * gate[..., None]
    dphi, dwk, dbk = [], [], None
    for r0, rows, bias in tpn.rbf_chunks(num_r):
        a = torch.exp(coeff * (dist[..., None] - offs[r0:r0 + rows]) ** 2)
        b = wk[r0:r0 + rows]
        if bias:
            a = torch.cat([a, torch.ones_like(dist)[..., None]], -1)
            b = torch.cat([b, bk[None]])
        assert a.shape[-1] <= 32
        part = (a @ b) * gate[..., None]
        w = w + part
        q, m = _messages(part, grids, x, mu)
        dq, dmu = dq + q, dmu + m
        dphi.append(dwg @ wk[r0:r0 + rows].T)
        rows_grad = torch.einsum("bijr,bijf->rf", a, dwg)
        dwk.append(rows_grad[:rows])
        if bias:
            dbk = rows_grad[rows]
    assert_close(w, plain_w, EXACT, "filter")
    want = _messages(plain_w, grids, x, mu)
    assert_close(dq, want[0], EXACT, "dq")
    assert_close(dmu, want[1], EXACT, "dmu")
    assert_close(torch.cat(dphi, -1), dwg @ wk.T, EXACT, "dphi")
    assert_close(torch.cat(dwk), torch.einsum("bijr,bijf->rf", phi, dwg),
                 EXACT, "dWk")
    assert_close(dbk, dwg.sum((0, 1, 2)), EXACT, "dbk")
    # ddist: the chunks' sums of dphi_r phi_r 2 coeff (d - off_r), in order
    dd = sum(((dphi[c] * torch.exp(coeff * (dist[..., None] - offs[r0:r0 + n])
                                   ** 2) * 2 * coeff
               * (dist[..., None] - offs[r0:r0 + n])).sum(-1))
             for c, (r0, n, _) in enumerate(tpn.rbf_chunks(num_r)))
    assert_close(dd, ((dwg @ wk.T) * phi * 2 * coeff
                      * (dist[..., None] - offs)).sum(-1), EXACT, "ddist")


def _messages(w3, grids, x, mu):
    """(dq, dmu) of a gated filter w3 [B,N,N,3F] (the plain message sums)."""
    _, _, *dirs = grids
    f = x.shape[-1] // 3
    wq, wr, wm = w3.split(f, -1)
    xq, xr, xm = x.split(f, -1)
    dq = torch.einsum("bijf,bjf->bif", wq, xq)
    dmu = torch.cat([torch.einsum("bijf,bjf,bij->bif", wr, xr, d)
                     + torch.einsum("bijf,bjf,bjf->bif", wm, xm,
                                    mu[..., c * f:(c + 1) * f])
                     for c, d in enumerate(dirs)], -1)
    return dq, dmu


# -- the DDM-PaiNN slice at F = 40, R = 40 against the JAX package -------------------

WIDE, RBF = 40, 40


def _jax_kernel_route(monkeypatch):
    """The JAX model's message-pass kernel run by its plain reference."""
    monkeypatch.setattr(
        jpp, "painn_message",
        lambda *a, symmetric, sparse: jpp.painn_message_reference(*a))


@pytest.fixture(scope="module")
def wide_case():
    """The DDM-PaiNN case at F = R = 40 and the JAX side's results: the
    first step's loss and gradients, and a 4-step Adam trajectory (traced
    here, with the JAX kernel route monkeypatched)."""
    mp = pytest.MonkeyPatch()
    _jax_kernel_route(mp)
    try:
        case = T.ddm_jax_case("painn", emb=WIDE, kernels=True,
                              n_atom_basis=WIDE, n_rbf=RBF)
        lr, decay = 5e-3, 0.01
        steps = [T._step_inputs(case["pos"], case["mask"], s)
                 for s in range(4)]
        with S.x64():
            arrays = tuple(map(jnp.asarray, case["arrays"]))
            vg = case["jax_value_and_grad"]
            tx = joptim.make_optimizer(lr, 2, 2, decay, "CosineAnnealingLR")
            params = jax.tree_util.tree_map(jnp.asarray, case["params"])
            opt_state = tx.init(params)

            @jax.jit
            def adam(g, opt_state, params):
                updates, opt_state = tx.update(g, opt_state, params)
                return optax.apply_updates(params, updates), opt_state

            losses = []
            for s, (pos2, draws) in enumerate(steps):
                loss, g = vg(params, *arrays, jnp.asarray(pos2),
                             tuple(map(jnp.asarray, draws)))
                if s == 0:
                    case["first"] = (float(loss), jax.tree_util.tree_map(
                        np.asarray, g))
                params, opt_state = adam(g, opt_state, params)
                losses.append(float(loss))
            case["trajectory"] = (losses, jax.tree_util.tree_map(np.asarray,
                                                                 params))
        case.update(steps=steps, lr=lr, decay=decay)
    finally:
        mp.undo()
    return case


def test_ddm_painn_at_width_40_rbf_40_matches_jax_f64(wide_case, monkeypatch):
    """The loss and every gradient, the port through the stand-ins: the
    message pass in 3 column blocks of 16 (3 calls each way, each making 2
    launches: the streamed passes at R = 40)."""
    case = wide_case
    pos2, draws = case["steps"][0]
    want, jgrad = case["first"]
    ddm = case["port"]()
    stand = StandIns(monkeypatch)
    loss = T._port_loss(ddm, case, pos2, draws)
    loss.backward()
    assert set(stand.widths["painn_fwd"]) == {BLOCK}
    counts = _launch.launch_counts()
    # 2 views x 2 blocks, 3 calls each, 2 passes a call
    assert counts["painn_fwd"] == counts["painn_bwd"] == 2 * 2 * 3 * 2
    np.testing.assert_allclose(loss.item(), want, rtol=1e-10)
    grads = T._as_port_state(jgrad, case["to_port"])
    named = dict(ddm.named_parameters())
    assert sorted(named) == sorted(grads)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def test_ddm_painn_at_width_40_adam_trajectory_matches_jax_f64(
        wide_case, monkeypatch):
    """4 Adam steps (as ``test_torch_port_train``'s trajectory) through the
    stand-ins."""
    case = wide_case
    want, final = case["trajectory"]
    ddm = case["port"]()
    StandIns(monkeypatch)
    opt, sched = optim.make_optimizer(ddm.parameters(), case["lr"], 2, 2,
                                      case["decay"], "CosineAnnealingLR")
    got = []
    for pos2, draws in case["steps"]:
        opt.zero_grad()
        loss = T._port_loss(ddm, case, pos2, draws)
        loss.backward()
        opt.step()
        sched.step()
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-10)
    final = T._as_port_state(final, case["to_port"])
    for name, p in ddm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


# -- serving's route and the startup limits -----------------------------------------


@pytest.mark.parametrize("width,stacked", [(192, False), (96, True),
                                           (128, True)])
def test_predictor_routes_by_the_stack_width(width, stacked):
    """A PaiNN Predictor serves through the stack up to F = 128 (padded)
    and through the per-block kernels' column blocks above it; neither is
    refused at startup on CUDA, at any RBF count."""
    from geossl_tpu_torch.config import ModelConfig, PaiNNConfig
    from geossl_tpu_torch.serve import Predictor
    from geossl_tpu_torch.train import common

    cfg = ModelConfig(model_3d="painn", emb_dim=width, painn=PaiNNConfig(
        n_atom_basis=width, n_interactions=1, n_rbf=40))
    state = {"model": common.make_backbone(cfg).state_dict()}
    pred = Predictor(cfg, state, device="cpu", bucket_sizes=(32, 128, 256))
    assert [pred.stack_route(n) for n in (32, 128, 256)] == \
        [stacked, stacked, False]
    routes = [pred.stack_route(n) for n in pred.bucket_sizes]
    assert common.kernel_limit_errors(cfg, backward=True,
                                      per_block=not all(routes),
                                      stack=any(routes), ncsn=True) == []


def test_streamed_probe_copy_routes_every_r_through_the_streamed_instances(
        tmp_path):
    """``utils/probe_streamed.py`` writes a copy of the package whose PaiNN
    launches take the streamed instances at every R: each of its edits
    applies once, and the copy's ``_rbf_offsets`` returns the offsets at
    R = 20 (the one-pass instances are never chosen)."""
    import importlib.util

    from geossl_tpu_torch.utils import probe_streamed

    probe_streamed.write_copy(str(tmp_path))
    for name, text, new in probe_streamed.EDITS:
        src = (tmp_path / "geossl_tpu_torch" / name).read_text()
        assert text not in src and new in src, name
    spec = importlib.util.spec_from_file_location(
        "streamed_painn", tmp_path / "geossl_tpu_torch" / "ops" / "painn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert torch.equal(mod._rbf_offsets(CUT, 20, "cpu"),
                       tpn.jax_linspace(CUT, 20, torch.float32, "cpu"))
    assert tpn._rbf_offsets(CUT, 20, "cpu") is None


def test_sass_probe_masks_constants_and_counts_opcodes():
    """``utils/probe_sass.py`` on ``cuobjdump -sass`` text: instructions
    per function with their constants masked (two builds that differ only
    in constant-bank offsets compare equal), and per-opcode differences."""
    from geossl_tpu_torch.utils import probe_sass

    def dump(offset, extra=""):
        return (
            "\t\tFunction : _ZN6geossl1kILi3EEEv\n"
            f"        /*0000*/                   LDC R1, c[0x0][{offset}] ;"
            "                /* 0x00000a00ff017b82 */\n"
            "        /*0010*/                   S2R R0, SR_TID.X ;\n"
            f"{extra}"
            "        /*0020*/              @!P0 EXIT ;\n"
            "\t\tFunction : _ZN6geossl5otherEv\n"
            "        /*0000*/                   NOP ;\n")

    a = probe_sass.functions(dump("0x28"))
    b = probe_sass.functions(dump("0x30"))
    assert sorted(a) == ["_ZN6geossl1kILi3EEEv", "_ZN6geossl5otherEv"]
    assert a["_ZN6geossl1kILi3EEEv"] == ["LDC R1, c[X][X]", "S2R R0, SR_TID.X",
                                         "@!P0 EXIT"]
    same = probe_sass.compare(a["_ZN6geossl1kILi3EEEv"],
                              b["_ZN6geossl1kILi3EEEv"])
    assert same == {"instructions": (3, 3), "opcode_deltas": {}, "diff": []}
    c = probe_sass.functions(dump(
        "0x28", "        /*0018*/                   NOP ;\n"))
    more = probe_sass.compare(a["_ZN6geossl1kILi3EEEv"],
                              c["_ZN6geossl1kILi3EEEv"])
    assert more["instructions"] == (3, 4)
    assert more["opcode_deltas"] == {"NOP": 1} and more["diff"] == ["+NOP"]
