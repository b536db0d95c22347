"""SchNet and the DDM head at any width on the CPU: the CFConv kernels'
zero padding and column blocks (``ops/cfconv.filter_blocks_fwd`` /
``filter_blocks_bwd``, #1-#4), the stack's padding (#5) and the NCSN head's
padding into its 128 and 256 instances (#6/#7).

* The helpers, with the plain versions as the per-block callable, against
  the plain version at the full width in f64 at rtol 1e-12, in f32 and in
  bf16 (each forward block rounds the same operands as the full width).
  The bf16 backward is not split into (i, o) blocks: a block would round
  its own partial dh to bf16 where the full width rounds their sum; above
  the kernels' width it runs its hidden-block instance (one launch per
  hidden block, dh summed over the output blocks before it is rounded),
  here through that instance's plain version. ``KERNEL_F`` is
  monkeypatched to 16, so F = 40 runs 3 blocks and 9 calls (3 for the
  bf16 backward).
* The bf16 launches against the JAX package's bf16 kernels
  (``test_torch_port_bf16``'s criterion): the forwards in column blocks
  and padded, the backwards padded and in hidden blocks.
* The real launch functions with plain stand-ins monkeypatched in for the
  ctypes launches (``_cfconv_fwd_kernel``, ``_cfconv_bwd_kernel``,
  ``_schnet_stack_kernel``, ``_ncsn_fwd_kernel``, ``_ncsn_bwd_kernel``):
  every stand-in call sees the kernel's width, a CFConv call makes k^2 of
  them (and counts k^2 launches), db2 is not counted k times.
* The DDM-SchNet slice at emb_dim = num_filters = 40 against the JAX
  package in f64: the loss, every gradient and a 4-step Adam trajectory at
  rtol 1e-10, the port through the stand-ins (the CFConv in 3 column
  blocks of 16, the head padded into the 128 instance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geossl_tpu.ops import cfconv_pallas as jcf
from geossl_tpu.train import optim as joptim
from geossl_tpu_torch.ops import _launch
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.ops import ncsn as tns
from geossl_tpu_torch.train import optim
from tests import test_torch_port_bf16 as B
from tests import test_torch_port_schnet as S
from tests import test_torch_port_train as T

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


def pair_grid(seed, b=2, n=12, symmetric=True):
    """dist/env [B,N,N] in f64 (symmetric, or a max_neighbors-like graph
    with one cut direction)."""
    z, pos, mask = S.molecules(b, n, seed, spread=1.1)
    pos = torch.from_numpy(pos)
    mask = torch.from_numpy(mask)
    d = torch.cdist(pos, pos)
    pm = mask[:, :, None] & mask[:, None, :] & ~torch.eye(n, dtype=bool)
    env = torch.where(pm & (d < CUT), 0.5 * (torch.cos(d * np.pi / CUT) + 1),
                      torch.zeros_like(d))
    if not symmetric:
        env = env * (torch.rand(env.shape, generator=torch.Generator()
                                .manual_seed(seed)) > 0.3)
    return d.contiguous(), env.contiguous()


def filter_weights(seed, f, g):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(scale=s, size=shape)) for s, shape in
            ((0.4, (g, f)), (0.1, (f,)), (0.3, (f, f)), (0.1, (f,)))]


@pytest.fixture
def block16(monkeypatch):
    monkeypatch.setattr(tcf, "KERNEL_F", BLOCK)


# -- the helpers against the full-width plain version -----------------------------


@pytest.mark.parametrize("mxu", ["f32", "bf16"])
@pytest.mark.parametrize("g", [51, 65])
@pytest.mark.parametrize("f", [40, 12])
def test_filter_blocks_equal_the_full_width_plain_version(block16,
                                                          monkeypatch, f, g,
                                                          mxu):
    """#1/#3's forward and #2/#4's backward (the plain and the symmetric
    backward's plain versions are one function: the true cotangents)
    through the helpers, F = 40 (3 blocks) and F = 12 (padded to 16). In
    bf16 the forward's blocks round the same operands as the full width;
    the backward's (i, o) blocks would round their partial dh, so above
    the kernels' width the bf16 backward launch runs its hidden-block
    instance (here its plain version, 3 calls' worth of launches), which
    rounds the same operands as the full width: the symmetric launch's
    placed cotangents and weight gradients equal the full-width plain
    version's."""
    d, env = pair_grid(seed=f + g)
    rng = np.random.default_rng(g)
    x = torch.from_numpy(rng.normal(size=(2, 12, f)))
    gr = torch.from_numpy(rng.normal(size=(2, 12, f)))
    fw = filter_weights(f, f, g)
    args = (0.0, CUT, g)
    calls = []

    def fwd(*xw):
        calls.append(xw[0].shape[-1])
        return tcf.cfconv_fused_reference(d, env, *xw, *args, mxu)

    def bwd(*xw):
        calls.append(xw[0].shape[-1])
        return tcf.cfconv_bwd_reference(d, env, *xw[:2], *xw[2:], *args, mxu)

    got = tcf.filter_blocks_fwd(fwd, x, *fw)
    assert_close(got, tcf.cfconv_fused_reference(d, env, x, *fw, *args, mxu),
                 EXACT, "m")
    k = -(-f // BLOCK)
    if mxu == "bf16" and k > 1:
        monkeypatch.setattr(tcf, "_cfconv_bwd_bf16w_kernel",
                            tcf._cfconv_bwd_bf16w_plain)
        _launch.reset_launch_counts()
        *got, wgrad = tcf._launch_cfconv_bwd(d, env, x, gr, *fw, *args, True,
                                             False, mxu)
        got += tcf._split_wgrad(wgrad, g, f)
        want = list(tcf.cfconv_bwd_reference(d, env, x, gr, *fw, *args, mxu))
        want[:2] = [tcf.place_sym_cotangent(c) for c in want[:2]]
        for name, a, w in zip(("ddist", "denv", "dx", "dW1", "db1", "dW2",
                               "db2"), got, want):
            assert a.shape == w.shape, name
            assert_close(a, w, EXACT, name)
        assert _launch.launch_counts()["cfconv_bwd_sym_bf16w"] == k
        assert calls == [BLOCK] * (k * k)
        return
    got = tcf.filter_blocks_bwd(bwd, x, gr, *fw)
    want = tcf.cfconv_bwd_reference(d, env, x, gr, *fw, *args, mxu)
    for name, a, w in zip(("ddist", "denv", "dx", "dW1", "db1", "dW2", "db2"),
                          got, want):
        assert a.shape == w.shape, name
        assert_close(a, w, EXACT, name)
    assert calls == [BLOCK] * (2 * k * k)


def stack_inputs(seed, f, g=20, layers=2):
    """h0 [2,12,F] and the stack's nine weight stacks, f64."""
    rng = np.random.default_rng(seed)
    shapes = [(f, f), (g, f), (f,), (f, f), (f,), (f, f), (f,), (f, f), (f,)]
    stacked = [torch.from_numpy(rng.normal(scale=0.3, size=(layers, *s)))
               for s in shapes]
    return torch.from_numpy(rng.normal(size=(2, 12, f))), stacked


def test_stack_padding_equals_the_full_width_plain_stack():
    """#5 padded (F = 40 into 128): the plain stack on the padded weights,
    cut back, is the plain stack at F = 40."""
    d, env = pair_grid(seed=5)
    f, g = 40, 20
    h0, stacked = stack_inputs(5, f, g)
    ph0, pst = tcf.pad_stack(h0, stacked, tcf.KERNEL_F)
    assert ph0.shape[-1] == tcf.KERNEL_F
    got = tcf.schnet_stack_reference(d, env, ph0, pst, 0.0, CUT, g)
    assert not got[..., f:].any()
    assert_close(got[..., :f],
                 tcf.schnet_stack_reference(d, env, h0, stacked, 0.0, CUT, g),
                 EXACT)


def head_inputs(seed, emb, b=2, n=12):
    rng = np.random.default_rng(seed)
    d, _ = pair_grid(seed, b, n)
    noise = torch.from_numpy(rng.normal(size=(b, n, n)))
    sel = torch.from_numpy(np.triu(np.ones((n, n)), 1)[None].repeat(b, 0))
    sigma = torch.from_numpy(rng.uniform(0.05, 2.0, size=b))
    u = torch.from_numpy(rng.normal(size=(b, n, emb)))
    weights = [torch.from_numpy(rng.normal(scale=0.3, size=s))
               for s in tns.weight_shapes(emb)]
    g_rows = torch.from_numpy(rng.normal(size=(b, n)))
    return (d, noise, sel, sigma, u), weights, g_rows


@pytest.mark.parametrize("emb", [41, 96, 131])
def test_head_padding_equals_the_full_width_plain_head(emb):
    """#6/#7 padded to their instance (odd E: H = E // 2): the row sums, du
    and the ten weight gradients of the padded plain head, cut back, are
    the plain head's at E."""
    grid, weights, g_rows = head_inputs(emb, emb)
    width = tns.instance_width(emb)
    assert width == (128 if emb <= 128 else 256)
    pu, pw = tns.pad_head(grid[4], weights, width)
    assert [tuple(w.shape) for w in pw] == list(tns.weight_shapes(width))
    rows = tns.ncsn_score_loss_reference(*grid[:4], pu, *pw, 2.0)
    assert_close(rows, tns.ncsn_score_loss_reference(*grid, *weights, 2.0),
                 EXACT, "rows")
    du, *grads = tns.ncsn_score_bwd_reference(*grid[:4], pu, g_rows, *pw,
                                              anneal=2.0)
    wgrad = tns.unpad_wgrad(_launch.flat(grads), emb, width)
    want = tns.ncsn_score_bwd_reference(*grid, g_rows, *weights, anneal=2.0)
    assert_close(du[..., :emb], want[0], EXACT, "du")
    assert_close(wgrad, _launch.flat(want[1:]), EXACT, "weight gradients")


def test_head_width_limit():
    """No head width is refused: up to 256 the fixed instances, above it
    the streamed one at the next multiple of its chunk."""
    got = [tns.instance_width(e) for e in (1, 128, 129, 256, 257, 300, 384,
                                           385, 512, 1000)]
    assert got == [128, 128, 256, 256, 384, 384, 384, 512, 512, 1024]
    assert [tns.streamed(w) for w in (128, 256, 384)] == [False, False, True]


# -- the real launch functions with plain stand-ins ---------------------------------


class StandIns:
    """The ctypes launches of ops/cfconv and ops/ncsn replaced by their plain
    versions, recording the width each call sees; every wrapper takes its
    kernel route (``on_cpu`` False). The symmetric backward's pair
    cotangents come back placed, as the kernel returns them."""

    def __init__(self, monkeypatch):
        self.widths = {}
        for mod in (tcf, tns):
            monkeypatch.setattr(mod, "on_cpu", lambda *a: False)
        for name, fn in (("_cfconv_fwd_kernel", self.cf_fwd),
                         ("_cfconv_bwd_kernel", self.cf_bwd),
                         ("_cfconv_bwd_bf16w_kernel", self.cf_bwd_bf16w),
                         ("_schnet_stack_kernel", self.stack),
                         ("_ncsn_fwd_kernel", self.ncsn_fwd),
                         ("_ncsn_bwd_kernel", self.ncsn_bwd),
                         ("_ncsn_wide_fwd_kernel", self.ncsn_wide_fwd),
                         ("_ncsn_wide_bwd_kernel", self.ncsn_wide_bwd)):
            mod = tns if name.startswith("_ncsn") else tcf
            monkeypatch.setattr(mod, name, fn)
        _launch.reset_launch_counts()

    def saw(self, name, width):
        self.widths.setdefault(name, []).append(width)

    def cf_fwd(self, dist, env, x, w1, b1, w2, b2, start, stop, num_g, sym,
               sparse, mxu):
        self.saw("cfconv_fwd", x.shape[-1])
        return tcf.cfconv_fused_reference(dist, env, x, w1, b1, w2, b2, start,
                                          stop, num_g, mxu)

    def cf_bwd(self, dist, env, x, g, w1, b1, w2, b2, start, stop, num_g, sym,
               sparse, mxu):
        self.saw("cfconv_bwd", x.shape[-1])
        out = list(tcf.cfconv_bwd_reference(dist, env, x, g, w1, b1, w2, b2,
                                            start, stop, num_g, mxu))
        if sym:
            out[:2] = [tcf.place_sym_cotangent(c) for c in out[:2]]
        return (*out[:3], _launch.flat(out[3:]))

    def cf_bwd_bf16w(self, dist, env, x, *rest):
        self.saw("cfconv_bwd_bf16w", x.shape[-1])
        return tcf._cfconv_bwd_bf16w_plain(dist, env, x, *rest)

    def ncsn_wide_fwd(self, dist, noise, sel, sigma, u, weights, anneal):
        self.saw("ncsn_wide_fwd", u.shape[-1])
        return tns._ncsn_wide_fwd_plain(dist, noise, sel, sigma, u, weights,
                                        anneal)

    def ncsn_wide_bwd(self, dist, noise, sel, sigma, u, g_rows, weights,
                      anneal):
        self.saw("ncsn_wide_bwd", u.shape[-1])
        return tns._ncsn_wide_bwd_plain(dist, noise, sel, sigma, u, g_rows,
                                        weights, anneal)

    def stack(self, dist, env, h0, stacked, start, stop, num_g, sym):
        self.saw("schnet_stack", h0.shape[-1])
        return tcf.schnet_stack_reference(dist, env, h0, stacked, start, stop,
                                          num_g)

    def ncsn_fwd(self, dist, noise, sel, sigma, u, weights, anneal):
        self.saw("ncsn_fwd", u.shape[-1])
        return tns.ncsn_score_loss_reference(dist, noise, sel, sigma, u,
                                             *weights, anneal)

    def ncsn_bwd(self, dist, noise, sel, sigma, u, g_rows, weights, anneal):
        self.saw("ncsn_bwd", u.shape[-1])
        du, *grads = tns.ncsn_score_bwd_reference(dist, noise, sel, sigma, u,
                                                  g_rows, *weights,
                                                  anneal=anneal)
        return du, _launch.flat(grads)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("f", [40, 12, 16])
def test_cfconv_launches_run_the_kernel_width_k_squared_times(
        block16, monkeypatch, f, symmetric):
    """The custom ops' launch functions and the wrappers' counts: every
    call at the kernel's width, k^2 calls per direction, db2 once (the
    bias's gradient of one column block is the same in each of its k
    calls: summed it would be k times too large)."""
    stand = StandIns(monkeypatch)
    d, env = pair_grid(seed=3, symmetric=symmetric)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 12, f))).requires_grad_(True)
    fw = [t.requires_grad_(True) for t in filter_weights(3, f, 20)]
    args = (0.0, CUT, 20)
    op = tcf.cfconv_fused_sym if symmetric else tcf.cfconv_fused
    out = op(d, env, x, *fw, *args)
    gr = torch.from_numpy(rng.normal(size=out.shape))
    grads = torch.autograd.grad(out, [x, *fw], gr)
    k2 = tcf.launches_per_call(f)
    assert k2 == (9 if f == 40 else 1)
    assert stand.widths == {"cfconv_fwd": [BLOCK] * k2,
                            "cfconv_bwd": [BLOCK] * k2}
    suffix = "_sym" if symmetric else ""
    counts = _launch.launch_counts()
    assert (counts["cfconv_fwd" + suffix], counts["cfconv_bwd" + suffix]) \
        == (k2, k2)
    want_out = tcf.cfconv_fused_reference(d, env, x, *fw, *args)
    want = torch.autograd.grad(want_out, [x, *fw], gr)
    assert_close(out, want_out, EXACT, "m")
    for name, a, w in zip(("dx", "dW1", "db1", "dW2", "db2"), grads, want):
        assert_close(a, w, EXACT, name)
    # the launch function's db2 directly: the true one, not k times it
    *_, wgrad = tcf._launch_cfconv_bwd(d, env, x.detach(), gr,
                                       *(t.detach() for t in fw), *args,
                                       symmetric, False)
    db2 = tcf._split_wgrad(wgrad, 20, f)[3]
    assert_close(db2, want[4], EXACT, "db2")


def test_stack_launch_pads_and_refuses_wider(monkeypatch):
    """#5 at F = 40: one launch at the kernel's width, cut back; above the
    kernel's width the launch refuses (serving routes per block there)."""
    stand = StandIns(monkeypatch)
    d, env = pair_grid(seed=4)
    g = 20
    h0, stacked = stack_inputs(4, 40, g)
    got = tcf.schnet_stack(d, env, h0, stacked, 0.0, CUT, g, True)
    assert stand.widths == {"schnet_stack": [tcf.KERNEL_F]}
    assert _launch.launch_counts()["schnet_stack"] == 1
    assert_close(got, tcf.schnet_stack_reference(d, env, h0, stacked, 0.0,
                                                 CUT, g), EXACT)
    h0, stacked = stack_inputs(4, tcf.KERNEL_F + 8, g, layers=1)
    with pytest.raises(ValueError, match=f"F <= {tcf.KERNEL_F}"):
        tcf._launch_schnet_stack(d, env, h0, stacked, 0.0, CUT, g, True)


@pytest.mark.parametrize("f", [40, 12])
@pytest.mark.parametrize("kernel", ["fwd", "bwd", "fwd_sym", "bwd_sym"])
def test_bf16_column_blocks_match_jax_bf16(block16, monkeypatch, kernel, f):
    """#1-#4's bf16 instances through the launch functions with plain
    stand-ins, against the JAX package's bf16 Pallas kernels at the same F
    (interpret mode) by ``test_torch_port_bf16``'s criterion: within JAX's
    bf16 kernel bound (rtol/atol 2e-3 x max; the symmetric pair cotangents
    folded) and nearer to JAX's bf16 result than that is to JAX's f32 one.
    The forwards at F = 40 (3 column blocks of 16) and F = 12 (padded), the
    backwards padded at F = 12 and at F = 40 in the hidden-block instance
    (3 launches, dh rounded once, as JAX's), ddist included."""
    StandIns(monkeypatch)
    sym = kernel.endswith("sym")
    g = 8
    d, e, x, w = S._pair_inputs(2, 16, 3, np.float32, None if sym else 4, f,
                                g)
    ct = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    args = (0.0, CUT, g)
    jin = [jnp.asarray(a) for a in (d, e, x, *w)]
    tin = [torch.from_numpy(a) for a in (d, e, x, *w)]
    if kernel.startswith("fwd"):
        jfwd = jcf.cfconv_fused_sym if sym else jcf.cfconv_fused
        got = tcf._launch_cfconv(*tin, *args, sym, True, "bf16")
        want, want32 = (jfwd(*jin, *args, m, True) for m in ("bf16", "f32"))
        B.assert_scaled(got, want, kernel, **B.KERNEL_TOL)
        B.assert_nearer(got, want, want32, kernel)
        return
    bwd_args = (*tin[:3], torch.from_numpy(ct), *tin[3:], *args, sym, False,
                "bf16")
    *got, wgrad = tcf._launch_cfconv_bwd(*bwd_args)
    name = "cfconv_bwd" + ("_sym" if sym else "")
    counts = _launch.launch_counts()
    assert (counts[name + "_bf16"], counts[name + "_bf16w"]) == \
        ((0, 3) if f > BLOCK else (1, 0))
    got += tcf._split_wgrad(wgrad, g, f)
    jbwd = jcf._cfconv_sym_bwd if sym else jcf._cfconv_bwd
    want, want32 = (jbwd(*jin, jnp.asarray(ct), *args, m, False)
                    for m in ("bf16", "f32"))
    for k, (a, b, b32) in enumerate(zip(got, want, want32)):
        a, b, b32 = B._np(a), B._np(b), B._np(b32)
        if sym and k < 2:
            a, b, b32 = S._fold(a), S._fold(b), S._fold(b32)
        B.assert_scaled(a, b, B.BWD_NAMES[k], **B.KERNEL_TOL)
        B.assert_nearer(a, b, b32, B.BWD_NAMES[k])


@pytest.mark.parametrize("emb", [40, 131])
def test_ncsn_launches_pad_into_their_instance(monkeypatch, emb):
    """The head's forward and backward at E = 40 (the 128 instance) and
    E = 131 (the 256 instance, counted as ``*_e256``) through the stand-ins
    against the plain head at E."""
    stand = StandIns(monkeypatch)
    grid, weights, g_rows = head_inputs(7, emb)
    u = grid[4].clone().requires_grad_(True)
    ws = [w.clone().requires_grad_(True) for w in weights]
    rows = tns.ncsn_score_loss(*grid[:4], u, *ws, 2.0)
    grads = torch.autograd.grad(rows, [u, *ws], g_rows)
    width = tns.instance_width(emb)
    assert stand.widths == {"ncsn_fwd": [width], "ncsn_bwd": [width]}
    counts = _launch.launch_counts()
    tag = "_e256" if width == 256 else ""
    assert counts["ncsn_score_fwd" + tag] == counts["ncsn_score_bwd" + tag] == 1
    want_rows = tns.ncsn_score_loss_reference(*grid, *weights, 2.0)
    want = tns.ncsn_score_bwd_reference(*grid, g_rows, *weights, anneal=2.0)
    assert_close(rows, want_rows, EXACT, "rows")
    for k, (a, w) in enumerate(zip(grads, want)):
        assert a.shape == w.shape
        assert_close(a, w, EXACT, str(k))


# -- the DDM-SchNet slice at F = E = 40 against the JAX package ---------------------

WIDE = 40


@pytest.fixture(scope="module")
def wide_case():
    return T.ddm_jax_case("schnet", emb=WIDE, hidden_channels=WIDE,
                          num_filters=WIDE)


def test_ddm_schnet_at_width_40_matches_jax_f64(wide_case, block16,
                                                monkeypatch):
    """The loss and every gradient, the port through the stand-ins: the
    CFConv in 3 column blocks (9 launches a call), the head padded to 128."""
    case = wide_case
    pos2, draws = T._step_inputs(case["pos"], case["mask"], 0)
    with S.x64():
        want, jgrad = case["jax_value_and_grad"](
            case["params"], *map(jnp.asarray, case["arrays"]),
            jnp.asarray(pos2), tuple(map(jnp.asarray, draws)))
        jgrad = jax.tree_util.tree_map(np.asarray, jgrad)
    ddm = case["port"]()
    stand = StandIns(monkeypatch)
    loss = T._port_loss(ddm, case, pos2, draws)
    loss.backward()
    assert set(stand.widths["cfconv_fwd"]) == {BLOCK}
    assert set(stand.widths["ncsn_fwd"]) == {tns.KERNEL_E}
    counts = _launch.launch_counts()
    # 2 views x 2 blocks, 9 launches each
    assert counts["cfconv_fwd_sym"] == counts["cfconv_bwd_sym"] == 2 * 2 * 9
    assert counts["ncsn_score_fwd"] == counts["ncsn_score_bwd"] == 2
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-10)
    grads = T._as_port_state(jgrad, case["to_port"])
    named = dict(ddm.named_parameters())
    assert sorted(named) == sorted(grads)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def test_ddm_schnet_at_width_40_adam_trajectory_matches_jax_f64(
        wide_case, block16, monkeypatch):
    """4 Adam steps (as ``test_torch_port_train``'s trajectory) through the
    stand-ins."""
    case = wide_case
    lr, decay = 5e-3, 0.01
    steps = [T._step_inputs(case["pos"], case["mask"], s) for s in range(4)]
    with S.x64():
        tx = joptim.make_optimizer(lr, 2, 2, decay, "CosineAnnealingLR")
        params = jax.tree_util.tree_map(jnp.asarray, case["params"])
        opt_state = tx.init(params)

        @jax.jit
        def adam(g, opt_state, params):
            updates, opt_state = tx.update(g, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        want = []
        arrays = tuple(map(jnp.asarray, case["arrays"]))
        for pos2, draws in steps:
            loss, g = case["jax_value_and_grad"](
                params, *arrays, jnp.asarray(pos2),
                tuple(map(jnp.asarray, draws)))
            params, opt_state = adam(g, opt_state, params)
            want.append(float(loss))
        params = jax.tree_util.tree_map(np.asarray, params)
    ddm = case["port"]()
    StandIns(monkeypatch)
    opt, sched = optim.make_optimizer(ddm.parameters(), lr, 2, 2, decay,
                                      "CosineAnnealingLR")
    got = []
    for pos2, draws in steps:
        opt.zero_grad()
        loss = T._port_loss(ddm, case, pos2, draws)
        loss.backward()
        opt.step()
        sched.step()
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-10)
    final = T._as_port_state(params, case["to_port"])
    for name, p in ddm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


# -- serving's route and the startup limits -----------------------------------------


@pytest.mark.parametrize("width,stacked", [(192, False), (96, True),
                                           (128, True)])
def test_predictor_routes_by_the_stack_width(width, stacked):
    """A SchNet Predictor serves through the stack up to F = 128 (padded)
    and through the per-block kernels' column blocks above it; neither is
    refused at startup on CUDA."""
    from geossl_tpu_torch.config import ModelConfig, SchNetConfig
    from geossl_tpu_torch.serve import Predictor
    from geossl_tpu_torch.train import common

    cfg = ModelConfig(emb_dim=width, schnet=SchNetConfig(
        hidden_channels=width, num_filters=width, num_interactions=1,
        num_gaussians=8))
    state = {"model": common.make_backbone(cfg).state_dict()}
    pred = Predictor(cfg, state, device="cpu", bucket_sizes=(32, 128, 256))
    assert [pred.stack_route(n) for n in (32, 128, 256)] == \
        [stacked, stacked, False]
    routes = [pred.stack_route(n) for n in pred.bucket_sizes]
    assert common.kernel_limit_errors(cfg, backward=True,
                                      per_block=not all(routes),
                                      stack=any(routes)) == []
