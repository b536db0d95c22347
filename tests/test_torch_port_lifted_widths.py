"""The two width limits the training drivers no longer refuse, on the CPU:
the bf16 CFConv backwards (#2/#4) above the kernels' filter width, which run
one launch per hidden block (``csrc/cfconv_bwd_bf16w.cu``), and the DDM head
(#6/#7) above 256, which runs its streamed instance
(``csrc/ncsn_score_wide.cu``).

The kernels' widths are monkeypatched to 16 (``block16``, as
``test_torch_port_widths``): the CFConv's ``KERNEL_F``, the head's
fixed-width instances (``KERNEL_WIDTHS``) and its streamed chunk
(``WIDE_CHUNK``), so F = 40 runs 3 hidden blocks and E = 40 / 41 the
streamed instance at 48 (3 chunks of E, 3 groups of H). The real launch
functions run, with the new instances' plain versions monkeypatched in for
their ctypes launches (``test_torch_port_widths.StandIns``).

* The hidden-block bf16 backward, both modes, G = 51 and 65, against the
  JAX package's bf16 ``_bwd_pallas`` / ``_bwd_sym_pallas`` in interpret
  mode by ``test_torch_port_bf16``'s criterion (within JAX's bf16 kernel
  bound, rtol / atol 2e-3 x max, and nearer to JAX's bf16 result than that
  is to JAX's f32 one), ddist included; its plain version against the
  full-width plain bf16 body in f64 at 1e-12 (the same rounded operands).
* The streamed head at E = 40 and 41 (odd H) against JAX's
  ``ncsn_score_loss`` rows and VJP (du and the ten weight gradients; rtol
  1e-4, atol 1e-5 x max, as ``test_torch_port_ncsn``), and its plain
  version against the full-width plain head in f64 at 1e-12.
* One DDM-SchNet step with ``--filter_mxu bf16`` at F = E = 40 through
  both new instances against the JAX package's bf16 step (the JAX
  package's filter_mxu bounds).
* ``kernel_limit_errors`` is empty for bf16 at any ``--num_filters`` and
  for the head at any ``--emb_dim``.
* The rows' work counts (``utils/flops``) against PyTorch's
  ``FlopCounterMode`` on the plain versions, and a flax head at E = 384
  carried across.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geossl_tpu.models.schnet import SchNet as JSchNet
from geossl_tpu.objectives.ncsn import NCSNv3 as JNCSNv3
from geossl_tpu.ops import cfconv_pallas as jcf
from geossl_tpu.ops import geometry as jgeo
from geossl_tpu.ops import ncsn_pallas as jns
from geossl_tpu_torch.config import ModelConfig, PaiNNConfig, SchNetConfig
from geossl_tpu_torch.data.batch import DenseMolBatch
from geossl_tpu_torch.models import schnet as tschnet
from geossl_tpu_torch.objectives.ncsn import NCSNv3
from geossl_tpu_torch.ops import _launch
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.ops import ncsn as tns
from geossl_tpu_torch.train import common
from geossl_tpu_torch.train import pretrain_geossl as PG
from geossl_tpu_torch.utils.torch_import import (
    ncsn_state_dict_from_flax,
    schnet_state_dict_from_flax,
)
from tests import test_torch_port_bf16 as B
from tests import test_torch_port_ncsn as N
from tests import test_torch_port_schnet as S
from tests import test_torch_port_widths as W

torch.set_num_threads(1)

BLOCK = W.BLOCK  # every patched kernel width
CUT = 5.0
WIDE = 40  # 3 blocks / chunks of 16


@pytest.fixture
def block16(monkeypatch):
    monkeypatch.setattr(tcf, "KERNEL_F", BLOCK)
    monkeypatch.setattr(tns, "KERNEL_WIDTHS", (BLOCK,))
    monkeypatch.setattr(tns, "WIDE_CHUNK", BLOCK)


# -- #2/#4 in bf16, one launch per hidden block --------------------------------


@pytest.mark.parametrize("g", [51, 65])
@pytest.mark.parametrize("sym", [False, True], ids=["bwd", "bwd_sym"])
def test_hidden_block_bf16_backward_matches_jax_bf16(block16, monkeypatch,
                                                     sym, g):
    """F = 40 (3 hidden blocks, 3 launches of ``<kernel>_bf16w``) through
    the launch function against JAX's bf16 backward at F = 40, every
    output by the bf16 criterion, ddist included (the k^2 column blocks
    put it past JAX's bound)."""
    stand = W.StandIns(monkeypatch)
    d, e, x, w = S._pair_inputs(2, 16, 11 + g, np.float32,
                                None if sym else 4, WIDE, g)
    ct = np.random.default_rng(g).normal(size=x.shape).astype(np.float32)
    args = (0.0, CUT, g)
    tin = [torch.from_numpy(a) for a in (d, e, x, *w)]
    *got, wgrad = tcf._launch_cfconv_bwd(*tin[:3], torch.from_numpy(ct),
                                         *tin[3:], *args, sym, False, "bf16")
    got += tcf._split_wgrad(wgrad, g, WIDE)
    name = "cfconv_bwd" + ("_sym" if sym else "")
    counts = _launch.launch_counts()
    assert (counts[name], counts[name + "_bf16"], counts[name + "_bf16w"]) \
        == (0, 0, 3)
    assert stand.widths == {"cfconv_bwd_bf16w": [3 * BLOCK]}
    jin = [jnp.asarray(a) for a in (d, e, x, *w)]
    jbwd = jcf._cfconv_sym_bwd if sym else jcf._cfconv_bwd
    want, want32 = (jbwd(*jin, jnp.asarray(ct), *args, m, False)
                    for m in ("bf16", "f32"))
    for k, (a, b, b32) in enumerate(zip(got, want, want32)):
        a, b, b32 = B._np(a), B._np(b), B._np(b32)
        assert a.shape == b.reshape(a.shape).shape
        b, b32 = b.reshape(a.shape), b32.reshape(a.shape)
        if sym and k < 2:
            a, b, b32 = S._fold(a), S._fold(b), S._fold(b32)
        B.assert_scaled(a, b, B.BWD_NAMES[k], **B.KERNEL_TOL)
        B.assert_nearer(a, b, b32, B.BWD_NAMES[k])


@pytest.mark.parametrize("g", [51, 65])
@pytest.mark.parametrize("f", [40, 48])
def test_hidden_block_plain_version_is_the_full_width_body_f64(block16, f, g):
    """The hidden blocks' plain version rounds the same operands as the
    full-width bf16 body (dh summed over the output blocks before it is
    rounded): equal in f64 to 1e-12, at a padded F (40) and a whole one
    (48)."""
    d, env = W.pair_grid(seed=f + g)
    rng = np.random.default_rng(f * g)
    x = torch.from_numpy(rng.normal(size=(2, 12, f)))
    gr = torch.from_numpy(rng.normal(size=(2, 12, f)))
    fw = W.filter_weights(g, f, g)
    args = (0.0, CUT, g)
    got = tcf.cfconv_bwd_bf16_blocks_reference(d, env, x, gr, *fw, *args)
    want = tcf.cfconv_bwd_bf16_reference(d, env, x, gr, *fw, *args)
    for name, a, b in zip(B.BWD_NAMES, got, want):
        assert a.shape == b.shape, name
        W.assert_close(a, b, W.EXACT, name)


def test_hidden_block_layout_round_trips(block16):
    """The launch function's view of the instance's weight-gradient
    shares: packed by the plain version, unpacked by the launch (db2 from
    the first share's first row)."""
    g, width = 5, 3 * BLOCK
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.normal(size=s)) for s in
             ((g, width), (width,), (width, width), (width,))]
    packed = tcf._pack_hidden_blocks(*parts)
    assert packed.shape == (3, tcf._hidden_block_size(g, width))
    for f in (width, width - 7):
        for a, b in zip(tcf._unpack_hidden_blocks(packed, g, f),
                        (parts[0][:, :f], parts[1][:f], parts[2][:f, :f],
                         parts[3][:f])):
            assert torch.equal(a, b)


# -- #6/#7 streamed above the fixed widths -----------------------------------------


@pytest.mark.parametrize("emb", [40, 41])
def test_streamed_head_matches_jax(block16, monkeypatch, emb):
    """The head at E = 40 / 41 through the launch functions (the streamed
    instance at 48, one counted launch each way) against JAX's
    ``ncsn_score_loss`` in interpret mode: the rows and the VJP."""
    stand = W.StandIns(monkeypatch)
    grid, ws, _ = N._ncsn_case(2, 16, seed=emb, emb=emb)
    g_rows = np.random.default_rng(emb).normal(size=grid[0].shape[:2])
    g_rows = g_rows.astype(np.float32)
    jgrid = list(map(jnp.asarray, grid))
    jgrid[3] = jgrid[3][:, None]
    want_rows, vjp = jax.vjp(
        lambda u, *w: jns.ncsn_score_loss(*jgrid[:4], u, *w, 2.0),
        jgrid[4], *map(jnp.asarray, ws))
    want = vjp(jnp.asarray(g_rows))
    tgrid = list(map(torch.from_numpy, grid))
    u = tgrid[4].clone().requires_grad_(True)
    tws = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    rows = tns.ncsn_score_loss(*tgrid[:4], u, *tws, 2.0)
    got = torch.autograd.grad(rows, [u, *tws], torch.from_numpy(g_rows))
    assert stand.widths == {"ncsn_wide_fwd": [48], "ncsn_wide_bwd": [48]}
    counts = _launch.launch_counts()
    assert (counts["ncsn_score_fwd_wide"], counts["ncsn_score_bwd_wide"],
            counts["ncsn_score_fwd"], counts["ncsn_score_bwd"]) == (1, 1, 0, 0)
    N.close(rows.detach().numpy(), want_rows)
    for name, a, w in zip(("u",) + tns.WEIGHT_NAMES, got, want):
        assert a.shape == tuple(np.shape(w)) or a.numel() == np.size(w), name
        N.close(a.numpy(), np.asarray(w).reshape(a.shape))


@pytest.mark.parametrize("emb", [48, 41])
def test_streamed_plain_version_is_the_full_width_head_f64(block16, emb):
    """The streamed instance's plain version (E in chunks of 16, H in
    groups of 8, the backward written out chunk by chunk) at the padded
    width, cut back, against the full-width plain head at E in f64: the
    rows, du and the ten weight gradients at 1e-12."""
    grid, weights, g_rows = W.head_inputs(emb, emb)
    width = tns.instance_width(emb)
    assert width == 48
    pu, pw = tns.pad_head(grid[4], weights, width)
    rows = tns.ncsn_streamed_reference(*grid[:4], pu, pw, 2.0)
    W.assert_close(rows, tns.ncsn_score_loss_reference(*grid, *weights, 2.0),
                   W.EXACT, "rows")
    du, wgrad = tns._ncsn_wide_bwd_plain(*grid[:4], pu, g_rows, pw, 2.0)
    want = tns.ncsn_score_bwd_reference(*grid, g_rows, *weights, anneal=2.0)
    W.assert_close(du[..., :emb], want[0], W.EXACT, "du")
    W.assert_close(tns.unpad_wgrad(wgrad, emb, width),
                   _launch.flat(want[1:]), W.EXACT, "weight gradients")


# -- a DDM-SchNet step through both instances --------------------------------------


SMALL40 = dict(hidden_channels=WIDE, num_filters=WIDE, num_interactions=2,
               num_gaussians=8, cutoff=CUT)


def test_ddm_schnet_bf16_step_at_width_40_matches_jax(block16, monkeypatch):
    """A DDM-SchNet loss with --filter_mxu bf16 at emb = F = 40: the port
    through the stand-ins (#4 in 3 hidden blocks, the heads streamed at
    48), the JAX package through its bf16 Pallas kernels in interpret mode,
    the same weights and draws: the loss within the JAX package's
    filter_mxu bound and nearer to JAX's bf16 loss than that is to its f32
    one; every gradient within 5% of the f32 gradient's mean magnitude,
    all of them nearer to JAX's bf16 gradients than those are to its f32
    ones."""
    z, pos, mask = B._molecules(b=3, seed=23)
    gm = mask.any(axis=1)
    n = pos.shape[1]
    sel = mask[:, :, None] & mask[:, None, :] & np.triu(np.ones((n, n), bool),
                                                         1)
    rng = np.random.default_rng(101)
    pos2 = (pos + rng.normal(scale=0.3, size=pos.shape)).astype(np.float32)
    draws = []
    for _ in range(2):
        draws += [rng.uniform(0.01, 10.0, size=3).astype(np.float32),
                  rng.normal(size=(3, n, n)).astype(np.float32)]
    head = JNCSNv3(emb_dim=WIDE)
    k = jax.random.split(jax.random.PRNGKey(5), 3)
    params = {"model": jax.jit(JSchNet(**SMALL40).init)(
        k[0], jnp.asarray(z), jnp.asarray(pos), jnp.asarray(mask))["params"]}
    h0 = jnp.zeros((3, n, WIDE))
    for name, key in (("NCSN_01", k[1]), ("NCSN_02", k[2])):
        params[name] = jax.jit(head.init)(key, key, h0, jnp.ones((3, n, n)),
                                          jnp.asarray(sel))["params"]

    def jax_loss(p, mxu):
        jm = JSchNet(**SMALL40, use_pallas=mxu == "bf16", filter_mxu=mxu)
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
        jax.jit(jax.value_and_grad(lambda p, m=m: jax_loss(p, m)))(params)
        for m in ("bf16", "f32"))
    ddm = PG.DDM(tschnet.SchNet(**SMALL40, filter_mxu="bf16"),
                 NCSNv3(emb_dim=WIDE), NCSNv3(emb_dim=WIDE))
    ddm.model.load_state_dict(schnet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params["model"])))
    for name in ("NCSN_01", "NCSN_02"):
        getattr(ddm, name).load_state_dict(ncsn_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, params[name])))
    batch = DenseMolBatch(atom_type=torch.from_numpy(z).long(),
                          positions=torch.from_numpy(pos),
                          node_mask=torch.from_numpy(mask),
                          graph_mask=torch.from_numpy(gm))
    stand = W.StandIns(monkeypatch)
    loss = ddm(batch, torch.from_numpy(pos2), torch.from_numpy(sel),
               tuple(torch.from_numpy(a) for a in draws))
    grads = dict(zip((k for k, _ in ddm.named_parameters()),
                     torch.autograd.grad(loss, list(ddm.parameters()),
                                         allow_unused=True)))
    counts = _launch.launch_counts()
    # two views x two blocks: the symmetric pair, #4 in 3 hidden blocks
    assert counts["cfconv_bwd_sym_bf16w"] == 2 * 2 * 3
    assert counts["cfconv_bwd_sym_bf16"] == counts["cfconv_bwd_sym"] == 0
    assert counts["ncsn_score_fwd_wide"] == counts["ncsn_score_bwd_wide"] == 2
    assert set(stand.widths["ncsn_wide_fwd"]) == {48}
    np.testing.assert_allclose(loss.item(), float(want),
                               **B.MODEL_TOL["filter_mxu"])
    assert abs(loss.item() - float(want)) < abs(float(want) - float(want32))

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
        B.assert_grad(grads[k], w16[k], w32[k], k)
    B.assert_nearer(np.concatenate([B._np(grads[k]).ravel() for k in w16]),
                    np.concatenate([B._np(w16[k]).ravel() for k in w16]),
                    np.concatenate([B._np(w32[k]).ravel() for k in w16]),
                    "gradients")


# -- the startup limits ------------------------------------------------------------


def _cfg(model_3d="schnet", emb=128, filters=128, **kw):
    return ModelConfig(model_3d=model_3d, emb_dim=emb,
                       schnet=SchNetConfig(hidden_channels=emb,
                                           num_filters=filters),
                       painn=PaiNNConfig(n_atom_basis=emb), **kw)


@pytest.mark.parametrize("filters", [129, 192, 256, 384, 512])
@pytest.mark.parametrize("mode", [dict(filter_mxu="bf16"),
                                  dict(compute_dtype="bfloat16")],
                         ids=["filter_mxu", "compute_dtype"])
def test_no_bf16_backward_width_is_refused(filters, mode):
    cfg = _cfg(filters=filters, **mode)
    assert common.kernel_limit_errors(cfg, backward=True) == []
    common.check_kernel_limits(cfg, torch.device("cuda"), backward=True)


@pytest.mark.parametrize("emb", [257, 300, 320, 384, 512, 1000])
@pytest.mark.parametrize("model_3d", ["schnet", "painn"])
def test_no_head_width_is_refused(model_3d, emb):
    """The DDM head at any --emb_dim: the streamed instance above 256."""
    cfg = _cfg(model_3d, emb=emb, filters=emb)
    assert common.kernel_limit_errors(cfg, backward=True) == []
    assert tns.streamed(tns.instance_width(emb))
    assert tns.instance_width(emb) % 128 == 0


# -- the rows' work counts (utils/flops) -------------------------------------------


def _counted(fn):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_hidden_block_products_are_the_flops_count(block16):
    """``flops.cfconv_bwd_kernel``'s products on a dense grid (every pair
    filtered and live) are those of the hidden blocks' plain version at F
    = 48 (3 blocks), counted by PyTorch, and one call makes k launches in
    bf16 where the f32 backward makes k^2."""
    from geossl_tpu_torch.utils import flops

    b, n, f, g = 1, 8, 48, 20
    rng = np.random.default_rng(3)
    d = torch.from_numpy(rng.uniform(0.5, 4.0, size=(b, n, n)))
    env = torch.ones(b, n, n, dtype=torch.float64)
    x, gr = (torch.from_numpy(rng.normal(size=(b, n, f))) for _ in range(2))
    fw = W.filter_weights(1, f, g)
    got = _counted(lambda: tcf.cfconv_bwd_bf16_blocks_reference(
        d, env, x, gr, *fw, 0.0, CUT, g))
    products, elementwise = flops.cfconv_bwd_kernel(g, f, b * n * n,
                                                    b * n * n, False)
    assert products == got
    assert elementwise == b * n * n * 6 * f
    assert flops.cfconv_bwd_kernel(g, f, 10, 10, True)[0] == \
        flops.cfconv_bwd_kernel(g, f, 10, 10, False)[0]
    assert [flops.cfconv_launches(f, backward, mxu) for backward, mxu in (
        (False, "bf16"), (True, "f32"), (True, "bf16"))] == [9, 9, 3]


@pytest.mark.parametrize("emb", [48, 32])
def test_streamed_head_products_are_the_flops_count(block16, emb):
    """``flops.ncsn_head_kernel``'s products: the streamed plain version's
    l1 W2 (forward) and l1 W2, dW2, dl1 (backward), counted by PyTorch,
    beside its distance MLP's and score's vector products."""
    from geossl_tpu_torch.utils import flops

    grid, weights, g_rows = W.head_inputs(emb, emb, b=1, n=8)
    grid[2][:] = 1.0  # every pair selected
    pairs, h = 64, emb // 2
    fwd = _counted(lambda: tns.ncsn_streamed_reference(*grid, weights, 2.0))
    bwd = _counted(lambda: tns.ncsn_streamed_reference(*grid, weights, 2.0,
                                                       g_rows))
    vec = 2 * pairs * (emb + h)  # demb's w_d2, the score's w3
    assert fwd - vec == flops.ncsn_head_kernel(emb, pairs)[0]
    assert bwd - vec == flops.ncsn_head_kernel(emb, pairs, True)[0]
    assert flops.ncsn_head_kernel(emb, pairs, True)[0] == \
        3 * flops.ncsn_head_kernel(emb, pairs)[0] == 6 * pairs * emb * h


def test_flax_head_at_e384_loads():
    """A flax NCSNv3 head at emb 384 (the streamed instance's width) carries
    across (``utils/torch_import.ncsn_state_dict_from_flax``): every
    weight, its shape, and the same loss on the CPU in f64."""
    rng = np.random.default_rng(4)
    b, n, emb = 2, 6, 384
    h = rng.normal(size=(b, n, emb))
    dist = rng.uniform(0.5, 4.0, size=(b, n, n))
    dist = (dist + dist.transpose(0, 2, 1)) / 2
    sel = np.triu(np.ones((n, n), bool), 1)[None].repeat(b, 0)
    sigma = np.array([0.3, 2.0])
    noise = rng.normal(size=(b, n, n))
    gm = np.ones(b, bool)
    head = JNCSNv3(emb_dim=emb)
    with S.x64():
        params = head.init(jax.random.PRNGKey(0), None, jnp.asarray(h),
                           jnp.asarray(dist), jnp.asarray(sel),
                           sigmas=jnp.asarray(sigma), noise=jnp.asarray(noise))
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        params["params"])
        want = float(head.apply({"params": params}, None, jnp.asarray(h),
                                jnp.asarray(dist), jnp.asarray(sel),
                                jnp.asarray(gm), sigmas=jnp.asarray(sigma),
                                noise=jnp.asarray(noise)))
    port = NCSNv3(emb_dim=emb).double()
    port.load_state_dict(ncsn_state_dict_from_flax(params))
    assert [tuple(w.shape) for w in port.head_weights()] == \
        list(tns.weight_shapes(emb))
    got = port(torch.from_numpy(h), torch.from_numpy(dist),
               torch.from_numpy(sel), torch.from_numpy(gm),
               sigmas=torch.from_numpy(sigma), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.item(), want, rtol=1e-10)
