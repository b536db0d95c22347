"""The pretraining objectives of geossl_tpu_torch against the JAX package's,
in f64 (real f64 on the JAX side, inside x64) at rtol 1e-10, with the JAX
side's random draws passed in: the contrastive losses (InfoNCE, EBM-NCE, the
reference's ``do_cl``/``dual_cl``), ``l2_normalize`` at a zero row, the RR
AutoEncoder and its masked BatchNorm's running statistics, the exact-count
subsampling, the charge, distance and torsion heads, InfoGraph, ContextPred
and the NCSN v1/v2 heads. Each of the JAX modules' flax trees, made by its
``init``, loads into the port's module with ``strict=True`` through
``utils/torch_import`` and both compute the same output and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geossl_tpu.objectives import autoencoder as jae
from geossl_tpu.objectives import contextpred as jcp
from geossl_tpu.objectives import contrastive as jcl
from geossl_tpu.objectives import heads as jheads
from geossl_tpu.objectives import infograph as jig
from geossl_tpu.objectives import ncsn as jncsn
from geossl_tpu.objectives import pairs as jpairs
from geossl_tpu.ops import geometry as jgeo
from geossl_tpu_torch import objectives as O
from geossl_tpu_torch.objectives import autoencoder as tae
from geossl_tpu_torch.objectives import pairs as tpairs
from geossl_tpu_torch.utils import torch_import as TI
from tests import test_torch_port_schnet as S

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

F = 16
RTOL, ATOL = 1e-10, 1e-12


def t(a):
    return torch.from_numpy(np.array(a))


def vg(fn, argnums=0, has_aux=False):
    """``jax.value_and_grad`` compiled once (the JAX side's op-by-op
    dispatch costs seconds per test)."""
    return jax.jit(jax.value_and_grad(fn, argnums=argnums, has_aux=has_aux))


def jinit(module, *args):
    return jax.jit(module.init)(*args)


def f64_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def reprs(b=6, seed=0, pad=True):
    """Two [B, F] views and a graph mask whose last slot is padding (its
    rows all-zero, as an empty slot's pooled representation)."""
    rng = np.random.default_rng(seed)
    x, y = rng.normal(size=(b, F)), rng.normal(size=(b, F))
    gm = np.ones(b, bool)
    if pad:
        gm[-1] = False
        x[-1], y[-1] = 0.0, 0.0
    return x, y, gm


def check_module_grads(module, jgrads, to_port):
    """Every parameter's gradient against the JAX tree's, mapped by the
    converter that loaded the weights."""
    want = to_port(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(module.named_parameters())
    assert sorted(named) == sorted(want)
    for name, p in named.items():
        close(p.grad.numpy(), want[name].numpy(), name)


# -- contrastive -----------------------------------------------------------------


_CL = {
    "ebm_nce_1": (lambda m: lambda x, y, gm: m.ebm_nce_loss(x, y, gm, 1)),
    "ebm_nce_3": (lambda m: lambda x, y, gm: m.ebm_nce_loss(x, y, gm, 3)),
    "infonce": (lambda m: lambda x, y, gm: m.infonce_loss(x, y, 0.1, gm)),
    "dual_infonce": (lambda m: lambda x, y, gm: m.dual_infonce_loss(
        x, y, 0.2, gm)),
    "do_cl_ebm": (lambda m: lambda x, y, gm: m.do_cl(
        x, y, "EBM_dot_prod", 0.5, 2, gm)),
    "dual_cl_infonce": (lambda m: lambda x, y, gm: m.dual_cl(
        x, y, "InfoNCE_dot_prod", 0.3, 1, gm)),
    "dual_cl_ebm": (lambda m: lambda x, y, gm: m.dual_cl(
        x, y, "EBM_dot_prod", 0.3, 2, gm)),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(_CL))
def test_contrastive_losses_and_gradients_match_jax_f64(name, masked):
    x, y, gm = reprs(pad=masked)
    gm_j = jnp.asarray(gm) if masked else None
    jfn = _CL[name](jcl)
    with S.x64():
        (want, jacc), (gx, gy) = vg(
            lambda a, b: jfn(a, b, gm_j), argnums=(0, 1), has_aux=True)(
                jnp.asarray(x), jnp.asarray(y))
        want, jacc, gx, gy = map(np.asarray, (want, jacc, gx, gy))
    xt, yt = t(x).requires_grad_(True), t(y).requires_grad_(True)
    loss, acc = _CL[name](O)(xt, yt, t(gm) if masked else None)
    loss.backward()
    close(loss.item(), want)
    np.testing.assert_allclose(acc.item(), jacc, rtol=1e-6)
    close(xt.grad, gx, "dx")
    close(yt.grad, gy, "dy")


def test_cycle_shift_and_refusals():
    x = np.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(O.cycle_shift(t(x), 3).numpy(),
                                  np.asarray(jcl.cycle_shift(jnp.asarray(x), 3)))
    with pytest.raises(ValueError, match="num_neg"):
        O.ebm_nce_loss(t(x), t(x), num_neg=0)
    with pytest.raises(ValueError, match="similarity"):
        O.do_cl(t(x), t(x), "cosine")


def test_l2_normalize_matches_jax_and_is_finite_at_a_zero_row():
    x, _, _ = reprs()  # its last row is all-zero
    w = np.random.default_rng(1).normal(size=x.shape)
    with S.x64():
        want, g = vg(
            lambda a: jnp.sum(jcl.l2_normalize(a) * w))(jnp.asarray(x))
        want, g = np.asarray(want), np.asarray(g)
    xt = t(x).requires_grad_(True)
    out = O.l2_normalize(xt)
    (out * t(w)).sum().backward()
    close((out.detach() * t(w)).sum().item(), want)
    assert torch.isfinite(xt.grad).all()
    close(xt.grad, g)
    np.testing.assert_array_equal(out[-1].detach().numpy(), 0.0)


# -- RR's AutoEncoder ------------------------------------------------------------


def _jax_ae(loss, detach, seed=0):
    ae = jae.AutoEncoder(emb_dim=F, loss=loss, detach_target=detach)
    with S.x64():
        v = jinit(ae, jax.random.PRNGKey(seed), jnp.zeros((2, F)),
                    jnp.zeros((2, F)))
    return ae, f64_tree(v["params"]), f64_tree(v["batch_stats"])


def test_masked_batchnorm_running_stats_over_three_calls_match_jax_f64():
    bn = jae.MaskedBatchNorm()
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(6, F)) * (k + 1) + k for k in range(3)]
    gm = np.array([1, 1, 0, 1, 1, 0], bool)
    with S.x64():
        v = jinit(bn, jax.random.PRNGKey(0), jnp.zeros((2, F)))
        params, stats = f64_tree(v["params"]), f64_tree(v["batch_stats"])
        outs = []
        for x in xs:
            out, upd = bn.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), jnp.asarray(gm),
                                mutable=["batch_stats"])
            outs.append(np.asarray(out))
            stats = jax.tree_util.tree_map(np.asarray, upd["batch_stats"])
        ev = np.asarray(bn.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(xs[0]), use_running_average=True))
    port = tae.MaskedBatchNorm(F).double()
    for x, want in zip(xs, outs):
        close(port(t(x), t(gm)).detach(), want)
    close(port.running_mean, stats["mean"], "running_mean")
    close(port.running_var, stats["var"], "running_var")
    port.eval()
    before = port.running_mean.clone()
    close(port(t(xs[0])).detach(), ev, "eval mode")
    assert torch.equal(port.running_mean, before)


@pytest.mark.parametrize("detach", [True, False])
@pytest.mark.parametrize("loss_kind", ["l1", "l2", "cosine"])
def test_autoencoder_loss_gradients_and_stats_match_jax_f64(loss_kind, detach):
    """The flax tree and batch_stats load with strict=True; loss, the
    gradients of x, y and every weight, and the updated statistics."""
    ae, params, stats = _jax_ae(loss_kind, detach)
    x, y, gm = reprs(seed=3)
    with S.x64():
        def f(p, a, b):
            out, upd = ae.apply({"params": p, "batch_stats": stats}, a, b,
                                jnp.asarray(gm), mutable=["batch_stats"])
            return out, upd["batch_stats"]

        (want, new_stats), grads = vg(
            f, argnums=(0, 1, 2), has_aux=True)(
                params, jnp.asarray(x), jnp.asarray(y))
        want = float(want)
        new_stats = jax.tree_util.tree_map(np.asarray, new_stats)
        gp, gx, gy = jax.tree_util.tree_map(np.asarray, grads)
    port = O.AutoEncoder(F, loss_kind, detach).double()
    port.load_state_dict(TI.autoencoder_state_dict_from_flax(params, stats))
    xt, yt = t(x).requires_grad_(True), t(y).requires_grad_(True)
    loss = port(xt, yt, t(gm))
    loss.backward()
    close(loss.item(), want)
    close(xt.grad, gx, "dx")
    if detach:
        assert yt.grad is None
        np.testing.assert_array_equal(gy, 0.0)
    elif loss_kind == "cosine":
        # the padded slot's all-zero target: jnp.linalg.norm's gradient at
        # 0 is NaN in the JAX package (0 · NaN through the mask); torch's
        # norm has gradient 0 there, so the port's stays finite
        close(yt.grad[gm], gy[gm], "dy")
        assert np.isnan(gy[~gm]).all()
        np.testing.assert_array_equal(yt.grad[~gm].numpy(), 0.0)
    else:
        close(yt.grad, gy, "dy")
    check_module_grads(port, gp, TI.autoencoder_state_dict_from_flax)
    want_sd = TI.autoencoder_state_dict_from_flax(params, new_stats)
    for k in ("running_mean", "running_var"):
        close(getattr(port.fc_layers[1], k), want_sd[f"fc_layers.1.{k}"], k)


# -- pairs and the heads -------------------------------------------------------


@pytest.mark.parametrize("per_graph", [True, False])
def test_exact_count_subsample_matches_jax_with_its_uniforms(per_graph):
    _, _, mask = S.molecules(4, 12, seed=4)
    pairs = S.tgeo.pair_mask_from_nodes(t(mask)).numpy()
    key = jax.random.PRNGKey(5)
    draw = jax.jit(lambda k, m: (
        jax.random.uniform(k, m.shape, jnp.float32),
        jpairs.exact_count_subsample(k, m, 0.3, per_graph=per_graph)))
    for m in (mask, pairs):
        u, want = map(np.asarray, draw(key, jnp.asarray(m)))
        got = tpairs.exact_count_subsample(None, t(m), 0.3, per_graph, t(u))
        np.testing.assert_array_equal(got.numpy(), want)
    sel = t(want)
    np.testing.assert_array_equal(
        O.graph_pair_counts(sel).numpy(),
        np.asarray(jpairs.graph_pair_counts(jnp.asarray(want))))


def _nodes(b=4, n=10, seed=6):
    z, pos, mask = S.molecules(b, n, seed=seed)
    h = np.random.default_rng(seed).normal(size=(b, n, F))
    return z, pos, mask, h


def test_charge_head_masking_and_loss_match_jax_f64():
    z, _, mask, h = _nodes()
    key = jax.random.PRNGKey(7)
    u, want_z, want_sel = map(np.asarray, jax.jit(lambda k, zz, m: (
        jax.random.uniform(k, m.shape, jnp.float32),
        *jheads.charge_masking(k, zz, m, 0.3, 9)))(
            key, jnp.asarray(z), jnp.asarray(mask)))
    got_z, got_sel = O.charge_masking(None, t(z).long(), t(mask), 0.3, 9, u=t(u))
    np.testing.assert_array_equal(got_z.numpy(), want_z)
    np.testing.assert_array_equal(got_sel.numpy(), want_sel)
    assert want_sel.sum() == int(mask.sum() * 0.3)
    head = jheads.ChargePredictor(node_class=9)
    with S.x64():
        params = f64_tree(jinit(head, jax.random.PRNGKey(0), jnp.zeros((2, F)))
                          ["params"])

        def f(p, hh):
            return jheads.charge_loss(head.apply({"params": p}, hh),
                                      jnp.asarray(z), jnp.asarray(want_sel))

        (want, jacc), (gp, gh) = vg(
            f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(h))
    port = O.ChargePredictor(F, 9).double()
    port.load_state_dict(TI.head_state_dict_from_flax(params))
    ht = t(h).requires_grad_(True)
    loss, acc = O.charge_loss(port(ht), t(z).long(), t(want_sel))
    loss.backward()
    close(loss.item(), float(want))
    np.testing.assert_allclose(acc.item(), float(jacc), rtol=1e-6)
    close(ht.grad, gh, "dh")
    check_module_grads(port, gp, TI.head_state_dict_from_flax)


def test_distance_head_and_loss_match_jax_f64():
    _, pos, mask, h = _nodes(seed=8)
    key = jax.random.PRNGKey(9)
    with S.x64():
        dist, sel, u = jax.jit(lambda k, p, m: (
            jgeo.pairwise_distances(p, m)[0],
            jpairs.pair_selection(m, "permutation", 0.5, k),
            jax.random.uniform(k, m.shape[:1] + 2 * m.shape[1:], jnp.float32)))(
                key, jnp.asarray(pos), jnp.asarray(mask))
        head = jheads.DistancePredictor()
        params = f64_tree(jinit(head, jax.random.PRNGKey(0),
                                    jnp.zeros((2, 3, F)))["params"])

        def f(p, hh):
            return jheads.distance_loss(head.apply({"params": p}, hh), dist,
                                        sel)

        want, (gp, gh) = vg(f, argnums=(0, 1))(
            params, jnp.asarray(h))
        sel, dist, u = np.asarray(sel), np.asarray(dist), np.asarray(u)
    got_sel = O.pair_selection(t(mask), "permutation", 0.5, u=t(u))
    np.testing.assert_array_equal(got_sel.numpy(), sel)
    port = O.DistancePredictor(F).double()
    port.load_state_dict(TI.distance_head_state_dict_from_flax(params))
    ht = t(h).requires_grad_(True)
    loss = O.distance_loss(port(ht), t(dist), got_sel)
    loss.backward()
    close(loss.item(), float(want))
    close(ht.grad, gh, "dh")
    check_module_grads(port, gp, TI.distance_head_state_dict_from_flax)


def test_torsion_triples_head_and_loss_match_jax_f64():
    _, pos, mask, h = _nodes(seed=10)
    key = jax.random.PRNGKey(11)
    with S.x64():
        idx, angle, valid, r = jax.jit(lambda k, p, m: (
            *jheads.torsion_triples(k, p, m, 12),
            jax.random.uniform(k, (4, 12, 3))))(
                key, jnp.asarray(pos), jnp.asarray(mask))
        r = np.asarray(r)
        head = jheads.TorsionAnglePredictor()
        params = f64_tree(jinit(head, jax.random.PRNGKey(0), jnp.zeros((2, 3, F)),
                                    jnp.zeros((2, 2, 3), jnp.int32))["params"])

        def f(p, hh):
            return jheads.torsion_loss(head.apply({"params": p}, hh, idx),
                                       angle, valid)

        want, (gp, gh) = vg(f, argnums=(0, 1))(
            params, jnp.asarray(h))
        idx, angle, valid = map(np.asarray, (idx, angle, valid))
    got_idx, got_angle, got_valid = O.torsion_triples(None, t(pos), t(mask),
                                                      12, r=t(r))
    np.testing.assert_array_equal(got_idx.numpy(), idx)
    np.testing.assert_array_equal(got_valid.numpy(), valid)
    assert valid.any() and not valid.all()
    # the valid triples' angles (the loss reads no other): a triple with
    # u == w has cos 1 in exact arithmetic, where arccos turns the last
    # bit's rounding into ~1e-8
    close(got_angle[t(valid)], angle[valid], "angle")
    port = O.TorsionAnglePredictor(F).double()
    port.load_state_dict(TI.head_state_dict_from_flax(params))
    ht = t(h).requires_grad_(True)
    loss = O.torsion_loss(port(ht, got_idx), got_angle, got_valid)
    loss.backward()
    close(loss.item(), float(want))
    close(ht.grad, gh, "dh")
    check_module_grads(port, gp, TI.head_state_dict_from_flax)


def test_infograph_loss_matches_jax_f64():
    """The padded graph's summary is never a negative."""
    _, _, mask, h = _nodes(seed=12)
    mask[2] = False
    gm = mask.any(axis=1)
    g = np.random.default_rng(13).normal(size=(4, F))
    disc = jig.InfoGraphDiscriminator(hidden_dim=F)
    with S.x64():
        params = f64_tree(jinit(disc, jax.random.PRNGKey(0), jnp.zeros((2, F)),
                                    jnp.zeros((2, F)))["params"])

        def f(p, hh, gg):
            return jig.infograph_loss(disc, p, hh, gg, jnp.asarray(mask),
                                      jnp.asarray(gm))

        (want, jacc), (gp, gh, gg) = vg(
            f, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(h),
                                                jnp.asarray(g))
    port = O.InfoGraphDiscriminator(F).double()
    port.load_state_dict(TI.infograph_state_dict_from_flax(params))
    ht, gt = t(h).requires_grad_(True), t(g).requires_grad_(True)
    loss, acc = O.infograph_loss(port, ht, gt, t(mask), t(gm))
    loss.backward()
    close(loss.item(), float(want))
    np.testing.assert_allclose(acc.item(), float(jacc), rtol=1e-6)
    close(ht.grad, gh, "dh")
    close(gt.grad, gg, "dgraph")
    check_module_grads(port, gp, TI.infograph_state_dict_from_flax)


# -- ContextPred -----------------------------------------------------------------


def test_contextpred_centers_hops_and_masks_match_jax():
    _, pos, mask = S.molecules(5, 14, seed=14, spread=0.8)
    mask[3] = False  # a padded slot
    key = jax.random.PRNGKey(15)

    @jax.jit
    def jside(k, p, m):
        centers = jcp.sample_centers(k, m)
        dist, pm = jgeo.pairwise_distances(p, m)
        adj = jgeo.radius_adjacency(dist, pm, 1.8)
        hops = jcp.hop_distances(adj, centers, 7)
        return (centers, adj, hops, *jcp.context_masks(hops, m, 5, 4, 7))

    centers, adj, hops, *masks = map(np.asarray, jside(
        key, jnp.asarray(pos), jnp.asarray(mask)))
    index = centers.argmax(-1)
    got = O.sample_centers(None, t(mask), index=t(index))
    np.testing.assert_array_equal(got.numpy(), centers)
    drawn = O.sample_centers(torch.Generator().manual_seed(0), t(mask))
    real = mask.any(-1)
    assert (drawn.numpy()[real] * mask[real]).sum() == real.sum()
    got_hops = O.hop_distances(t(adj), got, 7)
    np.testing.assert_array_equal(got_hops.numpy(), hops)
    assert (hops == 8).any() and (hops > 1).any()
    for want, have in zip(masks, O.context_masks(got_hops, t(mask), 5, 4, 7)):
        np.testing.assert_array_equal(have.numpy(), want)


@pytest.mark.parametrize("neg", [1, 2])
def test_contextpred_loss_matches_jax_f64(neg):
    rng = np.random.default_rng(16)
    s, c = rng.normal(size=(6, F)), rng.normal(size=(6, F))
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    with S.x64():
        (want, jacc), (gs, gc) = vg(
            lambda a, b: jcp.contextpred_loss(a, b, jnp.asarray(valid), neg),
            argnums=(0, 1), has_aux=True)(jnp.asarray(s), jnp.asarray(c))
    st, ct = t(s).requires_grad_(True), t(c).requires_grad_(True)
    loss, acc = O.contextpred_loss(st, ct, t(valid), neg)
    loss.backward()
    close(loss.item(), float(want))
    np.testing.assert_allclose(acc.item(), float(jacc), rtol=1e-6)
    close(st.grad, gs, "dsubstruct")
    close(ct.grad, gc, "dcontext")
    with pytest.raises(ValueError, match="neg_samples"):
        O.contextpred_loss(st, ct, t(valid), 0)


# -- NCSN v1 / v2 ------------------------------------------------------------------


_NCSN = {"v1": (jncsn.NCSNv1, O.NCSNv1, TI.ncsn_v1_state_dict_from_flax),
         "v2": (jncsn.NCSNv2, O.NCSNv2, TI.ncsn_v2_state_dict_from_flax)}


@pytest.mark.parametrize("version", sorted(_NCSN))
def test_ncsn_v1_v2_match_jax_f64_with_its_draws(version):
    """The JAX head's own draws (its key split into the σ level and the
    noise) passed into the port's head."""
    jcls, tcls, to_port = _NCSN[version]
    _, pos, mask, h = _nodes(b=3, n=8, seed=17)
    mask[2] = False
    gm = mask.any(-1)
    n = mask.shape[1]
    sel = mask[:, :, None] & mask[:, None, :] & np.triu(np.ones((n, n), bool), 1)
    head = jcls(emb_dim=F, num_noise_level=10)
    key = jax.random.PRNGKey(18)
    @jax.jit
    def jside(k, p, m, hh):
        """The head's draws as its __call__ makes them, its loss and
        gradients."""
        dist, _ = jgeo.pairwise_distances(p, m)
        params = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64),
            head.init(k, k, jnp.zeros((2, n, F)), jnp.ones((2, n, n)),
                      jnp.ones((2, n, n), bool))["params"])
        k_sigma, k_noise = jax.random.split(k)
        sigmas = head.bind({"params": params})._sample_sigmas(k_sigma, 3)
        noise = jax.random.normal(k_noise, dist.shape, dist.dtype)
        want, grads = jax.value_and_grad(
            lambda q, x: head.apply({"params": q}, k, x, dist,
                                    jnp.asarray(sel), jnp.asarray(gm)),
            argnums=(0, 1))(params, hh)
        return dist, params, sigmas, noise, want, grads

    with S.x64():
        dist, params, sigmas, noise, want, (gp, gh) = jax.tree_util.tree_map(
            np.asarray, jside(key, jnp.asarray(pos), jnp.asarray(mask),
                              jnp.asarray(h)))
    assert sigmas.dtype == np.float32 and noise.dtype == np.float64
    port = tcls(emb_dim=F, num_noise_level=10).double()
    port.load_state_dict(to_port(params))
    ht = t(h).requires_grad_(True)
    loss = port(ht, t(dist), t(sel), t(gm), sigmas=t(sigmas), noise=t(noise))
    loss.backward()
    close(loss.item(), float(want))
    close(ht.grad, gh, "dh")
    check_module_grads(port, gp, to_port)
    # its own draws: finite, seeded
    g = torch.Generator().manual_seed(0)
    again = port(t(h), t(dist), t(sel), t(gm), generator=g)
    assert torch.isfinite(again)


# -- the package and contextpred's second backbone -----------------------------


def test_port_objectives_define_every_public_name_of_the_jax_package():
    import types

    import geossl_tpu.objectives as jobj

    names = {n for n, v in vars(jobj).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert names and not names - set(dir(O))


def test_contextpred_backbones_load_through_the_backbone_converter():
    """A contextpred tree's two backbones, each made by the JAX SchNet's
    init, load into the port's Baseline with strict=True and give the JAX
    outputs on a holed node mask."""
    from geossl_tpu.models.schnet import SchNet as JSchNet
    from geossl_tpu_torch.models.schnet import SchNet
    from geossl_tpu_torch.train.pretrain_baselines import Baseline

    z, pos, mask = S.molecules(3, 12, seed=19)
    hole = mask.copy()
    hole[0, 3:6] = False  # atoms switched off in the middle of a graph
    jm = JSchNet(**S.SMALL)
    with S.x64():
        init = jax.jit(jm.init)
        tree = {name: f64_tree(init(jax.random.PRNGKey(k), jnp.asarray(z),
                                    jnp.asarray(pos, jnp.float32),
                                    jnp.asarray(mask))["params"])
                for k, name in enumerate(("model", "context_model"))}
        apply = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(z),
                                           jnp.asarray(pos), jnp.asarray(hole)))
        want = {name: jax.tree_util.tree_map(np.asarray, apply(tree[name]))
                for name in tree}
    net = Baseline("contextpred", SchNet(**S.SMALL),
                   context_model=SchNet(**S.SMALL)).double()
    net.load_state_dict(TI.baseline_state_dict_from_flax("contextpred", tree,
                                                         "schnet"))
    with torch.no_grad():
        for name in tree:
            g, h = getattr(net, name)(t(z).long(), t(pos), t(hole))
            close(g, want[name][0], f"{name} graph")
            close(h, want[name][1], f"{name} nodes")
