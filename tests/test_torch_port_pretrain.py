"""The pretraining drivers of geossl_tpu_torch beyond DDM against the JAX
package on the CPU, where every kernel wrapper takes its plain version.

* For each of the nine objectives (GeoSSL InfoNCE, EBM_NCE and RR; the
  baselines supervised, charge, distance, torsion, InfoGraph and
  ContextPred) and both backbones: the driver module's loss and every
  gradient on one batch against the JAX loss, built from the JAX package's
  public pieces as its drivers build it, in f64 (real f64 on the JAX side,
  inside x64) at rtol 1e-10, with the JAX draws passed in. The JAX side
  runs each backbone's forward and its VJP once per shape (jitted) and
  chains them with each objective's jitted loss: the chain rule the
  driver's ``value_and_grad`` applies. PaiNN's f32 casts read as f64
  (``test_torch_port_painn.f64_casts``) and the port runs its ``plain``
  path, as the DDM tests do.
* 4-step Adam trajectories: RR with its BatchNorm statistics carried from
  step to step, ``--gnn_2d_lr_scale`` and ``--grad_accum 2`` (each
  microbatch sees the statistics the one before it left), and charge.
* Both CLIs on the CPU: every objective's ``model.pth`` served by a
  ``Predictor``; ``--resume``, whose state carries RR's statistics; the
  refusals.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geossl_tpu.models.painn import PaiNN as JPaiNN
from geossl_tpu.models.schnet import SchNet as JSchNet
from geossl_tpu.objectives import autoencoder as jae
from geossl_tpu.objectives import contextpred as jcp
from geossl_tpu.objectives import contrastive as jcl
from geossl_tpu.objectives import heads as jheads
from geossl_tpu.objectives import infograph as jig
from geossl_tpu.objectives import pairs as jpairs
from geossl_tpu.ops import geometry as jgeo
from geossl_tpu.train import common as jcommon
from geossl_tpu.train import optim as joptim
from geossl_tpu_torch.config import ModelConfig, PaiNNConfig, SchNetConfig
from geossl_tpu_torch.data.batch import DenseMolBatch
from geossl_tpu_torch.data.synthetic import synthetic_molecule3d
from geossl_tpu_torch.models.painn import PaiNN
from geossl_tpu_torch.models.schnet import SchNet
from geossl_tpu_torch.objectives import AutoEncoder, DistancePredictor
from geossl_tpu_torch.objectives import ChargePredictor, InfoGraphDiscriminator
from geossl_tpu_torch.objectives import TorsionAnglePredictor
from geossl_tpu_torch.serve import Predictor
from geossl_tpu_torch.train import checkpoints, common, optim
from geossl_tpu_torch.train import pretrain_baselines as PB
from geossl_tpu_torch.train import pretrain_geossl as PG
from geossl_tpu_torch.utils import torch_import as TI
from tests import test_torch_port_painn as P
from tests import test_torch_port_schnet as S

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

EMB = 16
RTOL, ATOL = 1e-10, 1e-12
B, N, T = 4, 16, 10
CTX = dict(context_hops=2, context_csize=2, context_bond_cutoff=1.8,
           contextpred_neg_samples=2)


def t(a):
    return torch.from_numpy(np.array(a))


def f64_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def make_batch(seed):
    """B=4 molecules at N=16, the last slot empty; y [B, 8]."""
    z, pos, mask = S.molecules(B, N, seed=seed, spread=1.1)
    mask[-1], z[-1], pos[-1] = False, 0, 0.0
    y = np.random.default_rng(seed).normal(size=(B, 8)).astype(np.float32)
    y[-1] = 0.0
    return dict(z=z, pos=pos, mask=mask, gm=mask.any(1), y=y)


def port_batch(d):
    return DenseMolBatch(atom_type=t(d["z"]).long(), positions=t(d["pos"]),
                         node_mask=t(d["mask"]), y=t(d["y"]),
                         graph_mask=t(d["gm"]))


class JaxBackbone:
    """The JAX backbone's forward and its VJP (both jitted, traced once per
    shape) in f64; ``extra`` = (pair_mask,) for PaiNN's clean graph."""

    def __init__(self, model_3d):
        self.painn = model_3d == "painn"
        self.module = JPaiNN(**P.SMALL) if self.painn else JSchNet(**S.SMALL)
        self.ctx = P.f64_casts if self.painn else contextlib.nullcontext
        self.to_port = (TI.painn_state_dict_from_flax if self.painn
                        else TI.schnet_state_dict_from_flax)

        def apply(p, z, pos, mask, extra):
            return self.module.apply({"params": p}, z, pos, mask, *extra)

        self._init = jax.jit(self.module.init)
        self._fwd = jax.jit(apply)
        self._bwd = jax.jit(lambda p, z, pos, mask, extra, ct: jax.vjp(
            lambda q: apply(q, z, pos, mask, extra), p)[1](ct)[0])

    def init(self, seed):
        d = make_batch(0)
        with S.x64():
            return f64_tree(self._init(
                jax.random.PRNGKey(seed), jnp.asarray(d["z"]),
                jnp.asarray(d["pos"], jnp.float32), jnp.asarray(d["mask"]))
                ["params"])

    def fwd(self, p, z, pos, mask, extra=()):
        with self.ctx():
            return self._fwd(p, z, pos, mask, extra)

    def bwd(self, p, z, pos, mask, ct, extra=()):
        with self.ctx():
            return self._bwd(p, z, pos, mask, extra, ct)

    def clean_graph(self, d):
        """PaiNN's pair mask of both views: the clean geometry's radius
        graph (``pretrain_GeoSSL.py:88-89``); none for SchNet."""
        if not self.painn:
            return ()
        return (_clean_graph(jnp.asarray(d["pos"]), jnp.asarray(d["mask"])),)

    def port(self):
        return PaiNN(**P.SMALL) if self.painn else SchNet(**S.SMALL)


@jax.jit
def _clean_graph(pos, mask):
    dist, pm = jgeo.pairwise_distances(pos, mask)
    return jgeo.radius_adjacency(dist, pm, P.CUT)


@contextlib.contextmanager
def x32():
    """x64 off for a block inside ``S.x64``."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


@functools.lru_cache(maxsize=None)
def jax_backbone(model_3d):
    """One JaxBackbone per backbone: its jitted functions compile once."""
    return JaxBackbone(model_3d)


def add(a, b):
    return jax.tree_util.tree_map(lambda x, y: np.asarray(x) + np.asarray(y),
                                  a, b)


def head_vg(fn):
    """value_and_grad over (head params, the backbone outputs), jitted."""
    return jax.jit(jax.value_and_grad(fn, argnums=(0, 1), has_aux=True))


# -- the JAX side of each objective -----------------------------------------
# Each takes (JaxBackbone, params, batch dict, draw) inside x64 and returns
# (loss, acc, grads): the JAX drivers' loss_fn, chained through the VJP.


def _single_view(jb, params, d, z, vg, *data):
    """One forward of the batch (atom types ``z``), then the jitted
    ``vg(head_params, (g, h), *data)``."""
    zz, pos, mask = jnp.asarray(z), jnp.asarray(d["pos"]), jnp.asarray(d["mask"])
    g, h = jb.fwd(params["model"], zz, pos, mask)
    (loss, acc), (gh, gout) = vg(params["head"], (g, h), *data)
    gm = jb.bwd(params["model"], zz, pos, mask, gout)
    return loss, acc, {"model": gm, "head": gh}


# the heads' losses take their data as arguments: each compiles once


@head_vg
def _supervised_vg(hp_, outs, y, gm):
    pred = jcommon.LinearHead().apply({"params": hp_}, outs[0])
    return jcommon.graph_masked_mean(jnp.abs(pred - y), gm), jnp.zeros(())


@head_vg
def _charge_vg(hp_, outs, z, sel):
    logits = jheads.ChargePredictor(9).apply({"params": hp_}, outs[1])
    return jheads.charge_loss(logits, z, sel)


@head_vg
def _distance_vg(hp_, outs, dist, sel):
    pred = jheads.DistancePredictor().apply({"params": hp_}, outs[1])
    return jheads.distance_loss(pred, dist, sel), jnp.zeros(())


@head_vg
def _torsion_vg(hp_, outs, idx, angle, valid):
    pred = jheads.TorsionAnglePredictor().apply({"params": hp_}, outs[1], idx)
    return jheads.torsion_loss(pred, angle, valid), jnp.zeros(())


@head_vg
def _infograph_vg(hp_, outs, mask, gm):
    g, h = outs
    return jig.infograph_loss(jig.InfoGraphDiscriminator(hidden_dim=EMB), hp_,
                              h, g, mask, gm)


def jax_supervised(jb, params, d, draw, hp):
    y = (jnp.asarray(d["y"])[:, hp["task_id"]] - hp["train_mean"]) / hp["train_std"]
    return _single_view(jb, params, d, d["z"], _supervised_vg, y,
                        jnp.asarray(d["gm"]))


# the objectives' draws and pair data, jitted (each eager op compiles)
_charge_masking = jax.jit(lambda key, z, mask: jheads.charge_masking(
    key, z, mask, 0.3, 9))
_distance_data = jax.jit(lambda pos, mask: (
    jgeo.pairwise_distances(pos, mask)[0],
    jpairs.pair_selection(mask, "permutation")))
_torsion_triples = jax.jit(lambda key, pos, mask: jheads.torsion_triples(
    key, pos, mask, T))


def jax_charge(jb, params, d, draw, hp):
    z = jnp.asarray(d["z"])
    masked, sel = _charge_masking(draw, z, jnp.asarray(d["mask"]))
    return _single_view(jb, params, d, masked, _charge_vg, z, sel)


def jax_distance(jb, params, d, draw, hp):
    dist, sel = _distance_data(jnp.asarray(d["pos"]), jnp.asarray(d["mask"]))
    return _single_view(jb, params, d, d["z"], _distance_vg, dist, sel)


def jax_torsion(jb, params, d, draw, hp):
    triples = _torsion_triples(draw, jnp.asarray(d["pos"]),
                               jnp.asarray(d["mask"]))
    return _single_view(jb, params, d, d["z"], _torsion_vg, *triples)


def jax_infograph(jb, params, d, draw, hp):
    return _single_view(jb, params, d, d["z"], _infograph_vg,
                        jnp.asarray(d["mask"]), jnp.asarray(d["gm"]))


@functools.partial(jax.jit, static_argnums=(5,))
@functools.partial(jax.value_and_grad, argnums=(0, 1), has_aux=True)
def _contextpred_vg(_, outs, centers, ov, valid, neg):
    s_node, c_node = outs
    substruct = jnp.einsum("bnf,bn->bf", s_node, centers)
    context = (jnp.einsum("bnf,bn->bf", c_node, ov)
               / jnp.maximum(ov.sum(-1, keepdims=True), 1.0))
    return jcp.contextpred_loss(substruct, context, valid, neg)


@jax.jit
def _context_data(key, pos, mask):
    dist, pm = jgeo.pairwise_distances(pos, mask)
    return (jgeo.radius_adjacency(dist, pm, CTX["context_bond_cutoff"]),
            jcp.sample_centers(key, mask))


def jax_contextpred(jb, params, d, draw, hp):
    z, pos = jnp.asarray(d["z"]), jnp.asarray(d["pos"])
    mask, gm = jnp.asarray(d["mask"]), jnp.asarray(d["gm"])
    k = hp["context_hops"]
    l1, l2 = k - 1, k - 1 + hp["context_csize"]
    bond_adj, centers = _context_data(draw, pos, mask)
    with x32():  # its int32 scan carry meets int64 step indices under x64
        hops = jnp.asarray(jcp.hop_distances(np.asarray(bond_adj),
                                             np.asarray(centers), l2))
    sub_mask, ctx_mask, ov_mask = jcp.context_masks(hops, mask, k, l1, l2)
    _, sub_node = jb.fwd(params["model"], z, pos, sub_mask)
    _, ctx_node = jb.fwd(params["context_model"], z, pos, ctx_mask)
    ov = ov_mask.astype(jnp.float32)
    valid = gm & (ov_mask.sum(-1) > 0)
    (loss, acc), (_, (gs, gc)) = _contextpred_vg(
        {}, (sub_node, ctx_node), centers, ov, valid,
        hp["contextpred_neg_samples"])
    zero = jnp.zeros_like(sub_node[:, 0])
    return loss, acc, {
        "model": jb.bwd(params["model"], z, pos, sub_mask, (zero, gs)),
        "context_model": jb.bwd(params["context_model"], z, pos, ctx_mask,
                                (zero, gc))}


def jax_two_views(jb, params, d, pos2, option, stats=None, normalize=False,
                  detach=True):
    """InfoNCE, EBM_NCE, RR: both views through the one backbone (PaiNN on
    the clean graph), then the option's loss on the graph representations.
    Returns (loss, accuracy or RR's new batch_stats, grads)."""
    z, mask = jnp.asarray(d["z"]), jnp.asarray(d["mask"])
    extra = jb.clean_graph(d)
    views = (jnp.asarray(d["pos"]), jnp.asarray(pos2))
    outs = [jb.fwd(params["model"], z, p, mask, extra) for p in views]
    heads = {k: v for k, v in params.items() if k != "model"}
    (loss, aux), (gh, gg) = ssl_loss(option, normalize, detach)(
        heads, tuple(g for g, _ in outs), jnp.asarray(d["gm"]), stats)
    gm = None
    for p, (g, h), ct in zip(views, outs, gg):
        gv = jb.bwd(params["model"], z, p, mask, (ct, jnp.zeros_like(h)),
                    extra)
        gm = gv if gm is None else add(gm, gv)
    return loss, aux, {"model": gm, **gh}


@functools.lru_cache(maxsize=None)
def ssl_loss(option, normalize, detach=True, num_neg=2, T=0.1):
    """The JAX driver's loss of ``option`` on (g1, g2), its value and its
    gradients in (head params, graphs), jitted once."""
    ae = jae.AutoEncoder(emb_dim=EMB, loss="l2", detach_target=detach)

    def f(heads, graphs, gmask, stats):
        g1, g2 = graphs
        if normalize:
            g1, g2 = jcl.l2_normalize(g1), jcl.l2_normalize(g2)
        if option == "InfoNCE":
            return jcl.dual_infonce_loss(g1, g2, T, gmask)
        if option == "EBM_NCE":
            return jcl.ebm_nce_loss(g1, g2, gmask, num_neg=num_neg)
        out1 = ae.apply({"params": heads["AE_01"], "batch_stats": stats["AE_01"]},
                        g1, g2, gmask, train=True, mutable=["batch_stats"])
        out2 = ae.apply({"params": heads["AE_02"], "batch_stats": stats["AE_02"]},
                        g2, g1, gmask, train=True, mutable=["batch_stats"])
        return (out1[0] + out2[0]) / 2, {"AE_01": out1[1]["batch_stats"],
                                         "AE_02": out2[1]["batch_stats"]}

    return head_vg(f)


# -- the cases -----------------------------------------------------------------


def baseline_hp(objective, d):
    return {"supervised": dict(task_id=6, loss="mae", train_mean=0.25,
                               train_std=1.5),
            "charge": dict(charge_masking_ratio=0.3),
            # the driver's default: every ordered pair (the subsampled
            # selection is held in test_torch_port_objectives.py)
            "distance": dict(distance_sample_ratio=1.0),
            "torsion": dict(num_triples=T),
            "infograph": {},
            "contextpred": CTX}[objective]


_BASELINES = {"supervised": jax_supervised, "charge": jax_charge,
              "distance": jax_distance, "torsion": jax_torsion,
              "infograph": jax_infograph, "contextpred": jax_contextpred}


def jax_head_init(objective, rng):
    z = jnp.zeros((2, 3, EMB))
    init = {
        "supervised": lambda: jcommon.LinearHead().init(rng, z[:, 0]),
        "charge": lambda: jheads.ChargePredictor(9).init(rng, z),
        "distance": lambda: jheads.DistancePredictor().init(rng, z),
        "torsion": lambda: jheads.TorsionAnglePredictor().init(
            rng, z, jnp.zeros((2, 2, 3), jnp.int32)),
        "infograph": lambda: jig.InfoGraphDiscriminator(EMB).init(rng, z, z),
    }[objective]
    return f64_tree(init()["params"])


def port_head(objective):
    return {"supervised": lambda: common.LinearHead(EMB),
            "charge": lambda: ChargePredictor(EMB, 9),
            "distance": lambda: DistancePredictor(EMB),
            "torsion": lambda: TorsionAnglePredictor(EMB),
            "infograph": lambda: InfoGraphDiscriminator(EMB)}[objective]()


def draw_of(objective, key, d):
    """The draw the JAX driver makes from ``key`` (call inside x64, as the
    JAX loss runs), as the port's ``Baseline`` takes it."""
    if objective == "charge":
        return jax.random.uniform(key, d["mask"].shape, jnp.float32)
    if objective == "torsion":
        return jax.random.uniform(key, (B, T, 3))
    if objective == "contextpred":
        return jcp.sample_centers(key, jnp.asarray(d["mask"])).argmax(-1)
    return None


@pytest.fixture(scope="module", params=["schnet", "painn"])
def backbone(request):
    jb = jax_backbone(request.param)
    return jb, jb.init(3), jb.init(4)


def check_grads(module, want):
    named = dict(module.named_parameters())
    assert sorted(named) == sorted(want)
    for name, p in named.items():
        close(p.grad.numpy(), want[name].numpy(), name)


def baseline_case(jb, model_params, ctx_params, objective, d, key):
    """(JAX params, port Baseline with them, JAX (loss, acc, grads))."""
    hp = baseline_hp(objective, d)
    params = {"model": model_params}
    if objective == "contextpred":
        params["context_model"] = ctx_params
    else:
        params["head"] = jax_head_init(objective, jax.random.PRNGKey(5))
    with S.x64():
        want = _BASELINES[objective](jb, params, d, key, hp)
        want = jax.tree_util.tree_map(np.asarray, want)
    net = PB.Baseline(objective, jb.port(),
                      None if objective == "contextpred" else port_head(objective),
                      jb.port() if objective == "contextpred" else None,
                      plain=jb.painn, **hp).double()
    net.load_state_dict(TI.baseline_state_dict_from_flax(
        objective, params, "painn" if jb.painn else "schnet"))
    return params, net, want


@pytest.mark.parametrize("objective", sorted(_BASELINES))
def test_baseline_loss_and_every_gradient_match_jax_f64(backbone, objective):
    jb, p_model, p_ctx = backbone
    d = make_batch(21)
    key = jax.random.PRNGKey(8)
    params, net, (want, jacc, jgrads) = baseline_case(jb, p_model, p_ctx,
                                                      objective, d, key)
    with S.x64():
        draw = draw_of(objective, key, d)
    loss, acc = net(port_batch(d), draw=None if draw is None else t(draw))
    loss.backward()
    close(loss.item(), want)
    np.testing.assert_allclose(acc.item(), jacc, rtol=1e-6)
    check_grads(net, TI.baseline_state_dict_from_flax(
        objective, jgrads, "painn" if jb.painn else "schnet"))
    if objective == "contextpred":
        holed_masks_checked(d, draw)


def holed_masks_checked(d, index):
    """The test batch gives contextpred what it is for: graphs with a
    nonempty overlap, and substruct and context masks that are no prefix of
    a graph's atoms (holes in the middle)."""
    from geossl_tpu_torch.objectives import contextpred as C

    mask = t(d["mask"])
    dist, pm = S.tgeo.pairwise_distances(t(d["pos"]), mask)
    adj = S.tgeo.radius_adjacency(dist, pm, CTX["context_bond_cutoff"])
    k = CTX["context_hops"]
    hops = C.hop_distances(adj, C.sample_centers(None, mask, t(index)),
                           k - 1 + CTX["context_csize"])
    sub, ctx, ov = C.context_masks(hops, mask, k, k - 1,
                                   k - 1 + CTX["context_csize"])
    assert (ov.sum(-1) > 0).sum() >= 2

    def holed(m):
        n = m.sum(-1, keepdim=True)
        return (m != (torch.arange(N) < n)).any(-1)

    assert holed(sub).any() and holed(ctx).any()


def ssl_params(jb, model_params, option, rng):
    params, stats = {"model": model_params}, None
    if option == "RR":
        ae = jae.AutoEncoder(emb_dim=EMB)
        stats = {}
        for i, name in enumerate(("AE_01", "AE_02")):
            v = jax.jit(ae.init)(jax.random.fold_in(rng, i), jnp.zeros((2, EMB)),
                                 jnp.zeros((2, EMB)))
            params[name] = f64_tree(v["params"])
            stats[name] = f64_tree(v["batch_stats"])
    return params, stats


def ssl_state_dict(tree, stats, jb):
    sd = {f"model.{k}": v for k, v in jb.to_port(tree["model"]).items()}
    for name in ("AE_01", "AE_02"):
        if name in tree:
            sd.update({f"{name}.{k}": v for k, v in
                       TI.autoencoder_state_dict_from_flax(
                           tree[name], None if stats is None else stats[name]
                       ).items()})
    return sd


def port_ssl(jb, option, params, stats, normalize, detach=True):
    aes = ([AutoEncoder(EMB, detach_target=detach) for _ in range(2)]
           if option == "RR" else [None, None])
    net = PG.GraphSSL(jb.port(), option, 0.1, 2, normalize, *aes,
                      plain=jb.painn).double()
    net.load_state_dict(ssl_state_dict(params, stats, jb))
    return net


@pytest.mark.parametrize("option,normalize", [("InfoNCE", True),
                                              ("EBM_NCE", False),
                                              ("RR", True)])
def test_geossl_option_loss_and_every_gradient_match_jax_f64(backbone, option,
                                                             normalize):
    jb, p_model, _ = backbone
    d = make_batch(22)
    pos2 = d["pos"] + np.random.default_rng(3).normal(scale=0.3,
                                                      size=d["pos"].shape)
    params, stats = ssl_params(jb, p_model, option, jax.random.PRNGKey(6))
    net = port_ssl(jb, option, params, stats, normalize)
    with S.x64():
        loss_j, aux, grads = jax_two_views(jb, params, d, pos2, option,
                                           stats, normalize)
        loss_j, aux, grads = jax.tree_util.tree_map(np.asarray,
                                                    (loss_j, aux, grads))
    loss, acc = net(port_batch(d), t(pos2))
    loss.backward()
    close(loss.item(), loss_j)
    check_grads(net, ssl_state_dict(grads, None, jb))
    if option == "RR":
        want = ssl_state_dict(params, aux, jb)
        for k, v in net.state_dict().items():
            if "running" in k:
                close(v, want[k], k)
        assert acc.item() == 0.0
    else:
        np.testing.assert_allclose(acc.item(), aux, rtol=1e-6)


# -- Adam trajectories ---------------------------------------------------------


def adam_step(tx):
    """(grads, opt_state, params) -> (new params as numpy, new state),
    jitted."""
    @jax.jit
    def step(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    def run(grads, opt_state, params):
        params, opt_state = step(grads, opt_state, params)
        return jax.tree_util.tree_map(np.asarray, params), opt_state

    return run


def test_rr_adam_trajectory_with_accum_and_lr_scale_matches_jax_f64():
    """4 optimizer steps of 2 microbatches each (``--grad_accum 2``), the
    AEs at ``--gnn_2d_lr_scale`` 0.02 (an absolute lr against --lr 5e-3),
    a per-epoch cosine over 2 epochs of 2 steps; the statistics run through
    every microbatch in order.

    RR has parameters whose gradient is zero in exact arithmetic: the bias
    before each AE's BatchNorm (the normalisation removes it) and, with the
    target detached (the default), the backbone's last bias (it shifts every
    graph representation alike, which AE_01's BatchNorm removes, while it
    moves the detached target's value). Their computed gradients are
    rounding noise (~1e-17), which Adam (eps 1e-8) turns into steps of
    ~lr·1e-9 that differ between the two packages, and weight decay grows
    them to ~1e-6 within two steps. So the target is not detached here
    (``--no_detach_target``: the backbone's last bias then has a gradient;
    the single-step tests cover the detached default), and the two pre-BN
    biases, noise-driven on both sides (weight decay turns the noise into
    full Adam steps of either sign), are held to a noise gradient and to
    the bound of 4 steps at their group's lr instead of to each other; the
    BatchNorm running means, which they enter, are compared less each
    side's own biases' share."""
    lr, decay, scale = 5e-3, 0.01, 0.02
    jb = jax_backbone("schnet")
    params, stats = ssl_params(jb, jb.init(3), "RR", jax.random.PRNGKey(7))
    net = port_ssl(jb, "RR", params, stats, False, detach=False)
    batches = [make_batch(30 + k) for k in range(8)]
    pos2 = [d["pos"] + np.random.default_rng(40 + k).normal(
        scale=0.3, size=d["pos"].shape) for k, d in enumerate(batches)]
    f = scale / lr
    aes = ("AE_01", "AE_02")
    with S.x64():
        tx = joptim.make_optimizer(lr, 2, 2, decay, "CosineAnnealingLR",
                                   group_lr_factors={"AE_01": f, "AE_02": f})
        opt_state = tx.init(params)
        update = adam_step(tx)
        want, zero_grad, jbias = [], None, []
        for s in range(4):
            jbias.append({a: params[a]["Dense_0"]["bias"] for a in aes})
            gsum, lsum = None, 0.0
            for k in (2 * s, 2 * s + 1):
                loss, stats, g = jax_two_views(jb, params, batches[k],
                                               pos2[k], "RR", stats,
                                               detach=False)
                gsum = g if gsum is None else add(gsum, g)
                lsum += float(loss)
            grads = jax.tree_util.tree_map(lambda a: a / 2, gsum)
            noise = {k for k, v in ssl_state_dict(grads, None, jb).items()
                     if float(v.abs().max()) < 1e-14}
            zero_grad = noise if zero_grad is None else zero_grad & noise
            params, opt_state = update(grads, opt_state, params)
            want.append(lsum / 2)
        stats = jax.tree_util.tree_map(np.asarray, stats)
    assert zero_grad == {f"{a}.fc_layers.0.bias" for a in aes}
    groups = optim.param_groups(dict(net.named_children()), lr,
                                {"AE_01": f, "AE_02": f})
    opt, sched = optim.make_optimizer(groups, lr, 2, 2, decay,
                                      "CosineAnnealingLR")
    got, tbias = [], []
    for s in range(4):
        tbias.append({a: getattr(net, a).fc_layers[0].bias.detach().clone()
                      for a in aes})
        micro = [(port_batch(batches[k]), t(pos2[k])) for k in (2 * s, 2 * s + 1)]
        got.append(common.pretrain_step(net, opt, sched, micro,
                                        lambda bp: net(*bp))[0].item())
    np.testing.assert_allclose(got, want, rtol=RTOL)
    final = ssl_state_dict(params, stats, jb)
    sd = net.state_dict()
    assert sorted(sd) == sorted(final)

    def without_bias(running_mean, bias):
        """The running mean less what the pre-BN bias put into it: the
        bias of step s entered microbatches 2s and 2s+1 with weight
        (1 - m)·m^(7 - k) (m = 0.99)."""
        out = np.array(running_mean, np.float64)
        for k in range(8):
            out = out - 0.01 * 0.99 ** (7 - k) * np.asarray(bias[k // 2])
        return out

    for name, v in sd.items():
        a = name.split(".")[0]
        if name in zero_grad:
            grad = dict(net.named_parameters())[name].grad
            assert float(grad.abs().max()) < 1e-14
            assert float(v.abs().max()) <= 4 * scale
            assert float(final[name].abs().max()) <= 4 * scale
        elif name.endswith("running_mean"):
            close(without_bias(v, [b[a] for b in tbias]),
                  without_bias(final[name], [b[a] for b in jbias]), name)
        else:
            close(v, final[name], name)
    assert opt.param_groups[1]["lr"] == pytest.approx(
        scale * sched.lr_lambdas[0](sched.last_epoch))


def test_charge_adam_trajectory_matches_jax_f64():
    lr, decay = 5e-3, 0.01
    jb = jax_backbone("schnet")
    params = {"model": jb.init(3),
              "head": jax_head_init("charge", jax.random.PRNGKey(5))}
    net = PB.Baseline("charge", jb.port(), ChargePredictor(EMB, 9),
                      **baseline_hp("charge", None)).double()
    net.load_state_dict(TI.baseline_state_dict_from_flax("charge", params,
                                                         "schnet"))
    batches = [make_batch(50 + s) for s in range(4)]
    keys = [jax.random.PRNGKey(60 + s) for s in range(4)]
    with S.x64():
        tx = joptim.make_optimizer(lr, 2, 2, decay, "CosineAnnealingLR")
        opt_state = tx.init(params)
        update = adam_step(tx)
        want = []
        for d, key in zip(batches, keys):
            loss, _, grads = jax_charge(jb, params, d, key, None)
            params, opt_state = update(grads, opt_state, params)
            want.append(float(loss))
    opt, sched = optim.make_optimizer(net.parameters(), lr, 2, 2, decay,
                                      "CosineAnnealingLR")
    got = [common.pretrain_step(
        net, opt, sched, [port_batch(d)],
        lambda b, u=t(draw_of("charge", key, d)): net(b, draw=u))[0].item()
        for d, key in zip(batches, keys)]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    final = TI.baseline_state_dict_from_flax("charge", params, "schnet")
    for name, p in net.named_parameters():
        close(p.detach(), final[name], name)


def test_group_lr_factors_refused_under_anchored_schedules():
    w = torch.nn.Linear(2, 2)
    groups = optim.param_groups({"model": w}, 1e-3, {"model": 2.0})
    assert groups[0]["lr"] == 2e-3
    for scheduler in ("CosineAnnealingWarmRestarts", "ReduceLROnPlateau"):
        with pytest.raises(ValueError, match="not torch-exact"):
            optim.make_optimizer(optim.param_groups({"model": w}, 1e-3,
                                                    {"model": 2.0}),
                                 1e-3, 2, 2, scheduler=scheduler)
        with pytest.raises(ValueError, match="not torch-exact"):
            joptim.make_optimizer(1e-3, 2, 2, scheduler=scheduler,
                                  group_lr_factors={"model": 2.0})


# -- the CLIs ------------------------------------------------------------------


TINY = ["--device", "cpu", "--synthetic", "--synthetic_size", "16",
        "--synthetic_max_atoms", "40", "--emb_dim", "16", "--num_filters",
        "16", "--num_interactions", "2", "--num_gaussians", "8",
        "--batch_size", "8", "--painn_n_interactions", "2", "--painn_n_rbf",
        "8", "--epochs", "1"]
_CFG = {"schnet": ModelConfig(emb_dim=16, schnet=SchNetConfig(
            hidden_channels=16, num_filters=16, num_interactions=2,
            num_gaussians=8)),
        "painn": ModelConfig(model_3d="painn", emb_dim=16, painn=PaiNNConfig(
            n_atom_basis=16, n_interactions=2, n_rbf=8))}
_RUNS = [("geossl", "InfoNCE", "painn"), ("geossl", "EBM_NCE", "schnet"),
         ("geossl", "RR", "painn"), ("baseline", "supervised", "painn"),
         ("baseline", "charge", "schnet"), ("baseline", "distance", "painn"),
         ("baseline", "torsion", "schnet"), ("baseline", "infograph", "painn"),
         ("baseline", "contextpred", "schnet")]


def run_cli(driver, objective, out, *extra):
    if driver == "geossl":
        return PG.main(["--GeoSSL_option", objective, "--output_model_dir",
                        str(out), *TINY, *extra])
    return PB.main([objective, "--output_model_dir", str(out), *TINY, *extra])


@pytest.mark.parametrize("driver,objective,model_3d", _RUNS,
                         ids=[r[1] for r in _RUNS])
def test_cli_on_cpu_writes_model_pth_that_serves(tmp_path, capsys, driver,
                                                 objective, model_3d):
    module, losses = run_cli(driver, objective, tmp_path, "--model_3d",
                             model_3d)
    assert len(losses) >= 2 and np.isfinite(losses).all()
    line = "SSL Loss" if driver == "geossl" else "Loss"
    out = capsys.readouterr().out
    assert f"Epoch: 1\t{line}" in out
    for name in ("model.pth", "model_final.pth", "state.pth"):
        assert os.path.exists(tmp_path / name), name
    pred = Predictor.from_checkpoint(str(tmp_path / "model_final.pth"),
                                     _CFG[model_3d], device="cpu",
                                     bucket_sizes=(32, 64))
    emb = pred.embed(synthetic_molecule3d(16, max_atoms=40))
    assert emb.shape == (16, 16) and np.isfinite(emb).all()
    for k, v in pred.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      module.model.state_dict()[k].numpy())
    assert sorted(checkpoints.load_checkpoint(str(tmp_path / "model.pth"))) \
        == ["model"]


@pytest.mark.parametrize("driver,objective", [("geossl", "RR"),
                                              ("baseline", "contextpred")])
def test_cli_resume_carries_every_module_and_buffer(tmp_path, capsys, driver,
                                                    objective):
    """state.pth holds the whole module (RR's BatchNorm statistics,
    contextpred's second backbone); --resume runs only the epochs left."""
    module, losses = run_cli(driver, objective, tmp_path)
    state = checkpoints.load_train_state(str(tmp_path / "state.pth"))[0]
    saved = next(iter(state["modules"].values()))
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(saved[k].numpy(), v.numpy(), err_msg=k)
    if objective == "RR":
        assert not torch.equal(saved["AE_01.fc_layers.1.running_var"],
                               torch.ones(16))
    else:
        assert any(k.startswith("context_model.") for k in saved)
    _, more = run_cli(driver, objective, tmp_path, "--epochs", "2",
                      "--resume")
    assert "Resumed from" in capsys.readouterr().out
    assert len(more) == len(losses)


def test_cli_refusals():
    with pytest.raises(SystemExit, match="usage"):
        PB.main(["attrmask"])
    with pytest.raises(ValueError, match="no variance"):
        PB.label_stats(type("S", (), {"y": np.ones((4, 8), np.float32)}), 6)
    with pytest.raises(NotImplementedError, match="profile_dir"):
        run_cli("baseline", "charge", "", "--profile_dir", "trace")
