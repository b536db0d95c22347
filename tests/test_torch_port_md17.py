"""The MD17 slice of geossl_tpu_torch against the JAX package on the CPU,
where every kernel wrapper takes its plain version. Every numeric case
runs in f64 at rtol 1e-10 (real f64 on the JAX side, inside ``S.x64``).

* Data, bitwise: ``build_md17`` on a raw npz written here (both raw names),
  the processed cache the JAX package saves, ``md17_split`` (the
  proportional fallback too), ``synthetic_md17``, an epoch of batches with
  forces, ``energy_mae``/``force_mae``.
* The second orders: ``cfconv_bwd_bwd``, ``cfconv_bwd_sym_bwd``,
  ``painn_bwd_bwd`` and ``painn_bwd_sym_bwd`` against the JAX package's XLA
  ``*_bwd_bwd`` (the VJP ``jax.vjp`` of ``_cfconv_bwd`` & co. returns; their
  Pallas primal does not run in f64), and the placement's transpose.
* The Functions' wiring: ``_CFConv``/``_PaiNNMessage`` and their backward
  Functions with plain stand-ins for the kernel launches (monkeypatched
  here; nothing in the package reaches them), a force loss's gradients
  against autograd through the plain chain, and the launch counts.
* The driver, both backbones: E, F, the loss, every gradient, a 4-step
  Adam trajectory and the eval MAEs against
  ``geossl_tpu.train.finetune_md17``; the step with kernel stand-ins
  against the plain step (two backward launches per block).
* The CLI: one epoch, ``--eval_only``, ``--resume``, and ``serve --mode
  forces`` on the ``model.pth`` it writes.
* The refusals that stay: the NCSN head and ``painn_stack_train``.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geossl_tpu.data import bucketing as jbucket
from geossl_tpu.data import md17 as jmd17
from geossl_tpu.data import splitters as jsplit
from geossl_tpu.data import synthetic as jsyn
from geossl_tpu.data.batch import DenseMolBatch as JBatch
from geossl_tpu.models.painn import PaiNN as JPaiNN
from geossl_tpu.models.schnet import SchNet as JSchNet
from geossl_tpu.ops import cfconv_pallas as jcf
from geossl_tpu.ops import painn_pallas as jpp
from geossl_tpu.parallel import mesh as pmesh
from geossl_tpu.train import common as jcommon
from geossl_tpu.train import finetune_md17 as jfm
from geossl_tpu.train import optim as joptim
from geossl_tpu.utils import metrics as jmetrics
from geossl_tpu.utils import torch_import as jtorch
from geossl_tpu_torch import serve
from geossl_tpu_torch.data import bucketing as tbucket
from geossl_tpu_torch.data import md17 as tmd17
from geossl_tpu_torch.data import splitters as tsplit
from geossl_tpu_torch.data import synthetic as tsyn
from geossl_tpu_torch.data.batch import DenseMolBatch
from geossl_tpu_torch.data.store import MolStore
from geossl_tpu_torch.models.common import cosine_cutoff, cosine_envelope
from geossl_tpu_torch.models.painn import PaiNN
from geossl_tpu_torch.models.schnet import SchNet
from geossl_tpu_torch.ops import _launch
from geossl_tpu_torch.ops import cfconv as tcf
from geossl_tpu_torch.ops import geometry as tgeo
from geossl_tpu_torch.ops import ncsn as tns
from geossl_tpu_torch.ops import painn as tpn
from geossl_tpu_torch.train import checkpoints, common, optim
from geossl_tpu_torch.train import finetune_md17 as FM
from geossl_tpu_torch.utils import metrics as tmetrics
from geossl_tpu_torch.utils.torch_import import (
    head_state_dict_from_flax,
    painn_state_dict_from_flax,
    schnet_state_dict_from_flax,
)
from tests import test_torch_port_painn as P
from tests import test_torch_port_schnet as S
from tests.test_torch_port_data import assert_same_store

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

EMB, G, CUT = 16, 8, 5.0
RTOL, ATOL = 1e-10, 1e-12


def assert_close(got, want, err_msg=""):
    got, want = (np.asarray(t.detach() if torch.is_tensor(t) else t)
                 for t in (got, want))
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max())),
                               err_msg=err_msg)


# -- data: identical output -------------------------------------------------------


def _write_raw(root, name, frames=4, n=5, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "raw"), exist_ok=True)
    np.savez(os.path.join(root, "raw", name),
             R=rng.normal(size=(frames, n, 3)), E=rng.normal(size=(frames, 1)),
             F=rng.normal(size=(frames, n, 3)),
             z=np.asarray([6, 1, 8, 7, 16])[:n])


@pytest.mark.parametrize("name", ["md17_aspirin.npz", "aspirin_dft.npz"])
def test_build_and_load_md17_match_jax(tmp_path, name):
    roots = [str(tmp_path / k) for k in ("jax", "port")]
    for r in roots:
        _write_raw(r, name)
    want = jmd17.build_md17(roots[0], "aspirin")
    got = tmd17.build_md17(roots[1], "aspirin")
    assert len(got) == 4 and got.forces.shape == (20, 3)
    assert_same_store(got, want)
    # the cache the JAX package saves is the port's
    jmd17.load_md17(roots[0], "aspirin")
    os.remove(os.path.join(roots[0], "raw", name))
    assert_same_store(tmd17.load_md17(roots[0], "aspirin"), want)
    assert tmd17.MD17_TASKS == jmd17.MD17_TASKS
    with pytest.raises(FileNotFoundError, match="synthetic=True") as e:
        tmd17.load_md17(str(tmp_path / "none"), "ethanol")
    with pytest.raises(FileNotFoundError) as j:
        jmd17.load_md17(str(tmp_path / "none"), "ethanol")
    assert str(e.value) == str(j.value)
    assert_same_store(tmd17.load_md17("", synthetic=True, synthetic_size=6),
                      jmd17.load_md17("", synthetic=True, synthetic_size=6))


@pytest.mark.parametrize("n", [1, 7, 50, 2000, 2400])
def test_md17_split_matches_jax(n):
    for seed in (42, 3):
        for g, w in zip(tsplit.md17_split(n, seed=seed),
                        jsplit.md17_split(n, seed=seed)):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_synthetic_md17_and_forces_loader_match_jax():
    for args in ((5,), (9, 7, 3)):
        assert_same_store(tsyn.synthetic_md17(*args), jsyn.synthetic_md17(*args))
    js = jsyn.synthetic_md17(13, n_atoms=9, seed=2)
    ts = MolStore(js.atom_type, js.positions, js.offsets, js.chirality,
                  js.bond_index, js.bond_offsets, js.y, js.forces)
    jl = jbucket.BucketedLoader(js, 5, (16, 32), shuffle=True, seed=3,
                                with_forces=True)
    tl = tbucket.BucketedLoader(ts, 5, (16, 32), seed=3, with_forces=True)
    jbs, tbs = list(jl.epoch(1)), list(tl.epoch(1))
    assert len(jbs) == len(tbs) == 3
    for jb, tb in zip(jbs, tbs):
        for name in ("atom_type", "positions", "node_mask", "graph_mask", "y",
                     "forces"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(getattr(jb, name)),
                                          err_msg=name)
    assert next(tbucket.BucketedLoader(ts, 5, (16,)).epoch(0)).forces is None


def test_energy_and_force_metrics_match_jax():
    rng = np.random.default_rng(0)
    e, pe = rng.normal(size=6), rng.normal(size=6)
    f, pf = rng.normal(size=(6, 4, 3)), rng.normal(size=(6, 4, 3))
    free = (rng.random((6, 4)) > 0.3).astype(float)
    free[:, 0] = 1.0
    assert tmetrics.energy_mae(pe, e) == jmetrics.energy_mae(pe, e)
    assert tmetrics.force_mae(pf, f, free) == jmetrics.force_mae(pf, f, free)


# -- the second orders against the JAX package's ----------------------------------


def _sym(c, anti=False):
    """A pair cotangent symmetric (antisymmetric) in its last two axes, as a
    chain through the positions gives it."""
    return c - np.swapaxes(c, -1, -2) if anti else c + np.swapaxes(c, -1, -2)


def _cfconv_case(seed):
    d, e, x, w = S._pair_inputs(2, 12, seed, np.float64, f=EMB, g=G)
    rng = np.random.default_rng(seed + 5)
    g = rng.normal(size=x.shape)
    outs = (d, e, x, *w)  # the backward's outputs have the inputs' shapes
    cts = [rng.normal(size=np.shape(t)) for t in outs]
    return (d, e, x, g, *w), cts


def _painn_case(seed):
    args = P._pair_case(3, 12, seed, np.float64)  # slot 2 an empty graph
    gq, gmu = P._cotangents(3, 12, seed, np.float64)
    rng = np.random.default_rng(seed + 5)
    cts = [rng.normal(size=np.shape(t)) for t in args]
    return (*args, gq, gmu), cts


def _jax_second(fn, consts, res, cts):
    """The JAX package's second order at f64, in the port's order."""
    with S.x64():
        out = jax.jit(fn, static_argnums=tuple(range(len(consts))))(
            *consts, tuple(map(jnp.asarray, res)),
            tuple(map(jnp.asarray, cts)))
        return [np.asarray(a) for a in out]


@pytest.mark.parametrize("symmetric", [False, True], ids=["plain", "sym"])
def test_cfconv_second_order_matches_jax(symmetric):
    (d, e, x, g, *w), cts = _cfconv_case(seed=4)
    if symmetric:  # (the two packages place on different tiles)
        cts[0], cts[1] = _sym(cts[0]), _sym(cts[1])
    cts[4], cts[6] = cts[4].reshape(-1), cts[6].reshape(-1)
    jfn = jcf._cfconv_sym_bwd_bwd if symmetric else jcf._cfconv_bwd_bwd
    want = _jax_second(jfn, (0.0, CUT, G, "f32", False),
                       (d, e, x, *w, g), cts)
    want = [*want[:3], want[7], *want[3:7]]  # (dist, env, x, g, W1..b2)
    port = tcf.cfconv_bwd_sym_bwd if symmetric else tcf.cfconv_bwd_bwd
    got = port(*map(torch.from_numpy, (d, e, x, g, *w)),
               tuple(map(torch.from_numpy, cts)), 0.0, CUT, G)
    for k, (a, b) in enumerate(zip(got, want)):
        assert_close(a, b.reshape(a.shape), err_msg=str(k))


@pytest.mark.parametrize("symmetric", [False, True], ids=["plain", "sym"])
def test_painn_second_order_matches_jax(symmetric):
    res, cts = _painn_case(seed=6)
    if symmetric:
        cts[:5] = [_sym(c, anti=k >= 2) for k, c in enumerate(cts[:5])]
    jfn = jpp._painn_sym_bwd_bwd if symmetric else jpp._painn_bwd_bwd
    want = _jax_second(jfn, (CUT, False), res, cts)
    port = tpn.painn_bwd_sym_bwd if symmetric else tpn.painn_bwd_bwd
    got = port(*map(torch.from_numpy, res), tuple(map(torch.from_numpy, cts)),
               CUT)
    assert len(got) == len(res) == 11
    for k, (a, b) in enumerate(zip(got, want)):
        assert_close(a, b.reshape(a.shape), err_msg=str(k))


def _transpose_place(c, anti=False):
    """The transpose of ``place_sym_cotangent`` written out per cell: a
    cell on or above the diagonal tiles reads itself, a cell below reads
    its mirror (negated for an antisymmetric field)."""
    t = np.arange(c.shape[-1]) // tcf.KERNEL_TILE
    lower = t[:, None] > t[None, :]
    mirror = np.swapaxes(c, -1, -2)
    return np.where(lower, -mirror if anti else mirror, c)


def test_sym_second_orders_apply_the_placements_transpose():
    """With arbitrary pair cotangents, the symmetric second order is the
    plain one of the transposed cotangents (N=12: two 8x8 tile rows)."""
    (d, e, x, g, *w), cts = _cfconv_case(seed=8)
    t = lambda a: tuple(map(torch.from_numpy, a))  # noqa: E731
    got = tcf.cfconv_bwd_sym_bwd(*t((d, e, x, g, *w)), t(cts), 0.0, CUT, G)
    moved = [_transpose_place(c) for c in cts[:2]] + cts[2:]
    want = tcf.cfconv_bwd_bwd(*t((d, e, x, g, *w)), t(moved), 0.0, CUT, G)
    for a, b in zip(got, want):
        assert_close(a, b)
    res, cts = _painn_case(seed=9)
    got = tpn.painn_bwd_sym_bwd(*t(res), t(cts), CUT)
    moved = [_transpose_place(c, k >= 2) for k, c in enumerate(cts[:5])]
    want = tpn.painn_bwd_bwd(*t(res), t(moved + cts[5:]), CUT)
    for a, b in zip(got, want):
        assert_close(a, b)


# -- the Functions' wiring, with plain stand-ins for the launches ------------------


def _split_like_kernel(grads, k):
    """The weight gradients from k on as one flat buffer, as the kernels'
    launchers return them."""
    return (*grads[:k], torch.cat([t.reshape(-1) for t in grads[k:]]))


def kernel_stand_ins(monkeypatch):
    """The CUDA launches of ops/cfconv and ops/painn replaced by their plain
    versions (the symmetric backwards' pair cotangents placed, as the
    kernels return them), and every wrapper taking its kernel route: the
    Functions run on the CPU as they run on the card. Returns the second
    orders' call counts; the launch counters start at 0."""
    second = {}

    def fwd_cf(dist, env, x, w1, b1, w2, b2, start, stop, num_g, sym, sparse,
               mxu="f32"):
        return tcf.cfconv_fused_reference(dist, env, x, w1, b1, w2, b2, start,
                                          stop, num_g, mxu)

    def bwd_cf(dist, env, x, g, w1, b1, w2, b2, start, stop, num_g, sym,
               sparse, mxu="f32"):
        out = list(tcf.cfconv_bwd_reference(dist, env, x, g, w1, b1, w2, b2,
                                            start, stop, num_g, mxu))
        if sym:
            out[:2] = [tcf.place_sym_cotangent(c) for c in out[:2]]
        return _split_like_kernel(out, 3)

    def fwd_pn(dist, gate, dirx, diry, dirz, x, mu, wk, bk, cutoff, sym,
               sparse):
        # the C entry's results and its count of kernel launches
        return (*tpn.painn_message_reference(dist, gate, dirx, diry, dirz, x,
                                             mu, wk, bk, cutoff), 1)

    def bwd_pn(*args):
        *args, cutoff, sym, sparse = args
        out = list(tpn.painn_bwd_reference(*args, cutoff))
        if sym:
            out[:5] = [tcf.place_sym_cotangent(c, k >= 2)
                       for k, c in enumerate(out[:5])]
        return (*_split_like_kernel(out, 7), 1)

    def counting(mod, name):
        real = getattr(mod, name)

        def fn(*a):
            second[name] = second.get(name, 0) + 1
            return real(*a)
        monkeypatch.setattr(mod, name, fn)

    for mod, fwd, bwd, names in (
            (tcf, fwd_cf, bwd_cf, ("_cfconv_fwd_kernel", "_cfconv_bwd_kernel")),
            (tpn, fwd_pn, bwd_pn, ("_painn_fwd_kernel", "_painn_bwd_kernel"))):
        monkeypatch.setattr(mod, "on_cpu", lambda *a: False)
        monkeypatch.setattr(mod, names[0], fwd)
        monkeypatch.setattr(mod, names[1], bwd)
    for mod, names in ((tcf, ("cfconv_bwd_bwd", "cfconv_bwd_sym_bwd")),
                       (tpn, ("painn_bwd_bwd", "painn_bwd_sym_bwd"))):
        for name in names:
            counting(mod, name)
    _launch.reset_launch_counts()
    return second


def _op_chain(op, kind, seed):
    """Gradients to the positions and the other inputs of a force loss
    through ``op`` on pair grids made from the positions (f64): E = sum of
    tanh of the messages, F = -dE/dpos with a graph, loss = E + sum F^2."""
    z, pos, mask = S.molecules(2, 12, seed, spread=1.1)
    pos = torch.from_numpy(pos).requires_grad_(True)
    mask = torch.from_numpy(mask)
    rng = np.random.default_rng(seed)
    if kind == "cfconv":
        d, pm = tgeo.pairwise_distances(pos, mask)
        env = cosine_envelope(d, CUT) * tgeo.radius_adjacency(d, pm, CUT)
        pair = (d, env)
        shapes = [(2, 12, EMB), (G, EMB), (EMB,), (EMB, EMB), (EMB,)]
    else:
        d, direction, pm = tgeo.pairwise_directions(pos, mask)
        gate = cosine_cutoff(d, CUT) * tgeo.radius_adjacency(d, pm, CUT)
        pair = (d, gate, *(direction[..., c] for c in range(3)))
        shapes = [(2, 12, 3 * EMB)] * 2 + [(P.R, 3 * EMB), (3 * EMB,)]
    ins = [torch.from_numpy(rng.normal(scale=0.4, size=s)).requires_grad_(True)
           for s in shapes]
    out = op(*(t.contiguous() for t in pair), *ins)
    out = torch.cat(out, -1) if isinstance(out, tuple) else out
    e = torch.tanh(out).sum()
    (grad,) = torch.autograd.grad(e, pos, create_graph=True)
    loss = e + (grad * grad).sum()
    return torch.autograd.grad(loss, [pos] + ins)


_OPS = {
    "cfconv": lambda *a: tcf.cfconv(*a, 0.0, CUT, G, symmetric=False),
    "cfconv_sym": lambda *a: tcf.cfconv(*a, 0.0, CUT, G, symmetric=True),
    "painn": lambda *a: tpn.painn_message_fused(*a, CUT),
    "painn_sym": lambda *a: tpn.painn_message_fused_sym(*a, CUT),
}
_LAUNCHES = {"cfconv": ("cfconv_fwd", "cfconv_bwd", "cfconv_bwd_bwd"),
             "cfconv_sym": ("cfconv_fwd_sym", "cfconv_bwd_sym",
                            "cfconv_bwd_sym_bwd"),
             "painn": ("painn_fwd", "painn_bwd", "painn_bwd_bwd"),
             "painn_sym": ("painn_fwd_sym", "painn_bwd_sym",
                           "painn_bwd_sym_bwd")}


@pytest.mark.parametrize("case", sorted(_OPS))
def test_functions_double_backward_matches_plain_chain(case, monkeypatch):
    """The kernel Functions' double backward (each launch stood in for by
    its plain version) against autograd through the plain chain: the
    position gradient and every input's. The forward launches once, the
    backward kernel twice (the force, then the loss's replay), the second
    order once."""
    kind = case.split("_")[0]
    want = _op_chain(_OPS[case], kind, seed=11)  # the CPU: plain versions
    second = kernel_stand_ins(monkeypatch)
    got = _op_chain(_OPS[case], kind, seed=11)
    fwd, bwd, bwd_bwd = _LAUNCHES[case]
    counts = _launch.launch_counts()
    assert (counts[fwd], counts[bwd], second.get(bwd_bwd)) == (1, 2, 1)
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all()
        assert_close(a.numpy(), b.numpy(), err_msg=str(k))


# -- the driver in f64 -------------------------------------------------------------

_BACKBONES = {
    "schnet": (lambda: JSchNet(**S.SMALL), lambda: SchNet(**S.SMALL),
               schnet_state_dict_from_flax, contextlib.nullcontext),
    "painn": (lambda: JPaiNN(**P.SMALL), lambda: PaiNN(**P.SMALL),
              painn_state_dict_from_flax, P.f64_casts),
}


def _batch(seed, n=12):
    """Three padded molecules of uneven sizes (the last slot empty), the
    energy and force labels."""
    z, pos, mask = S.molecules(3, n, seed=seed, spread=1.2)
    mask[2], z[2], pos[2] = False, 0, 0.0
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(3, 1))
    forces = rng.normal(size=(3, n, 3)) * mask[..., None]
    return z, pos, mask, mask.any(axis=1), y, forces


def _jax_batch(b):
    return JBatch(atom_type=jnp.asarray(b[0]), positions=jnp.asarray(b[1]),
                  node_mask=jnp.asarray(b[2]), graph_mask=jnp.asarray(b[3]),
                  y=jnp.asarray(b[4]), forces=jnp.asarray(b[5]))


def _port_batch(b):
    return DenseMolBatch(atom_type=torch.from_numpy(b[0]).long(),
                         positions=torch.from_numpy(b[1]),
                         node_mask=torch.from_numpy(b[2]),
                         graph_mask=torch.from_numpy(b[3]),
                         y=torch.from_numpy(b[4]),
                         forces=torch.from_numpy(b[5]))


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def epoch(self, _):
        return iter(self.batches)


@pytest.fixture(scope="module", params=sorted(_BACKBONES))
def md17_case(request):
    """The JAX driver's side of one backbone at f64: its E/F, loss and
    gradients, a 4-step Adam trajectory (its loss's value_and_grad and
    ``common.apply_updates``, the driver's ``step_body``) and the eval MAEs
    (its ``evaluate``); and the port's net with the same weights (a seeded
    port init carried to the JAX package by its ``torch_import``)."""
    model_3d = request.param
    make_jax, make_port, to_port, jax_ctx = _BACKBONES[model_3d]
    steps = [_batch(60 + s) for s in range(4)]
    jm = make_jax()
    head = jcommon.make_head(model_3d, EMB)
    lr, decay = 5e-3, 0.01
    torch.manual_seed(9)
    seeded = FM.LBANet(make_port(), common.make_head(model_3d, EMB))
    from_torch = {"schnet": jtorch.schnet_params_from_torch,
                  "painn": jtorch.painn_params_from_torch}[model_3d]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), {
        "model": from_torch(seeded.model.state_dict()),
        "graph_pred_linear": jtorch.head_params_from_torch(
            seeded.graph_pred_linear.state_dict())})
    with S.x64(), jax_ctx():
        def backbone_apply(p, atom_type, positions, node_mask):
            return jm.apply({"params": p}, atom_type, positions, node_mask)

        ef = jfm.make_energy_force_fn(backbone_apply, head)

        def loss_fn(p, batch):  # the closure of finetune_md17.py:66-78
            e, f = ef(p, batch)
            gm = batch.graph_mask.astype(jnp.float32)
            e_loss = jnp.sum(jnp.abs(e - batch.y[:, 0]) * gm) / jnp.maximum(
                gm.sum(), 1.0)
            nm = batch.node_mask.astype(jnp.float32)[..., None]
            f_loss = jnp.sum(jnp.abs(f - batch.forces) * nm) / jnp.maximum(
                3.0 * nm.sum(), 1.0)
            return 0.05 * e_loss + 0.95 * f_loss, (e, f)

        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        jbatches = [_jax_batch(s) for s in steps]
        (loss, (e, f)), grads = vg(params, jbatches[0])
        # the eval batches as the steps' (numpy: one compiled vg serves)
        val = jfm.evaluate(
            lambda p, b: vg(p, jax.tree_util.tree_map(np.asarray, b))[0][1],
            params, _Loader(jbatches[:2]), pmesh.make_mesh(1))
        tx = joptim.make_optimizer(lr, 2, 2, decay, "CosineAnnealingLR")
        state = jcommon.TrainState.create(
            jax.tree_util.tree_map(jnp.asarray, params), tx)
        update = jax.jit(lambda st, g: jcommon.apply_updates(st, g, tx))
        traj = []
        for b in jbatches:
            (step_loss, _), g = vg(state.params, b)
            state = update(state, g)
            traj.append(float(step_loss))
        final = jax.tree_util.tree_map(np.asarray, state.params)
        want = dict(e=np.asarray(e), f=np.asarray(f), loss=float(loss),
                    grads=jax.tree_util.tree_map(np.asarray, grads), val=val,
                    traj=traj, final=final)

    def as_port(tree):
        sd = {f"model.{k}": v for k, v in to_port(tree["model"]).items()}
        sd.update({f"graph_pred_linear.{k}": v for k, v in
                   head_state_dict_from_flax(tree["graph_pred_linear"]).items()})
        return sd

    def port_net(plain):
        net = FM.LBANet(make_port(), common.make_head(model_3d, EMB),
                        plain=plain).double()
        net.load_state_dict(as_port(params))
        return net

    # PaiNN: the JAX model's XLA path, whose port is plain=True
    return dict(model_3d=model_3d, want=want, as_port=as_port,
                port_net=port_net, plain=model_3d == "painn", steps=steps,
                lr=lr, decay=decay)


def test_md17_energy_force_loss_and_gradients_match_jax_f64(md17_case):
    c, want = md17_case, md17_case["want"]
    net = c["port_net"](c["plain"])
    batch = _port_batch(c["steps"][0])
    e, f = FM.energy_and_force(net, batch)
    assert_close(e.detach().numpy(), want["e"], "E")
    assert_close(f.numpy(), want["f"], "F")
    # padded atoms and the empty slot: zero force, finite
    assert (f[~batch.node_mask] == 0).all()
    loss = FM.make_loss_fn(0.05, 0.95)(net, batch)
    loss.backward()
    assert_close(loss.item(), want["loss"], "loss")
    jgrad = c["as_port"](want["grads"])
    named = dict(net.named_parameters())
    assert sorted(named) == sorted(jgrad)
    for name, p in named.items():
        assert torch.isfinite(p.grad).all(), name
        assert_close(p.grad.numpy(), jgrad[name].numpy(), name)
    ev = FM.make_evaluate("cpu")(net, _Loader([_port_batch(s)
                                               for s in c["steps"][:2]]))
    assert_close([ev["e_mae"], ev["f_mae"]], list(want["val"]), "eval")


def test_md17_adam_trajectory_matches_jax_f64(md17_case):
    c, want = md17_case, md17_case["want"]
    net = c["port_net"](c["plain"])
    opt, sched = optim.make_optimizer(net.parameters(), c["lr"], 2, 2,
                                      c["decay"], "CosineAnnealingLR")
    loss_fn = FM.make_loss_fn(0.05, 0.95)
    got = [common.finetune_step(net, opt, sched, [_port_batch(s)],
                                loss_fn).item() for s in c["steps"]]
    assert_close(got, want["traj"], "losses")
    final = c["as_port"](want["final"])
    for name, p in net.named_parameters():
        assert_close(p.detach().numpy(), final[name].numpy(), name)


def test_md17_step_through_kernel_functions_matches_plain_step(md17_case,
                                                               monkeypatch):
    """The driver's step on the kernel route (each launch stood in for by
    its plain version: SchNet's symmetric CFConv pair, PaiNN's message
    pass) against the same step on the CPU's plain versions: the loss and
    every gradient, and per step two launches of the backward kernel and
    one second order per block."""
    c = md17_case
    batch = _port_batch(c["steps"][1])
    loss_fn = FM.make_loss_fn(0.05, 0.95)
    results = []
    for stand_in in (False, True):
        if stand_in:
            second = kernel_stand_ins(monkeypatch)
        net = c["port_net"](False)
        loss = loss_fn(net, batch)
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone()
                                      for n, p in net.named_parameters()}))
    (lk, gk), (lp, gp) = results[1], results[0]
    assert_close(lk, lp, "loss")
    for name in gp:
        assert_close(gk[name].numpy(), gp[name].numpy(), name)
    n_blocks = 2
    fwd, bwd, bwd_bwd = _LAUNCHES[{"schnet": "cfconv_sym",
                                   "painn": "painn"}[c["model_3d"]]]
    counts = _launch.launch_counts()
    assert (counts[fwd], counts[bwd], second.get(bwd_bwd)) == \
        (n_blocks, 2 * n_blocks, n_blocks)


# -- the CLI on the CPU ------------------------------------------------------------

TINY = ["--emb_dim", "16", "--num_filters", "16", "--num_interactions", "2",
        "--num_gaussians", "8", "--painn_n_rbf", "8",
        "--painn_n_interactions", "2"]


def _argv(out, *extra):
    return ["--device", "cpu", "--synthetic", "--synthetic_size", "20",
            "--output_model_dir", str(out), *TINY, *extra]


@pytest.mark.parametrize("model_3d", ["schnet", "painn"])
def test_md17_cli_on_cpu(tmp_path, capsys, monkeypatch, model_3d):
    extra = ["--model_3d", model_3d]
    net, best, test_at_best, losses = FM.main(_argv(tmp_path, "--epochs", "1",
                                                    *extra))
    out = capsys.readouterr().out
    assert "Epoch: 1\tLoss" in out and "val E/F MAE" in out
    assert "best val force MAE" in out
    # 8 training frames at batch 5
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert np.isfinite(best) and np.isfinite(test_at_best).all()
    for name in ("model.pth", "model_final.pth"):
        saved = checkpoints.load_checkpoint(str(tmp_path / name))
        assert set(saved) == {"model", "graph_pred_linear"}
    # --eval_only gives the best epoch's val F MAE again
    _, val_f, test_ef, none = FM.main(_argv(
        tmp_path / "eval", "--eval_only", "--input_model_file",
        str(tmp_path / "model.pth"), *extra))
    assert none == [] and "eval-only (aspirin)" in capsys.readouterr().out
    np.testing.assert_allclose([val_f, *test_ef], [best, *test_at_best],
                               rtol=1e-6)
    # --resume runs only the epoch left
    _, _, _, more = FM.main(_argv(tmp_path, "--epochs", "2", "--resume",
                                  *extra))
    assert "Resumed from" in capsys.readouterr().out and len(more) == 2
    # serve --mode forces on model.pth: the driver's E and F on the test
    # split, in store order
    args = FM.build_parser().parse_args(_argv(tmp_path, *extra))
    test = FM.load_splits(args)[2]
    path = tmp_path / "test.npz"
    test.save(str(path))
    csv = tmp_path / "forces.csv"
    # the CLI serves a backbone at its default widths; this one is tiny
    cfg = common.model_config_from_args(args)
    monkeypatch.setattr(serve, "ModelConfig", lambda model_3d: cfg)
    serve.main(["--ckpt", str(tmp_path / "model.pth"), "--model_3d", model_3d,
                "--input", str(path), "--mode", "forces", "--output", str(csv),
                "--device", "cpu", "--bucket", "32"])
    rows = csv.read_text().splitlines()
    net = FM.make_net(args, cfg, torch.Generator())
    common.load_input_model(
        FM.build_parser().parse_args(["--input_model_file",
                                      str(tmp_path / "model.pth")]), net)
    batch = tbucket.pack_batch([test.get(i) for i in range(len(test))], 32)
    e, f = FM.energy_and_force(net, batch)
    assert len(rows) == len(test)
    for i, row in enumerate(rows):
        idx, energy, fx = row.split(",", 2)
        assert int(idx) == i
        np.testing.assert_allclose(float(energy), e[i].item(), rtol=1e-5,
                                   atol=1e-6)
        forces = np.asarray([[float(v) for v in atom.split(",")]
                             for atom in fx.split(";")])
        n = test.num_atoms()[i]
        np.testing.assert_allclose(forces, f[i, :n].numpy(), rtol=1e-4,
                                   atol=1e-5 * float(f.abs().max()))


def test_predict_forces_keeps_the_flat_atom_layout():
    """Two buckets, several chunks, partial ones: the Predictor's E and F
    against energy_and_force per molecule, at the store's flat offsets."""
    cfg = common.model_config_from_args(FM.build_parser().parse_args(TINY))
    gen = torch.Generator().manual_seed(0)
    state = {"model": common.make_backbone(cfg, gen).state_dict(),
             "graph_pred_linear": common.make_head("schnet", EMB,
                                                   gen).state_dict(),
             "y_mean": 0.5, "y_std": 2.0}
    store = tsyn.synthetic_qm9(21, seed=3)
    pred = serve.Predictor(cfg, state, batch_size=8, bucket_sizes=(16, 32),
                           device="cpu")
    energies, forces = pred.predict_forces(store)
    assert forces.shape == (store.offsets[-1], 3)
    for i in (0, 7, 20):
        rec = store.get(i)
        pos = torch.from_numpy(rec.positions)[None].requires_grad_(True)
        g, _ = pred.model(torch.from_numpy(rec.atom_type)[None].long(), pos,
                          torch.ones(1, rec.num_atoms, dtype=torch.bool))
        e = pred.head(g) * 2.0 + 0.5
        (grad,) = torch.autograd.grad(e.sum(), pos)
        np.testing.assert_allclose(energies[i], e.item(), rtol=1e-5)
        s, t = store.offsets[i], store.offsets[i + 1]
        np.testing.assert_allclose(forces[s:t], -grad[0].numpy(), rtol=1e-4,
                                   atol=1e-6)
    assert all(not p.requires_grad for p in pred.model.parameters())


# -- the refusals that stay --------------------------------------------------------


def test_second_order_still_refused_by_the_ncsn_head_and_the_stack():
    """The JAX package has no second order through either: the NCSN head
    (``ncsn_score_bwd``) and the differentiable PaiNN stack raise when
    autograd asks their backward for a graph."""
    from types import SimpleNamespace

    with torch.enable_grad(), pytest.raises(
            NotImplementedError, match="ncsn_score_bwd is first order"):
        tns._NCSNScore.backward(SimpleNamespace(), torch.zeros(2, 8))
    pair, q0, stacked = (lambda p, q, s: (p, q.requires_grad_(True), s))(
        *_stack_inputs())
    q, _ = tpn.painn_stack_train(*pair, q0, stacked, CUT)
    with pytest.raises(NotImplementedError,
                       match="painn_stack_train is first order") as e:
        torch.autograd.grad(q.square().sum(), q0, create_graph=True)
    assert "MD17" not in str(e.value)


def _stack_inputs():
    from tests import test_torch_port_painn_sym_stack as PS

    return PS._stack_inputs(np.float32)
