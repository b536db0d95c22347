"""The port's host runtime beyond the packer, on the CPU: ``parallel/mesh.
prefetch``; ``--steps_per_call`` (``train/common.ChainStep``, eager on the
CPU; CUDA graphs on the card, held there by ``chip_smoke.py``'s
``graph_parity:``) against the JAX package's ``make_chain_step`` in f64 at
rtol 1e-10 (QM9 with PaiNN, DDM with SchNet) and against single steps of
the port; the resume state's portable optimizer form; ``check_chain_args``;
``--profile_dir``.
"""

import os
import threading
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geossl_tpu.models.schnet import SchNet as JSchNet
from geossl_tpu.objectives.ncsn import NCSNv3 as JNCSNv3
from geossl_tpu.ops import geometry as jgeo
from geossl_tpu.train import common as jcommon
from geossl_tpu.train import finetune_qm9 as jqm9_driver
from geossl_tpu.train import optim as joptim
from geossl_tpu_torch.data.batch import DenseMolBatch
from geossl_tpu_torch.models.schnet import SchNet
from geossl_tpu_torch.objectives.ncsn import NCSNv3
from geossl_tpu_torch.parallel.mesh import prefetch
from geossl_tpu_torch.train import common, optim
from geossl_tpu_torch.train import finetune_qm9 as FQ
from geossl_tpu_torch.train import pretrain_geossl as PG
from geossl_tpu_torch.utils.torch_import import (
    head_state_dict_from_flax,
    ncsn_state_dict_from_flax,
    schnet_state_dict_from_flax,
)
from tests import test_torch_port_qm9 as Q
from tests import test_torch_port_schnet as S
from tests import test_torch_port_train as T

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

EMB = 16
LR, DECAY = 5e-3, 0.01

# -- prefetch ---------------------------------------------------------------------


def _batches(n):
    for i in range(n):
        yield DenseMolBatch(atom_type=torch.full((2, 4), i),
                            positions=torch.full((2, 4, 3), float(i)),
                            node_mask=torch.ones(2, 4, dtype=torch.bool))


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "geossl-prefetch"]


def test_prefetch_yields_the_plain_loops_batches_in_order():
    got = list(prefetch(_batches(7), "cpu", size=2))
    assert [int(b.atom_type[0, 0]) for b in got] == list(range(7))
    for g, w in zip(got, _batches(7)):
        assert torch.equal(g.positions, w.positions)


def test_prefetch_raises_the_producers_error():
    def failing():
        yield from _batches(2)
        raise KeyError("broken store")

    it = prefetch(failing(), "cpu")
    assert int(next(it).atom_type[0, 0]) == 0
    assert int(next(it).atom_type[0, 0]) == 1
    with pytest.raises(KeyError, match="broken store"):
        next(it)


def test_prefetch_stops_its_thread_when_abandoned():
    before = len(_prefetch_threads())
    it = prefetch(_batches(1000), "cpu", size=2)
    next(it)
    assert len(_prefetch_threads()) == before + 1
    it.close()  # as a `break` in a driver's loop, or garbage collection
    deadline = time.time() + 5.0
    while len(_prefetch_threads()) > before and time.time() < deadline:
        time.sleep(0.01)
    assert len(_prefetch_threads()) == before


# -- --steps_per_call: QM9 (PaiNN) against make_chain_step, f64 ----------------------


@pytest.fixture(scope="module")
def qm9_painn():
    """The JAX side of the QM9 driver's step with PaiNN in f64 (params, the
    backbone apply, the head), three batches, and the port's net."""
    make_jax, make_port, to_port, jax_ctx = Q._BACKBONES["painn"]
    steps = [Q._batch(70 + s) for s in range(3)]
    jm, head = make_jax(), jcommon.make_head("painn", EMB)
    with S.x64():
        k1, k2 = jax.random.split(jax.random.PRNGKey(4))
        z, pos, mask = (jnp.asarray(a) for a in steps[0][:3])
        params = {"model": jax.jit(jm.init)(k1, z, pos.astype(jnp.float32),
                                            mask)["params"],
                  "graph_pred_linear": head.init(
                      k2, jnp.zeros((2, EMB)))["params"]}
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        params)

    def port_net():
        net = FQ.QM9Net(make_port(), common.make_head("painn", EMB),
                        plain=True).double()
        net.model.load_state_dict(to_port(params["model"]))
        net.graph_pred_linear.load_state_dict(
            head_state_dict_from_flax(params["graph_pred_linear"]))
        return net

    def as_port(tree):
        sd = {f"model.{k}": v for k, v in to_port(tree["model"]).items()}
        sd.update({f"graph_pred_linear.{k}": v for k, v in
                   head_state_dict_from_flax(tree["graph_pred_linear"]).items()})
        return sd

    def apply_(p, atom_type, positions, node_mask):
        return jm.apply({"params": p}, atom_type, positions, node_mask)

    return dict(jax_ctx=jax_ctx, apply=apply_, head=head, params=params,
                steps=steps, port_net=port_net, as_port=as_port)


def _port_chain(net, body_of, steps_per_call, items):
    """The port's steps over ``items``: ``--steps_per_call`` k as one
    ChainStep call per group of k, 1 as single optimizer steps."""
    opt, sched = optim.make_optimizer(net.parameters(), LR, 2, 2, DECAY,
                                      "CosineAnnealingLR")
    body = body_of(net)
    if steps_per_call == 1:
        return torch.cat([common.optimizer_step(opt, sched, body, [it])[None]
                          for it in items]), opt, sched
    chain = common.ChainStep(opt, sched, body, "cpu", [net])
    return torch.cat([chain(items[s:s + steps_per_call])
                      for s in range(0, len(items), steps_per_call)]), opt, sched


def test_qm9_chain_matches_jax_make_chain_step_f64(qm9_painn):
    """One --steps_per_call 3 call (Adam with weight decay, per-epoch cosine
    over 2 epochs of 2 steps: the lr changes inside the call) against the
    JAX driver's chain_step on the same batches; then against three single
    steps of the port, bitwise."""
    c = qm9_painn
    with S.x64(), c["jax_ctx"]():
        tx = joptim.make_optimizer(LR, 2, 2, DECAY, "CosineAnnealingLR")
        state = jcommon.TrainState.create(
            jax.tree_util.tree_map(jnp.asarray, c["params"]), tx)
        _, _, chain_step = jqm9_driver.make_train_step(c["apply"], c["head"],
                                                       tx, "mae")
        stacked = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *[Q._jax_batch(s) for s in c["steps"]])
        state, want = chain_step(state, stacked, 3, Q.MEAN, Q.STD)
        want = np.asarray(want)
        final = c["as_port"](jax.tree_util.tree_map(np.asarray, state.params))

    def body_of(net):
        return common.finetune_body(net, FQ.make_loss_fn("mae", Q.MEAN, Q.STD))

    batches = [Q._port_batch(s) for s in c["steps"]]
    net = c["port_net"]()
    got, _, sched = _port_chain(net, body_of, 3, batches)
    assert sched.last_epoch == 3
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    single = c["port_net"]()
    got1, _, _ = _port_chain(single, body_of, 1, batches)
    assert torch.equal(got1, got)
    for (name, p), q in zip(net.named_parameters(), single.parameters()):
        assert torch.equal(p, q), name


# -- --steps_per_call: DDM (SchNet) against make_chain_step, f64 ---------------------


@dataclass
class _DDMStep:
    """One DDM step's inputs with its draws injected (the JAX draws)."""
    pos2: torch.Tensor
    draws: tuple


@pytest.fixture(scope="module")
def ddm_schnet():
    z, pos, mask = S.molecules(3, 16, seed=23, spread=1.2)
    mask[2], z[2], pos[2] = False, 0, 0.0
    gm = mask.any(axis=1)
    n = pos.shape[1]
    sel = mask[:, :, None] & mask[:, None, :] & np.triu(np.ones((n, n), bool), 1)
    jm, head = JSchNet(**S.SMALL), JNCSNv3(emb_dim=EMB)
    with S.x64():
        k = jax.random.split(jax.random.PRNGKey(5), 3)
        params = {"model": jax.jit(jm.init)(
            k[0], jnp.asarray(z), jnp.asarray(pos, jnp.float32),
            jnp.asarray(mask))["params"]}
        h = jnp.zeros((3, n, EMB))
        init_head = jax.jit(head.init)
        for name, key in (("NCSN_01", k[1]), ("NCSN_02", k[2])):
            params[name] = init_head(key, key, h, jnp.ones((3, n, n)),
                                     jnp.asarray(sel))["params"]
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        params)

    def jax_loss(p, pos2, draws):  # as test_torch_port_train's DDM loss
        zz, mm, gg = jnp.asarray(z), jnp.asarray(mask), jnp.asarray(gm)
        _, h1 = jm.apply({"params": p["model"]}, zz, jnp.asarray(pos), mm)
        _, h2 = jm.apply({"params": p["model"]}, zz, pos2, mm)
        d1, _ = jgeo.pairwise_distances(jnp.asarray(pos), mm)
        d2, _ = jgeo.pairwise_distances(pos2, mm)
        s1, n1, s2, n2 = draws
        l1 = head.apply({"params": p["NCSN_01"]}, None, h1, d2,
                        jnp.asarray(sel), gg, sigmas=s1, noise=n1)
        l2 = head.apply({"params": p["NCSN_02"]}, None, h2, d1,
                        jnp.asarray(sel), gg, sigmas=s2, noise=n2)
        return (l1 + l2) / 2

    def port():
        ddm = PG.DDM(SchNet(**S.SMALL), NCSNv3(emb_dim=EMB),
                     NCSNv3(emb_dim=EMB)).double()
        ddm.model.load_state_dict(schnet_state_dict_from_flax(params["model"]))
        for name in ("NCSN_01", "NCSN_02"):
            getattr(ddm, name).load_state_dict(
                ncsn_state_dict_from_flax(params[name]))
        return ddm

    batch = DenseMolBatch(atom_type=torch.from_numpy(z).long(),
                          positions=torch.from_numpy(pos),
                          node_mask=torch.from_numpy(mask),
                          graph_mask=torch.from_numpy(gm))
    steps = [T._step_inputs(pos, mask, 10 + s) for s in range(3)]
    return dict(params=params, jax_loss=jax_loss, port=port, batch=batch,
                sel=torch.from_numpy(sel), steps=steps)


def test_ddm_chain_matches_jax_make_chain_step_f64(ddm_schnet):
    c = ddm_schnet
    with S.x64():
        tx = joptim.make_optimizer(LR, 2, 2, DECAY, "CosineAnnealingLR")
        params = jax.tree_util.tree_map(jnp.asarray, c["params"])
        vg = jax.value_and_grad(c["jax_loss"])

        def step_body(state, inputs):
            p, opt_state = state
            loss, g = vg(p, *inputs)
            updates, opt_state = tx.update(g, opt_state, p)
            return (optax.apply_updates(p, updates), opt_state), loss

        chain = jax.jit(jcommon.make_chain_step(step_body),
                        static_argnums=(2,))
        stacked = (jnp.stack([jnp.asarray(p2) for p2, _ in c["steps"]]),
                   tuple(jnp.stack([jnp.asarray(d[i]) for _, d in c["steps"]])
                         for i in range(4)))
        (params, _), want = chain((params, tx.init(params)), stacked, 3)
        want = np.asarray(want)
        final = T._as_port_state(jax.tree_util.tree_map(np.asarray, params),
                                 schnet_state_dict_from_flax)
    items = [_DDMStep(torch.from_numpy(p2),
                      tuple(torch.from_numpy(np.asarray(d)) for d in draws))
             for p2, draws in c["steps"]]

    def body_of(ddm):
        def loss(item):
            value = ddm(c["batch"], item.pos2, c["sel"], item.draws)
            return value, torch.zeros((), dtype=value.dtype)
        return common.pretrain_body(loss)

    ddm = c["port"]()
    got, _, _ = _port_chain(ddm, body_of, 3, items)
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=1e-10)
    for name, p in ddm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    single = c["port"]()
    got1, _, _ = _port_chain(single, body_of, 1, items)
    assert torch.equal(got1, got)
    for (name, p), q in zip(ddm.named_parameters(), single.parameters()):
        assert torch.equal(p, q), name


# -- the schedule under graphs, the resume state ------------------------------------


def test_scheduled_lrs_are_the_eager_steps_lrs():
    """The per-step lr table a graph call writes equals the lrs of eager
    steps, plateau scale included, and ``advance`` moves the schedule as
    many ``sched.step()`` calls do."""
    w = torch.nn.Parameter(torch.zeros(3))
    for scheduler in ("CosineAnnealingLR", "CosineAnnealingWarmRestarts",
                      "StepLR"):
        opt, sched = optim.make_optimizer([w], 1e-3, 3, 2, 0.0, scheduler,
                                          decay_step_size=1)
        optim.set_plateau_scale(sched, 0.5)
        table = optim.scheduled_lrs(sched, 4)
        seen = []
        opt2, sched2 = optim.make_optimizer([w], 1e-3, 3, 2, 0.0, scheduler,
                                            decay_step_size=1)
        optim.set_plateau_scale(sched2, 0.5)
        for _ in range(4):
            seen.append([g["lr"] for g in opt2.param_groups])
            opt2.step()
            sched2.step()
        assert table == seen
        optim.advance(sched, 4)
        assert sched.last_epoch == sched2.last_epoch
        assert opt.param_groups[0]["lr"] == opt2.param_groups[0]["lr"]


def test_resume_state_is_portable_between_graph_and_eager_runs():
    """A state written by a run whose Adam was made capturable (a device
    lr tensor, step counts beside the parameters) is saved in the eager
    form; an eager run loads it and steps exactly as the writer's state
    would have stepped eagerly."""
    torch.manual_seed(0)
    x = torch.randn(5, 4, dtype=torch.float64)
    nets = [torch.nn.Linear(4, 2).double() for _ in range(3)]
    for n in nets[1:]:
        n.load_state_dict(nets[0].state_dict())

    def body(net):
        return lambda _: net(x).square().sum().backward()

    runs = [optim.make_optimizer(n.parameters(), 1e-2, 2, 3, 0.01)
            for n in nets]
    for n, (o, s) in zip(nets[:2], runs[:2]):
        for _ in range(2):
            common.optimizer_step(o, s, body(n), [None])
    writer_opt, writer_sched = runs[0]
    optim.make_capturable(writer_opt)
    assert isinstance(writer_opt.param_groups[0]["lr"], torch.Tensor)
    state = common.train_state({"net": nets[0]}, writer_opt, writer_sched)
    group = state["opt"]["param_groups"][0]
    assert isinstance(group["lr"], float) and not group["capturable"]
    # the eager run that loads it, against the eager run it continues
    nets[2].load_state_dict(state["modules"]["net"])
    opt, sched = runs[2]
    opt.load_state_dict(state["opt"])
    sched.last_epoch = state["step"]
    optim.set_plateau_scale(sched, 1.0)
    for n, (o, s) in ((nets[2], (opt, sched)), (nets[1], runs[1])):
        common.optimizer_step(o, s, body(n), [None])
    assert torch.equal(nets[2].weight, nets[1].weight)
    assert torch.equal(nets[2].bias, nets[1].bias)
    assert not opt.param_groups[0]["capturable"]


# -- flags --------------------------------------------------------------------------


def test_check_chain_args_refuses_grad_accum_with_steps_per_call():
    """As the JAX package's check: the two flags are not combined."""
    import argparse

    args = argparse.Namespace(grad_accum=2, steps_per_call=2)
    for check in (common.check_chain_args, jcommon.check_chain_args):
        with pytest.raises(SystemExit, match="pick one"):
            check(args)
    for ok in (argparse.Namespace(grad_accum=2, steps_per_call=1),
               argparse.Namespace(grad_accum=1, steps_per_call=4)):
        common.check_chain_args(ok)
        jcommon.check_chain_args(ok)
    argv = T._train_argv("unused", "--epochs", "1", "--grad_accum", "2",
                         "--steps_per_call", "2")
    with pytest.raises(SystemExit, match="pick one"):
        PG.main(argv)


def test_profile_dir_writes_a_trace_of_the_first_epoch(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    PG.main(["--device", "cpu", "--synthetic", "--synthetic_size", "8",
             "--synthetic_max_atoms", "20", "--emb_dim", "16",
             "--num_filters", "16", "--num_interactions", "2",
             "--num_gaussians", "8", "--batch_size", "8", "--epochs", "2",
             "--steps_per_call", "2", "--profile_dir", str(trace_dir),
             "--output_model_dir", str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert out.count(f"profiler trace written to {trace_dir}") == 1
    path = trace_dir / "trace.json"
    assert path.exists() and os.path.getsize(path) > 0


def test_profiling_step_timer_keeps_the_first_step_apart():
    from geossl_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer(cuda=False)
    for _ in range(3):
        with timer.step():
            pass
    s = timer.summary()
    assert s["steps"] == 3 and s["first_step_s"] is not None
    assert s["steady_p50_ms"] is not None and s["steady_mean_ms"] >= 0


def test_lep_dual_batches_run_the_single_steps_trajectory():
    """LEP's DualMolBatch (two towers, nested) through ChainStep, eager on
    the CPU: three steps in one call equal three single steps."""
    from geossl_tpu_torch.data.synthetic import synthetic_lep
    from geossl_tpu_torch.train import finetune_lep as FE

    args = FE.build_parser().parse_args(
        ["--emb_dim", "16", "--num_filters", "16", "--num_interactions",
         "2", "--num_gaussians", "8"])
    cfg = common.model_config_from_args(args)
    nets = [FE.make_net(args, cfg, torch.Generator().manual_seed(0))
            for _ in range(2)]
    loader = FE.DualLoader(*synthetic_lep(12, max_atoms=20), 4, (32,),
                           shuffle=True, seed=1)
    batches = list(loader.epoch(1))
    assert len(batches) == 3

    def body_of(net):
        return common.finetune_body(net, FE.loss_fn)

    single, _, _ = _port_chain(nets[0], body_of, 1, batches)
    chained, _, _ = _port_chain(nets[1], body_of, 3, batches)
    assert torch.equal(single, chained)
    for p, q in zip(nets[0].parameters(), nets[1].parameters()):
        assert torch.equal(p, q)
