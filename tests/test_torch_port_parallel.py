"""Data parallelism and multi-process running in geossl_tpu_torch
(``parallel/mesh.py``, ``parallel/multihost.py``, ``train/common``'s
launcher) on the CPU: gloo ranks, each a process of its own.

The JAX package's k-device run is its one-device run (``tests/
test_parallel.py``, ``tests/test_multihost.py``); the port keeps that
property: two ranks give the one-process trajectory. One case holds the
two ranks to the JAX package's run on two devices directly, on the same
inputs.

Two gloo ranks are started once for the file (``ranks``, a module fixture):
each runs every case and saves its results; the test process runs the same
cases without a mesh. All in f64, tolerance rtol 1e-10 (the order of the
sums differs between one batch and two halves, ~1e-12 relative; Adam takes
it through 4 steps) and atol 1e-12, losses and every parameter and buffer:

* 4 Adam steps of ``pretrain_geossl``'s DDM (SchNet and PaiNN), InfoNCE and
  RR (SchNet) through ``common.run_pretrain``, the driver's epoch loop
  (its generator, its draws for the whole batch, the gradient all_reduce):
  two epochs of a 12-molecule corpus in batches of 8, whose second batch
  holds 4 real graphs and 4 padded slots, all on rank 1;
* DDM-SchNet's 4 Adam steps with the draws passed in, through
  ``common.optimizer_step``, on both ranks and in one process, against the
  JAX DDM loss (``test_torch_port_train.ddm_jax_case``) stepped by optax on a
  2-device ``make_mesh`` of the suite's virtual CPU devices: the batch and
  the draws sharded over ``data``, the parameters replicated; the same
  batch (4 graphs, the last an empty slot on rank 1), weights and draws;
* a QM9 fine-tune's evaluation (``finetune_qm9.Evaluator``; the forward
  gathers every rank's rows through ``mesh.sharded``, the counterpart of
  JAX's ``fetch``) and ``mesh.sharded`` itself;
* the resume desync (``--resume`` where one rank sees ``state.pth``)
  failing fast with the JAX package's message.

And through the command line: ``pretrain_geossl --num_devices 2`` and the
multi-host flags (two launchers of one rank each) write the one-process
``model_final.pth``; ``Predictor(num_devices=2, device="cpu")`` and
``serve --num_devices 2`` serve what one device serves; the refusals.
"""

import argparse
import os
import socket
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import pytest
import torch

from geossl_tpu_torch.config import ModelConfig, SchNetConfig
from geossl_tpu_torch.data.bucketing import BucketedLoader
from geossl_tpu_torch.data.synthetic import synthetic_molecule3d, synthetic_qm9
from geossl_tpu_torch.parallel import mesh as pmesh
from geossl_tpu_torch.parallel import multihost
from geossl_tpu_torch.serve import Predictor
from geossl_tpu_torch.train import common
from geossl_tpu_torch.train import finetune_qm9 as FQ
from geossl_tpu_torch.train import optim
from geossl_tpu_torch.train import pretrain_geossl as PG

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-10, 1e-12
TINY = ["--emb_dim", "16", "--num_filters", "16", "--num_interactions", "2",
        "--num_gaussians", "8", "--painn_n_interactions", "2",
        "--painn_n_rbf", "8", "--batch_size", "8", "--device", "cpu"]
# (GeoSSL option, backbone) of the trajectory cases
TRAJECTORIES = [("DDM", "schnet"), ("DDM", "painn"), ("InfoNCE", "schnet"),
                ("RR", "schnet")]
# RR's biases before each AE's BatchNorm have a zero gradient in exact
# arithmetic (the normalisation removes them): their computed gradients are
# rounding noise, ~1e-17, which Adam (eps 1e-8) turns into steps of
# ~lr·1e-9 that differ with the order of the sums. They are held to that
# noise (|value| < NOISE on both sides), not to each other; RR runs without
# weight decay (which would grow the noise into full steps) and without the
# detached target (whose backbone bias would be noise-driven too), as
# test_torch_port_pretrain's RR trajectory does.
EXTRA = {"RR": ["--no_detach_target", "--decay", "0"]}
ZERO_GRAD = {f"AE_0{k}.fc_layers.0.bias" for k in (1, 2)}
NOISE = 1e-9


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn, nprocs, *args, timeout_s=300.0):
    """``fn(rank, *args)`` in ``nprocs`` spawned processes, joined within
    ``timeout_s`` (a failed rank raises here and ends the others)."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__}: ranks still running after "
                        f"{timeout_s:.0f} s")


class _F64Loader:
    """A loader's epochs with f64 positions (the modules run in f64)."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def epoch(self, epoch):
        for b in self.loader.epoch(epoch):
            yield replace(b, positions=b.positions.double())


def trajectory(option: str, model_3d: str) -> dict:
    """pretrain_geossl's module in f64 through ``common.run_pretrain``: two
    epochs of 12 molecules in batches of 8 (4 Adam steps). Returns the
    losses and the final state."""
    args = PG.build_parser().parse_args(
        ["--GeoSSL_option", option, "--model_3d", model_3d, "--epochs", "2",
         "--lr", "5e-3", "--decay", "0.01", "--seed", "3",
         "--GeoSSL_atom_masking_ratio", "0", *TINY, *EXTRA.get(option, [])])
    cfg = common.model_config_from_args(args)
    gen = torch.Generator().manual_seed(args.seed)
    make = PG.make_ddm if option == "DDM" else PG.make_graph_ssl
    module = make(args, cfg, gen).double()
    pmesh.put_replicated(pmesh.current(), module)
    store = synthetic_molecule3d(12, seed=4, max_atoms=20)
    loader = _F64Loader(BucketedLoader(store, 8, (32,), seed=5))
    opt, sched = common.make_optimizer_from_args(args, module.parameters(),
                                                 len(loader))
    losses = common.run_pretrain(args, module, "m", opt, sched, loader,
                                 PG.loss_of(module, args), torch.device("cpu"))
    return {"losses": losses,
            "state": {k: v.clone() for k, v in module.state_dict().items()}}


def qm9_eval() -> dict:
    """A QM9 net's evaluation of 20 molecules in batches of 8 (f64)."""
    cfg = ModelConfig(emb_dim=16, schnet=SchNetConfig(
        hidden_channels=16, num_filters=16, num_interactions=2,
        num_gaussians=8))
    gen = torch.Generator().manual_seed(1)
    net = FQ.QM9Net(common.make_backbone(cfg, gen),
                    common.make_head("schnet", 16, gen)).double()
    store = synthetic_qm9(20, seed=2)
    loader = _F64Loader(BucketedLoader(store, 8, (32,), seed=0,
                                       shuffle=False))
    evaluate = FQ.Evaluator(torch.device("cpu"), 0.5, 2.0)
    got = evaluate(net, loader)
    t, p = evaluate.last[loader]
    return {"mae": got["mae"], "targets": t, "preds": p}


# DDM_STEPS Adam steps at lr 5e-3, weight decay 0.01, a per-epoch cosine
# over 2 epochs of 2 steps (test_torch_port_train's trajectory)
DDM_STEPS, DDM_ADAM = 4, (5e-3, 2, 2, 0.01, "CosineAnnealingLR")


def ddm_steps(saved: dict) -> dict:
    """The saved DDM's Adam steps on the saved batch, each with its saved
    view and draws, through ``common.optimizer_step`` (on a mesh: each
    rank's rows, the gradients summed). Returns the losses and the final
    parameters."""
    ddm = saved["ddm"]
    opt, sched = optim.make_optimizer(ddm.parameters(), *DDM_ADAM)

    def body(pos2, draws):
        def run(_):
            loss = ddm(saved["batch"], pos2, saved["sel"], draws)
            common.backward_share(loss, 1)
            return loss.detach()
        return run

    losses = [common.optimizer_step(opt, sched, body(*step), [None]).item()
              for step in saved["steps"]]
    return {"losses": losses, "params": {
        k: p.detach().clone() for k, p in ddm.named_parameters()}}


def run_cases(outdir) -> dict:
    """Every case of the file, in this process's mesh (or none)."""
    out = {case: trajectory(*case) for case in TRAJECTORIES}
    out["ddm_jax"] = ddm_steps(torch.load(os.path.join(outdir, "ddm_jax.pt"),
                                          weights_only=False))
    out["qm9_eval"] = qm9_eval()
    mesh = pmesh.current()
    if mesh is not None:
        x = torch.arange(16.0).reshape(8, 2)
        seen = []
        out["sharded"] = pmesh.sharded(
            lambda t: seen.append(t.shape[0]) or t * 2, x)
        out["sharded_rows"] = seen
        # the real graphs of this rank's rows of each batch of an epoch
        loader = BucketedLoader(synthetic_molecule3d(12, seed=4, max_atoms=20),
                                8, (32,), seed=5)
        out["real_rows"] = sorted(
            int(pmesh.shard_batch(mesh, b).graph_mask.sum())
            for b in loader.epoch(1))
        # --resume where only rank 0 sees a state.pth
        d = os.path.join(outdir, f"dir{mesh.rank}")
        os.makedirs(d, exist_ok=True)
        if mesh.rank == 0:
            open(os.path.join(d, "state.pth"), "w").close()
        args = argparse.Namespace(resume=True, output_model_dir=d)
        try:
            common.try_resume(args, {}, None, None)
            out["desync"] = None
        except SystemExit as e:
            out["desync"] = str(e)
    return out


def _rank_main(rank: int, world: int, port: int, outdir: str) -> None:
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    pmesh.make_mesh(world, device="cpu")
    torch.save(run_cases(outdir), os.path.join(outdir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ddm_jax():
    """The JAX DDM-SchNet case of 4 graphs and its DDM_STEPS steps' views
    and draws (numpy)."""
    from tests import test_torch_port_train as T

    case = T.ddm_jax_case("schnet", b=4)
    steps = [T._step_inputs(case["pos"], case["mask"], k)
             for k in range(DDM_STEPS)]
    return case, steps


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ddm_jax):
    """Every case on two gloo ranks (each rank's results) and in this
    process without a mesh."""
    outdir = str(tmp_path_factory.mktemp("ranks"))
    case, steps = ddm_jax
    torch.save({"ddm": case["port"](), "batch": case["batch"],
                "sel": case["sel"],
                "steps": [(torch.from_numpy(pos2),
                           tuple(torch.from_numpy(np.asarray(d))
                                 for d in draws)) for pos2, draws in steps]},
               os.path.join(outdir, "ddm_jax.pt"))
    run_ranks(_rank_main, 2, 2, free_port(), outdir)
    got = [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
           for r in range(2)]
    return got, run_cases(outdir)


@pytest.mark.parametrize("case", TRAJECTORIES, ids="-".join)
def test_two_ranks_match_one_process_f64(ranks, case):
    got, want = ranks
    for rank in got:
        np.testing.assert_allclose(rank[case]["losses"], want[case]["losses"],
                                   rtol=RTOL)
        for name, v in want[case]["state"].items():
            if name in ZERO_GRAD:
                assert max(v.abs().max(), rank[case]["state"][name].abs()
                           .max()) < NOISE, name
                continue
            np.testing.assert_allclose(rank[case]["state"][name].numpy(),
                                       v.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_two_ranks_ddm_match_jax_two_device_mesh_f64(ranks, ddm_jax):
    """The DDM-SchNet steps on two ranks and in one process against the JAX
    loss on a 2-device mesh (the batch and the draws sharded over ``data``,
    the parameters replicated, ``jax.value_and_grad`` and optax's Adam
    jitted over it): losses at RTOL, every parameter at RTOL/ATOL."""
    import jax
    import jax.numpy as jnp
    import optax

    from geossl_tpu.parallel import mesh as jmesh
    from geossl_tpu.train import optim as joptim
    from tests.test_torch_port_schnet import x64
    from tests.test_torch_port_train import _as_port_state

    got, one = ranks
    case, steps = ddm_jax
    with x64():
        mesh = jmesh.make_mesh(2)
        tx = joptim.make_optimizer(*DDM_ADAM)
        params = jmesh.put_replicated(mesh, jax.tree_util.tree_map(
            jnp.asarray, case["params"]))
        opt_state = tx.init(params)
        arrays = jmesh.shard_batch(mesh, tuple(map(jnp.asarray,
                                                   case["arrays"])))

        @jax.jit
        def adam(g, opt_state, params):
            updates, opt_state = tx.update(g, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        want = []
        for pos2, draws in steps:
            pos2, draws = jmesh.shard_batch(mesh, (
                jnp.asarray(pos2), tuple(map(jnp.asarray, draws))))
            loss, g = case["jax_value_and_grad"](params, *arrays, pos2, draws)
            params, opt_state = adam(g, opt_state, params)
            want.append(float(loss))
        final = _as_port_state(jax.tree_util.tree_map(np.asarray, params),
                               case["to_port"])
    for res in [rank["ddm_jax"] for rank in got] + [one["ddm_jax"]]:
        np.testing.assert_allclose(res["losses"], want, rtol=RTOL)
        assert sorted(res["params"]) == sorted(final)
        for name, v in res["params"].items():
            np.testing.assert_allclose(v.numpy(), final[name].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def test_uneven_final_batch_pads_one_rank_only(ranks):
    """The corpus does not divide the batch: the epoch's last batch has 4
    real graphs, all on rank 0; the trajectories above ran through it."""
    got, _ = ranks
    assert got[0]["real_rows"] == [4, 4]
    assert got[1]["real_rows"] == [0, 4]


def test_evaluation_gathered_by_fetch(ranks):
    """Each rank's evaluation holds the global batch's predictions, gathered
    by the forward's ``mesh.sharded`` (the port's counterpart of JAX's
    ``fetch``), which ran ``fn`` on the rank's 4 rows of 8."""
    got, want = ranks
    for rank in got:
        np.testing.assert_allclose(rank["qm9_eval"]["preds"],
                                   want["qm9_eval"]["preds"], rtol=RTOL)
        np.testing.assert_array_equal(rank["qm9_eval"]["targets"],
                                      want["qm9_eval"]["targets"])
        np.testing.assert_allclose(rank["qm9_eval"]["mae"],
                                   want["qm9_eval"]["mae"], rtol=RTOL)
        np.testing.assert_array_equal(rank["sharded"].numpy(),
                                      np.arange(16.0).reshape(8, 2) * 2)
        assert rank["sharded_rows"] == [4]


def test_resume_desync_fails_fast(ranks):
    got, _ = ranks
    for rank in got:
        assert rank["desync"] is not None and "multi-host desync" in \
            rank["desync"] and "resume checkpoint exists" in rank["desync"]


def _pretrain_argv(out, *extra):
    return ["--synthetic", "--synthetic_size", "12", "--epochs", "1",
            "--seed", "7", "--output_model_dir", str(out), *TINY, *extra]


def _final(out):
    return torch.load(os.path.join(out, "model_final.pth"))["model"]


@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("single")
    PG.main(_pretrain_argv(out))
    return _final(out)


def _close_states(a, b):
    for k, v in a.items():
        np.testing.assert_allclose(b[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_num_devices_cli_matches_one_process(tmp_path, single_run):
    """``--num_devices 2`` starts two ranks (spawn) from one command line;
    rank 0 writes the checkpoint (f32: rtol 1e-5)."""
    assert PG.main(_pretrain_argv(tmp_path, "--num_devices", "2")) is None
    _close_states(single_run, _final(tmp_path))


def test_multihost_flags_match_one_process(tmp_path, single_run):
    """Two launchers (``--coordinator_address --num_processes 2
    --process_id i``), one rank each (the CPU's default local count)."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "geossl_tpu_torch.train.pretrain_geossl",
         *_pretrain_argv(tmp_path, "--coordinator_address",
                         f"127.0.0.1:{port}", "--num_processes", "2",
                         "--process_id", str(i))],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-2000:]
    _close_states(single_run, _final(tmp_path))


def test_predictor_on_two_devices_matches_one():
    from tests.test_torch_port_serve import _store

    cfg = ModelConfig(emb_dim=16, schnet=SchNetConfig(
        hidden_channels=16, num_filters=16, num_interactions=2,
        num_gaussians=8))
    gen = torch.Generator().manual_seed(0)
    state = {"model": common.make_backbone(cfg, gen).state_dict(),
             "graph_pred_linear": common.make_head("schnet", 16,
                                                   gen).state_dict()}
    store = _store(21, 3, 40, seed=5)
    kw = dict(batch_size=7, bucket_sizes=(16, 32, 64), device="cpu")
    one, two = Predictor(cfg, state, **kw), Predictor(cfg, state,
                                                      num_devices=2, **kw)
    assert two.batch_size == 8 and len(two._replicas) == 2
    np.testing.assert_allclose(two.predict(store), one.predict(store),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(two.embed(store), one.embed(store), rtol=1e-6,
                               atol=1e-6)
    e1, f1 = one.predict_forces(store)
    e2, f2 = two.predict_forces(store)
    np.testing.assert_allclose(e2, e1, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(f2, f1, rtol=1e-5, atol=1e-6)


def test_serve_cli_num_devices(tmp_path):
    """``serve --num_devices 2`` writes what one device writes (the CLI's
    default, full-width configuration)."""
    from geossl_tpu_torch import serve
    from tests.test_torch_port_serve import _store

    cfg = ModelConfig()
    gen = torch.Generator().manual_seed(0)
    torch.save({"model": common.make_backbone(cfg, gen).state_dict(),
                "graph_pred_linear": common.make_head(
                    "schnet", cfg.emb_dim, gen).state_dict()},
               tmp_path / "m.pth")
    _store(5, 3, 20, seed=6).save(str(tmp_path / "in.npz"))
    rows = []
    for n in ("1", "2"):
        out = tmp_path / f"out{n}.csv"
        serve.main(["--ckpt", str(tmp_path / "m.pth"), "--input",
                    str(tmp_path / "in.npz"), "--output", str(out),
                    "--device", "cpu", "--bucket", "32", "--num_devices", n])
        rows.append(np.loadtxt(out, delimiter=","))
    assert rows[0].shape == (5, 2)
    np.testing.assert_allclose(rows[1], rows[0], rtol=1e-5)


def test_refusals(tmp_path):
    """The JAX package's: a device count out of range, sealing a
    multi-device Predictor; and ``--steps_per_call`` with gloo ranks on
    CUDA (no card needed: refused at start-up)."""
    from geossl_tpu_torch import export

    with pytest.raises(ValueError, match="out of range"):
        PG.main(_pretrain_argv(tmp_path, "--num_devices", "100000"))
    with pytest.raises(ValueError, match="out of range"):
        pmesh.make_mesh(2, device="cpu")
    cfg = ModelConfig(emb_dim=16, schnet=SchNetConfig(
        hidden_channels=16, num_filters=16, num_interactions=2,
        num_gaussians=8))
    state = {"model": common.make_backbone(cfg).state_dict()}
    pred = Predictor(cfg, state, device="cpu", num_devices=2)
    with pytest.raises(ValueError, match="multi-device Predictor"):
        export.seal(pred, str(tmp_path / "m.sealed"), modes=("embed",))
    args = PG.build_parser().parse_args(
        ["--steps_per_call", "2", "--dist_backend", "gloo"])
    env = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        import unittest.mock as mock

        from geossl_tpu_torch import serve

        with mock.patch.object(serve, "resolve_device",
                               lambda d: torch.device("cuda")), \
                mock.patch.object(pmesh, "rank_device",
                                  lambda d=None: torch.device("cuda", 0)), \
                pytest.raises(SystemExit, match="cannot capture gloo"):
            common.setup_platform(args)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
