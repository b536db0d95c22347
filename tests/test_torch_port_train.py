"""The DDM training slices of geossl_tpu_torch (SchNet and PaiNN) against the
JAX package on the CPU, where every kernel wrapper takes its plain version.

* The slice as a whole, in f64 (real f64 on the JAX side, inside x64), for
  each backbone: the DDM loss and every gradient on one batch at rtol
  1e-10, then a 4-step Adam trajectory with injected noise (losses and
  parameters at rtol 1e-10, atol 1e-12). This is the training-parity
  contract of the slices. PaiNN's JAX loss is built as ``pretrain_geossl``
  builds it, with the clean geometry's radius graph as the pair mask of
  both views, and its f32 casts read as f64 (``test_torch_port_painn.f64_casts``).
* Pair selection, BFS masking and the loader's epoch order: exact.
* The lr schedules against optax (f32 on the JAX side: rtol 1e-6); Adam
  with weight decay against optax in f64 (rtol 1e-10).
* The driver CLI on the CPU, its checkpoint, resume and refusals.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geossl_tpu.data import bucketing as jbucket
from geossl_tpu.data import masking as jmask
from geossl_tpu.data import synthetic as jsyn
from geossl_tpu.models.painn import PaiNN as JPaiNN
from geossl_tpu.models.schnet import SchNet as JSchNet
from geossl_tpu.objectives.ncsn import NCSNv3 as JNCSNv3
from geossl_tpu.objectives.pairs import pair_selection as jpair_selection
from geossl_tpu.ops import geometry as jgeo
from geossl_tpu.train import optim as joptim
from geossl_tpu_torch.config import ModelConfig, PaiNNConfig, SchNetConfig
from geossl_tpu_torch.data import bucketing as tbucket
from geossl_tpu_torch.data import masking as tmask
from geossl_tpu_torch.data.batch import DenseMolBatch
from geossl_tpu_torch.data.store import MolStore
from geossl_tpu_torch.models.painn import PaiNN
from geossl_tpu_torch.models.schnet import SchNet
from geossl_tpu_torch.objectives.ncsn import NCSNv3, sigma_ladder
from geossl_tpu_torch.objectives.pairs import pair_selection
from geossl_tpu_torch.serve import Predictor
from geossl_tpu_torch.train import checkpoints, optim
from geossl_tpu_torch.train import pretrain_geossl as PG
from geossl_tpu_torch.utils.torch_import import (
    ncsn_state_dict_from_flax,
    painn_state_dict_from_flax,
    schnet_state_dict_from_flax,
)
from tests import test_torch_port_painn as P
from tests import test_torch_port_schnet as S

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

EMB = 16
TINY = ["--emb_dim", "16", "--num_filters", "16", "--num_interactions", "2",
        "--num_gaussians", "8", "--batch_size", "8"]


# -- the slice as a whole, f64 ------------------------------------------------


def _step_inputs(pos, mask, step):
    """Per-step noise as the driver draws it, made with numpy: the perturbed
    view and each head's sigmas and noise."""
    rng = np.random.default_rng(100 + step)
    b, n, _ = pos.shape
    pos2 = pos + rng.normal(scale=0.3, size=pos.shape)
    ladder = sigma_ladder(10.0, 0.01, 50).astype(np.float64)
    draws = []
    for _ in range(2):
        draws += [ladder[rng.integers(0, 50, b)], rng.normal(size=(b, n, n))]
    return pos2, draws


# per backbone: (JAX module, port module, flax tree -> port state_dict,
# extra x64 context for the JAX side)
_BACKBONES = {
    "schnet": (lambda **kw: JSchNet(**{**S.SMALL, **kw}),
               lambda **kw: SchNet(**{**S.SMALL, **kw}),
               schnet_state_dict_from_flax, contextlib.nullcontext),
    "painn": (lambda **kw: JPaiNN(**{**P.SMALL, **kw}),
              lambda **kw: PaiNN(**{**P.SMALL, **kw}),
              painn_state_dict_from_flax, P.f64_casts),
}


def ddm_jax_case(model_3d: str, b: int = 3, emb: int = EMB,
                 kernels: bool = False, **widths) -> dict:
    """A DDM slice in f64 on both sides: the JAX loss as ``pretrain_geossl``
    builds it, ``jax_loss(params, *batch_arrays, pos2, draws)`` (jitted:
    ``jax_value_and_grad``), its flax trees (``params``), the batch of
    ``b`` graphs of up to 16 atoms (the last an empty slot) as numpy arrays
    (``arrays``: z, pos, mask, graph mask, pair selection) and as the port's
    batch, and ``port()``, the port's DDM with the same weights. ``emb`` is
    the heads' width; ``widths`` override the backbone's small config
    (SchNet's hidden_channels, num_filters; PaiNN's n_atom_basis, n_rbf).
    ``kernels`` (PaiNN): the JAX model with ``use_pallas`` (its message
    pass through ``painn_pallas.painn_message``, which the caller
    monkeypatches to its plain reference while the JAX side traces) and the
    port's DDM on its kernel route (``plain=False``): both sides then use
    the kernels' RBF."""
    make_jax, make_port, to_port, jax_ctx = _BACKBONES[model_3d]
    painn = model_3d == "painn"
    z, pos, mask = S.molecules(b, 16, seed=21, spread=1.2)
    mask[-1] = False  # an empty graph slot
    z[-1], pos[-1] = 0, 0.0
    gm = mask.any(axis=1)
    n = pos.shape[1]
    sel = mask[:, :, None] & mask[:, None, :] & np.triu(np.ones((n, n), bool), 1)
    jm = make_jax(**widths, **({"use_pallas": True} if kernels else {}))
    head = JNCSNv3(emb_dim=emb)
    with S.x64():
        # jitted: eager ops under x64 compile one by one
        k = jax.random.split(jax.random.PRNGKey(3), 3)
        params = {
            "model": jax.jit(jm.init)(k[0], jnp.asarray(z),
                                      jnp.asarray(pos, jnp.float32),
                                      jnp.asarray(mask))["params"]}
        h = jnp.zeros((b, n, emb))
        head_init = jax.jit(head.init)
        for name, key in (("NCSN_01", k[1]), ("NCSN_02", k[2])):
            params[name] = head_init(key, key, h, jnp.ones((b, n, n)),
                                     jnp.asarray(sel))["params"]
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        params)

    def jax_loss(p, zz, xx, mm, gg, ss, pos2, draws):
        d1, pm = jgeo.pairwise_distances(xx, mm)
        # PaiNN: the clean geometry's radius graph for both views
        extra = ((jgeo.radius_adjacency(d1, pm, P.CUT),) if painn else ())
        with jax_ctx():
            _, h1 = jm.apply({"params": p["model"]}, zz, xx, mm, *extra)
            _, h2 = jm.apply({"params": p["model"]}, zz, pos2, mm, *extra)
        d2, _ = jgeo.pairwise_distances(pos2, mm)
        s1, n1, s2, n2 = draws
        l1 = head.apply({"params": p["NCSN_01"]}, None, h1, d2, ss, gg,
                        sigmas=s1, noise=n1)
        l2 = head.apply({"params": p["NCSN_02"]}, None, h2, d1, ss, gg,
                        sigmas=s2, noise=n2)
        return (l1 + l2) / 2

    def port():
        # PaiNN: the JAX loss runs the model's XLA path, whose port is
        # plain=True (the kernels' plain versions use the kernels' RBF
        # coefficient, ~1e-8 apart in f64)
        ddm = PG.DDM(make_port(**widths), NCSNv3(emb_dim=emb),
                     NCSNv3(emb_dim=emb), plain=painn and not kernels).double()
        ddm.model.load_state_dict(to_port(params["model"]))
        for name in ("NCSN_01", "NCSN_02"):
            getattr(ddm, name).load_state_dict(
                ncsn_state_dict_from_flax(params[name]))
        return ddm

    batch = DenseMolBatch(atom_type=torch.from_numpy(z).long(),
                          positions=torch.from_numpy(pos),
                          node_mask=torch.from_numpy(mask),
                          graph_mask=torch.from_numpy(gm))
    return dict(params=params, jax_loss=jax_loss, port=port, batch=batch,
                jax_value_and_grad=jax.jit(jax.value_and_grad(jax_loss)),
                arrays=(z, pos, mask, gm, sel), pos=pos, mask=mask,
                sel=torch.from_numpy(sel), to_port=to_port)


@pytest.fixture(scope="module", params=sorted(_BACKBONES))
def ddm_case(request):
    return ddm_jax_case(request.param)


def _port_loss(ddm, case, pos2, draws):
    return ddm(case["batch"], torch.from_numpy(pos2), case["sel"],
               tuple(torch.from_numpy(np.asarray(d)) for d in draws))


def _as_port_state(tree, to_port):
    """A JAX param (or gradient) tree in the port's DDM state_dict names."""
    sd = {f"model.{k}": v for k, v in to_port(tree["model"]).items()}
    for name in ("NCSN_01", "NCSN_02"):
        sd.update({f"{name}.{k}": v for k, v in
                   ncsn_state_dict_from_flax(tree[name]).items()})
    return sd


def test_ddm_loss_and_every_gradient_match_jax_f64(ddm_case):
    pos2, draws = _step_inputs(ddm_case["pos"], ddm_case["mask"], 0)
    with S.x64():
        want, jgrad = ddm_case["jax_value_and_grad"](
            ddm_case["params"], *map(jnp.asarray, ddm_case["arrays"]),
            jnp.asarray(pos2), tuple(map(jnp.asarray, draws)))
        jgrad = jax.tree_util.tree_map(np.asarray, jgrad)
    ddm = ddm_case["port"]()
    loss = _port_loss(ddm, ddm_case, pos2, draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-10)
    grads = _as_port_state(jgrad, ddm_case["to_port"])
    named = dict(ddm.named_parameters())
    assert sorted(named) == sorted(grads)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def test_ddm_adam_trajectory_matches_jax_f64(ddm_case):
    """4 Adam steps (weight decay, per-epoch cosine over 2 epochs of 2
    steps), each with its own injected noise."""
    lr, decay = 5e-3, 0.01
    steps = [_step_inputs(ddm_case["pos"], ddm_case["mask"], s) for s in range(4)]
    with S.x64():
        tx = joptim.make_optimizer(lr, 2, 2, decay, "CosineAnnealingLR")
        params = jax.tree_util.tree_map(jnp.asarray, ddm_case["params"])
        opt_state = tx.init(params)
        vg = ddm_case["jax_value_and_grad"]

        @jax.jit
        def adam(g, opt_state, params):
            updates, opt_state = tx.update(g, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        want = []
        arrays = tuple(map(jnp.asarray, ddm_case["arrays"]))
        for pos2, draws in steps:
            loss, g = vg(params, *arrays, jnp.asarray(pos2),
                         tuple(map(jnp.asarray, draws)))
            params, opt_state = adam(g, opt_state, params)
            want.append(float(loss))
        params = jax.tree_util.tree_map(np.asarray, params)
    ddm = ddm_case["port"]()
    opt, sched = optim.make_optimizer(ddm.parameters(), lr, 2, 2, decay,
                                      "CosineAnnealingLR")
    got = []
    for pos2, draws in steps:
        opt.zero_grad()
        loss = _port_loss(ddm, ddm_case, pos2, draws)
        loss.backward()
        opt.step()
        sched.step()
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-10)
    final = _as_port_state(params, ddm_case["to_port"])
    for name, p in ddm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


# -- pairs, masking, loader ---------------------------------------------------


@pytest.mark.parametrize("option", ["combination", "permutation"])
def test_pair_selection_matches_jax(option):
    _, _, mask = S.molecules(4, 12, seed=1)
    want = np.asarray(jpair_selection(jnp.asarray(mask), option))
    got = pair_selection(torch.from_numpy(mask), option)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pair_subsample_keeps_exact_count():
    _, _, mask = S.molecules(4, 12, seed=2)
    full = pair_selection(torch.from_numpy(mask), "combination")
    got = pair_selection(torch.from_numpy(mask), "combination", 0.3,
                         torch.Generator().manual_seed(0))
    assert not (got & ~full).any()
    np.testing.assert_array_equal(got.sum(dim=(1, 2)).numpy(),
                                  np.floor(full.sum(dim=(1, 2)).numpy() * 0.3))
    with pytest.raises(ValueError, match="generator"):
        pair_selection(torch.from_numpy(mask), "combination", 0.5)


def test_bfs_masking_matches_jax_numpy_path():
    store = jsyn.synthetic_molecule3d(12, seed=3, max_atoms=40)
    for ratio in (0.3, 0.6):
        for i in range(len(store)):
            rec = store.get(i)
            ja, ta = np.random.default_rng(i), np.random.default_rng(i)
            np.testing.assert_array_equal(
                tmask.bfs_subgraph_indices(ta, rec.num_atoms, rec.bond_index,
                                           ratio),
                jmask.bfs_subgraph_indices(ja, rec.num_atoms, rec.bond_index,
                                           ratio))


def test_loader_epochs_match_jax_numpy_path(monkeypatch):
    """BFS-masked epochs, batch for batch, on both packages' NumPy paths
    (the JAX package's C++ packer switched off; the port's by
    ``GEOSSL_NO_NATIVE``)."""
    from geossl_tpu.native import packing

    monkeypatch.setattr(packing, "available", lambda: False)
    monkeypatch.setenv("GEOSSL_NO_NATIVE", "1")
    _check_loader_epochs()


def test_loader_epochs_match_jax_native_path():
    """BFS-masked epochs, batch for batch, on both packages' default paths:
    the fused C++ BFS mask and pack (one seed per batch)."""
    from geossl_tpu.native import packing

    assert packing.available()
    _check_loader_epochs()


def _check_loader_epochs():
    jstore = jsyn.synthetic_molecule3d(40, seed=4, max_atoms=70)
    tstore = MolStore(jstore.atom_type, jstore.positions, jstore.offsets,
                      jstore.chirality, jstore.bond_index, jstore.bond_offsets,
                      jstore.y)
    jl = jbucket.BucketedLoader(jstore, 8, (32, 64, 128), shuffle=True, seed=5,
                                transform=jmask.make_bfs_transform(0.3))
    tl = tbucket.BucketedLoader(tstore, 8, (32, 64, 128), seed=5,
                                transform=tmask.make_bfs_transform(0.3))
    assert (tl._native is None) == (jl._native is None)
    assert len(tl) == len(jl)
    for epoch in (1, 2):
        jbs, tbs = list(jl.epoch(epoch)), list(tl.epoch(epoch))
        assert len(jbs) == len(tbs)
        for jb, tb in zip(jbs, tbs):
            for name in ("atom_type", "positions", "node_mask", "graph_mask"):
                np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                              np.asarray(getattr(jb, name)))


# -- optimizer ----------------------------------------------------------------


@pytest.mark.parametrize("scheduler", ["CosineAnnealingLR",
                                       "CosineAnnealingWarmRestarts",
                                       "StepLR", "None"])
def test_lr_per_step_matches_optax_schedule(scheduler):
    lr, epochs, spe = 1e-3, 3, 4
    jsched = {
        "CosineAnnealingLR": joptim.cosine_annealing_schedule(lr, epochs, spe),
        "CosineAnnealingWarmRestarts":
            joptim.cosine_warm_restarts_schedule(lr, epochs, spe),
        "StepLR": joptim.step_lr_schedule(lr, spe, 0.5, 1),
        "None": lambda step: lr,
    }[scheduler]
    w = torch.nn.Parameter(torch.zeros(2))
    opt, sched = optim.make_optimizer([w], lr, epochs, spe, scheduler=scheduler,
                                      decay_step_size=1)
    for step in range(epochs * spe + 2):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(jsched(step)), rtol=1e-6)
        opt.step()
        sched.step()


def test_plateau_controller_and_scale_match_jax():
    losses = [5.0, 4.0, 4.0, 4.0, 3.9999, 4.1, 4.2, 2.0, 2.5, 2.5, 2.5]
    j = joptim.PlateauController(1e-3, factor=0.5, patience=2, min_lr=1e-4)
    t = optim.PlateauController(1e-3, factor=0.5, patience=2, min_lr=1e-4)
    w = torch.nn.Parameter(torch.zeros(2))
    opt, sched = optim.make_optimizer([w], 1e-3, 10, 1,
                                      scheduler="ReduceLROnPlateau")
    for loss in losses:
        assert t.step(loss) == j.step(loss)
        optim.set_plateau_scale(sched, t.scale)
        assert opt.param_groups[0]["lr"] == pytest.approx(1e-3 * t.scale)
    assert t.state() == j.state()


def test_adam_with_decay_matches_optax_f64():
    rng = np.random.default_rng(0)
    a, x0 = rng.normal(size=(5, 5)), rng.normal(size=5)

    with S.x64():
        tx = joptim.make_optimizer(0.05, 3, 2, 0.1, "CosineAnnealingLR")
        x = jnp.asarray(x0)
        state = tx.init(x)
        gfn = jax.grad(lambda v: ((jnp.asarray(a) @ v) ** 2).sum()
                       + jnp.sin(v).sum())
        for _ in range(6):
            upd, state = tx.update(gfn(x), state, x)
            x = optax.apply_updates(x, upd)
        want = np.asarray(x)
    w = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    at = torch.from_numpy(a)
    opt, sched = optim.make_optimizer([w], 0.05, 3, 2, 0.1, "CosineAnnealingLR")
    for _ in range(6):
        opt.zero_grad()
        (((at @ w) ** 2).sum() + w.sin().sum()).backward()
        opt.step()
        sched.step()
    np.testing.assert_allclose(w.detach().numpy(), want, rtol=1e-10, atol=1e-12)


# -- driver -------------------------------------------------------------------


def _train_argv(out, *extra):
    return ["--device", "cpu", "--synthetic", "--synthetic_size", "16",
            "--synthetic_max_atoms", "40", "--output_model_dir", str(out),
            *TINY, *extra]


_CLI_MODELS = {
    "schnet": ([], ModelConfig(emb_dim=16, schnet=SchNetConfig(
        hidden_channels=16, num_filters=16, num_interactions=2,
        num_gaussians=8))),
    "painn": (["--model_3d", "painn", "--painn_n_interactions", "2",
               "--painn_n_rbf", "8"],
              ModelConfig(model_3d="painn", emb_dim=16, painn=PaiNNConfig(
                  n_atom_basis=16, n_interactions=2, n_rbf=8))),
}


@pytest.mark.parametrize("model_3d", sorted(_CLI_MODELS))
def test_driver_cli_on_cpu_writes_model_pth_that_serves(tmp_path, capsys,
                                                        model_3d):
    flags, cfg = _CLI_MODELS[model_3d]
    ddm, losses = PG.main(_train_argv(tmp_path, "--epochs", "1",
                                      "--log_file", str(tmp_path / "log.jsonl"),
                                      *flags))
    assert len(losses) >= 2 and np.isfinite(losses).all()  # buckets 32, 64
    assert "Epoch: 1\tSSL Loss" in capsys.readouterr().out
    for name in ("model.pth", "model_final.pth", "state.pth", "log.jsonl"):
        assert os.path.exists(tmp_path / name), name
    pred = Predictor.from_checkpoint(str(tmp_path / "model_final.pth"), cfg,
                                     device="cpu", bucket_sizes=(32, 64))
    store = jsyn.synthetic_molecule3d(16, max_atoms=40)
    emb = pred.embed(MolStore(store.atom_type, store.positions, store.offsets))
    assert emb.shape == (16, 16) and np.isfinite(emb).all()
    with torch.no_grad():
        for k, v in pred.model.state_dict().items():
            np.testing.assert_array_equal(v.numpy(),
                                          ddm.model.state_dict()[k].numpy())
    # resume runs only the epochs left
    _, more = PG.main(_train_argv(tmp_path, "--epochs", "2", "--resume",
                                  *flags))
    assert "Resumed from" in capsys.readouterr().out
    assert len(more) == len(losses)  # one more epoch


@pytest.mark.parametrize("extra,match", [
    (["--coordinator_address", "localhost:1"], "coordinator_address"),
    (["--num_processes", "2"], "num_processes"),
    (["--num_devices", "0"], "num_devices"),
])
def test_driver_refuses_unported_paths(tmp_path, extra, match):
    """The multi-device flags are ported; what the JAX package refuses
    (one process for a multi-host run, a device count out of range) is
    refused before any rank starts, and so is a process count without a
    coordinator."""
    with pytest.raises(ValueError, match=match):
        PG.main(_train_argv(tmp_path, "--epochs", "1", *extra))


@pytest.mark.parametrize("option", ["DDM", "InfoNCE", "EBM_NCE"])
def test_driver_refuses_lr_scale_without_rr(tmp_path, option):
    """As the JAX driver: a SystemExit naming the RR AutoEncoder heads."""
    with pytest.raises(SystemExit, match="only applies to the RR"):
        PG.main(_train_argv(tmp_path, "--epochs", "1", "--GeoSSL_option",
                            option, "--gnn_2d_lr_scale", "1.0"))


def test_driver_runs_on_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _train_argv(tmp_path, "--epochs", "1")
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PG.main(argv)


def test_best_model_saver(tmp_path):
    saver = checkpoints.BestModelSaver(str(tmp_path))
    calls = []

    def tree():
        calls.append(1)
        return {"model": {"w": torch.ones(2)}}

    assert saver.maybe_save_best(2.0, tree)
    assert not saver.maybe_save_best(float("nan"), tree)
    assert not saver.maybe_save_best(2.0, tree)
    assert saver.maybe_save_best(1.0, tree) and len(calls) == 2
    saver.save_final({"model": {"w": torch.zeros(2)}})
    assert checkpoints.load_checkpoint(str(tmp_path / "model.pth"))["model"]["w"].sum() == 2
    assert not checkpoints.BestModelSaver("").maybe_save_best(0.0, tree)
