"""The QM9 fine-tune slice of geossl_tpu_torch against the JAX package on the
CPU, where every kernel wrapper takes its plain version, and the three
repairs that came with it.

* Data: ``parse_sdf_mol``, ``sdf_block_to_arrays`` (a rejected block too),
  ``build_qm9`` on a raw fixture written here (the store and its float32 y
  identical to the JAX build, with and without a ``smiles_drop_file``), the
  port reading a cache the JAX package saved, both QM9 splits bitwise (the
  full-size branch too), an epoch of rotated batches bitwise, ``mae``.
* The driver in f64 (real f64 on the JAX side, inside x64), both backbones
  and both losses: the loss and every gradient against a copy of the JAX
  driver's ``loss_fn`` closure, a 4-step Adam trajectory against its
  ``make_train_step`` ``train_step``, the denormalized eval step against
  its ``make_eval_step``, at rtol 1e-10 with the same mean and std, the
  weights carried across by ``utils/torch_import``.
* The CLI on the CPU: two epochs, ``model.pth`` with ``y_mean``/``y_std``
  that a ``Predictor`` serves to ``evaluation_best.npz``'s test
  predictions, ``--eval_only``, ``--resume``, a pretrain ``model.pth`` in,
  the refusals.
* Repairs: SchNet makes its envelope once per forward; serving packs a
  partial chunk to a multiple of 8 slots; the drivers and the Predictor
  refuse the CUDA kernels' limits at startup.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geossl_tpu.data import bucketing as jbucket
from geossl_tpu.data import featurize as jfeat
from geossl_tpu.data import qm9 as jqm9
from geossl_tpu.data import splitters as jsplit
from geossl_tpu.data import structio as jstructio
from geossl_tpu.data import synthetic as jsyn
from geossl_tpu.data import transforms as jtrans
from geossl_tpu.data.batch import DenseMolBatch as JBatch
from geossl_tpu.models.painn import PaiNN as JPaiNN
from geossl_tpu.models.schnet import SchNet as JSchNet
from geossl_tpu.native import packing
from geossl_tpu.train import common as jcommon
from geossl_tpu.train import finetune_qm9 as jqm9_driver
from geossl_tpu.train import optim as joptim
from geossl_tpu.utils import metrics as jmetrics
from geossl_tpu_torch import serve
from geossl_tpu_torch.config import ModelConfig, PaiNNConfig, SchNetConfig
from geossl_tpu_torch.data import bucketing as tbucket
from geossl_tpu_torch.data import featurize as tfeat
from geossl_tpu_torch.data import qm9 as tqm9
from geossl_tpu_torch.data import splitters as tsplit
from geossl_tpu_torch.data import structio as tstructio
from geossl_tpu_torch.data import transforms as ttrans
from geossl_tpu_torch.data.batch import DenseMolBatch
from geossl_tpu_torch.data.store import MolStore
from geossl_tpu_torch.data.synthetic import synthetic_qm9
from geossl_tpu_torch.models import schnet as tschnet
from geossl_tpu_torch.models.painn import PaiNN
from geossl_tpu_torch.models.schnet import SchNet
from geossl_tpu_torch.train import checkpoints, common, optim
from geossl_tpu_torch.train import finetune_qm9 as FQ
from geossl_tpu_torch.train import pretrain_geossl as PG
from geossl_tpu_torch.utils import metrics as tmetrics
from geossl_tpu_torch.utils.torch_import import (
    head_state_dict_from_flax,
    painn_state_dict_from_flax,
    schnet_state_dict_from_flax,
)
from tests import test_ingestion as ING
from tests import test_torch_port_painn as P
from tests import test_torch_port_schnet as S
from tests.test_torch_port_data import assert_same_store

# Six test workers share the machine's cores: one intra-op thread each
# (torch's default, one per core, makes these small ops 10-50x slower
# under that load); the ranks these tests start take the same.
torch.set_num_threads(1)

EMB = 16

# -- data: identical output -------------------------------------------------------

# (elements, coordinates, bonds) of the raw fixture's molecules; the third
# is listed as uncharacterized, the fourth has a bond to an atom it lacks
_MOLS = [
    (["C", "H", "H", "O"], [(0, 0, 0), (1.09, 0, 0), (-0.3, 1.02, 0),
                            (0.1, -0.2, 1.3)], [(0, 1, 1), (0, 2, 1), (0, 3, 2)]),
    (["N", "H", "H", "H"], [(0, 0, 0), (1.01, 0, 0), (-0.3, 0.96, 0),
                            (-0.3, -0.4, 0.9)], [(0, 1, 1), (0, 2, 1), (0, 3, 1)]),
    (["O", "O"], [(0, 0, 0), (1.21, 0, 0)], [(0, 1, 2)]),
    (["C", "F"], [(0, 0, 0), (1.35, 0, 0)], [(0, 5, 1)]),
    (["C", "C", "N", "H", "S"], [(0, 0, 0), (1.2, 0, 0), (2.3, 0.1, 0),
                                 (-1.0, 0.2, 0.1), (3.1, 1.0, -0.4)],
     [(0, 1, 3), (1, 2, 1), (0, 3, 1), (2, 4, 4)]),
]


def _blocks():
    return [ING.make_mol_block(e, c, b, name=f"gdb_{i + 1}")
            for i, (e, c, b) in enumerate(_MOLS)]


def _write_raw(root, skip_1based=(3,)):
    """The five raw QM9 files as the dataset ships them: gdb9.sdf.csv with
    its mol_id and rotational-constant columns before the targets,
    uncharacterized.txt with 9 header lines and 2 trailer lines."""
    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    with open(os.path.join(raw, "gdb9.sdf"), "w") as f:
        f.write("".join(b + "\n$$$$\n" for b in _blocks()))
    rng = np.random.default_rng(11)
    cols = ["mol_id", "A", "B", "C"] + jqm9.TARGET_FIELDS[:-1]
    with open(os.path.join(raw, "gdb9.sdf.csv"), "w") as f:
        f.write(",".join(cols) + "\n")
        for i in range(len(_MOLS)):
            vals = rng.normal(scale=40.0, size=len(cols) - 1)
            f.write(f"gdb_{i + 1}," + ",".join(f"{v:.7g}" for v in vals) + "\n")
    lines = [f"header {k}" for k in range(9)]
    lines += [f"{i:7d}  gdb_{i}  5.0  -0.1" for i in skip_1based]
    lines += ["   trailer", ""]
    with open(os.path.join(raw, "uncharacterized.txt"), "w") as f:
        f.write("\n".join(lines))
    with open(os.path.join(raw, "qm9.csv"), "w") as f:
        f.write("mol_id,smiles\n" + "".join(f"gdb_{i + 1},C\n"
                                            for i in range(len(_MOLS))))
    with open(os.path.join(raw, "atomref.txt"), "w") as f:
        f.write("   Ele-    ZPVE         U (0 K)      U (298.15 K)    "
                "H (298.15 K)    G (298.15 K)     CV\n")
        f.write("   ment   Hartree       Hartree        Hartree\n")
        for k, sym in enumerate("HCNOF"):
            f.write(f"   {sym}     0.000000   {-0.5 - 37.8 * k:.6f}   "
                    f"{-0.498 - 37.8 * k:.6f}   {-0.497 - 37.8 * k:.6f}   "
                    f"{-0.51 - 37.8 * k:.6f}     {2.98 + 0.01 * k:.3f}\n")


def test_sdf_parsers_and_featurizer_match_jax(tmp_path):
    blocks = _blocks()
    for block in blocks[:3] + blocks[4:]:
        (ge, gc, gb), (we, wc, wb) = (tstructio.parse_sdf_mol(block),
                                      jstructio.parse_sdf_mol(block))
        assert ge == we
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gb, wb)
        (ga, gcount), (wa, wcount) = (tfeat.sdf_block_to_arrays(block),
                                      jfeat.sdf_block_to_arrays(block))
        assert gcount == wcount and sorted(ga) == sorted(wa)
        for k in wa:
            np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)
            assert ga[k].dtype == wa[k].dtype, k
    # the rejected block: a bond to an atom the molecule lacks
    for parse in (tstructio.parse_sdf_mol, tfeat.sdf_block_to_arrays):
        with pytest.raises(ValueError, match="references atom 6 of 2"):
            parse(blocks[3])
    with pytest.raises(ValueError):
        tstructio.parse_sdf_mol("too\nshort")
    assert tstructio.SYMBOL_TO_Z == jstructio.SYMBOL_TO_Z
    assert [tfeat.atomic_number_to_index(z) for z in (1, 6, 17, 30, -1)] == \
        [jfeat.atomic_number_to_index(z) for z in (1, 6, 17, 30, -1)]
    path = tmp_path / "x.sdf"
    path.write_text("$$$$\n".join(blocks) + "\n\n")
    assert list(tstructio.iter_sdf_blocks(str(path))) == \
        list(jstructio.iter_sdf_blocks(str(path)))


@pytest.mark.parametrize("native", [True, False], ids=["jax_native", "jax_blocks"])
@pytest.mark.parametrize("drop", [None, "4\n"], ids=["keep", "drop"])
def test_build_qm9_matches_jax(tmp_path, monkeypatch, native, drop):
    """The port's build against the JAX build, each on its C++ scanner's
    path (``native``) and each on its per-block path (the JAX package's
    scanner switched off; the port's by ``GEOSSL_NO_NATIVE``)."""
    if not native:
        monkeypatch.setattr(packing, "available", lambda: False)
        monkeypatch.setenv("GEOSSL_NO_NATIVE", "1")
    roots = [str(tmp_path / name) for name in ("jax", "port")]
    for r in roots:
        _write_raw(r)
    drop_file = None
    if drop:
        drop_file = str(tmp_path / "drop.txt")
        with open(drop_file, "w") as f:
            f.write(drop)
    want = jqm9.build_qm9(roots[0], smiles_drop_file=drop_file)
    got = tqm9.build_qm9(roots[1], smiles_drop_file=drop_file)
    # skipped (uncharacterized), rejected, and with a drop file one more
    assert len(got) == (2 if drop else 3)
    assert_same_store(got, want)
    assert got.y.dtype == np.float32
    assert tqm9.TARGET_FIELDS == jqm9.TARGET_FIELDS
    assert tqm9.CONVERSION == jqm9.CONVERSION


def test_load_qm9_reads_the_jax_cache(tmp_path, capsys):
    root = str(tmp_path)
    _write_raw(root)
    want = jqm9.load_qm9(root)  # builds and saves processed/qm9_store.npz
    os.remove(os.path.join(root, "raw", "gdb9.sdf"))  # the cache must do
    assert_same_store(tqm9.load_qm9(root), want)
    assert "UNAVAILABLE" in capsys.readouterr().out
    assert_same_store(tqm9.load_qm9(root, synthetic=True, synthetic_size=9),
                      jqm9.load_qm9(root, synthetic=True, synthetic_size=9))
    with pytest.raises(FileNotFoundError, match="synthetic=True"):
        tqm9.load_qm9(str(tmp_path / "none"))


@pytest.mark.parametrize("n", [1, 97, 4096, 130831, 133885])
@pytest.mark.parametrize("name", ["qm9_random_customized_01",
                                  "qm9_random_customized_02"])
def test_qm9_splits_match_jax(name, n):
    for seed in (0, 5):
        got = getattr(tsplit, name)(n, seed=seed)
        want = getattr(jsplit, name)(n, seed=seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_rotated_epoch_matches_the_jax_loader():
    """An epoch of shuffled batches under random_rotation_transform, batch
    for batch bitwise (the transform draws from the loader's generator)."""
    js = jsyn.synthetic_qm9(40, seed=4)
    ts = MolStore(js.atom_type, js.positions, js.offsets, js.chirality,
                  js.bond_index, js.bond_offsets, js.y)
    jl = jbucket.BucketedLoader(js, 8, (16, 32), shuffle=True, seed=3,
                                transform=jtrans.random_rotation_transform)
    tl = tbucket.BucketedLoader(ts, 8, (16, 32), seed=3,
                                transform=ttrans.random_rotation_transform)
    jbs, tbs = list(jl.epoch(2)), list(tl.epoch(2))
    assert len(jbs) == len(tbs) == len(tl) > 2
    for jb, tb in zip(jbs, tbs):
        for name in ("atom_type", "positions", "node_mask", "graph_mask", "y"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(getattr(jb, name)),
                                          err_msg=name)
    rng = np.random.default_rng(1)
    rot = ttrans.random_rotation_matrix(rng)
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-12)
    assert np.linalg.det(rot) > 0


def test_mae_matches_jax():
    rng = np.random.default_rng(0)
    y, f = rng.normal(size=300), rng.normal(size=300)
    np.testing.assert_allclose(tmetrics.mae(y, f), jmetrics.mae(y, f),
                               rtol=1e-12)
    y32, f32 = y.astype(np.float32), f.astype(np.float32)
    assert tmetrics.mae(y32, f32) == jmetrics.mae(y32, f32)


# -- the driver in f64 -------------------------------------------------------------

_BACKBONES = {
    "schnet": (lambda: JSchNet(**S.SMALL), lambda: SchNet(**S.SMALL),
               schnet_state_dict_from_flax, contextlib.nullcontext),
    "painn": (lambda: JPaiNN(**P.SMALL), lambda: PaiNN(**P.SMALL),
              painn_state_dict_from_flax, P.f64_casts),
}
MEAN, STD = 3.25, 1.75


def _batch(seed, n=16):
    """Four padded molecules (the last slot empty) and a label column."""
    z, pos, mask = S.molecules(4, n, seed=seed, spread=1.2)
    mask[3], z[3], pos[3] = False, 0, 0.0
    y = MEAN + STD * np.random.default_rng(seed).normal(size=(4, 1))
    return z, pos, mask, mask.any(axis=1), y


def _jax_batch(b):
    return JBatch(atom_type=jnp.asarray(b[0]), positions=jnp.asarray(b[1]),
                  node_mask=jnp.asarray(b[2]), graph_mask=jnp.asarray(b[3]),
                  y=jnp.asarray(b[4]))


def _port_batch(b):
    return DenseMolBatch(atom_type=torch.from_numpy(b[0]).long(),
                         positions=torch.from_numpy(b[1]),
                         node_mask=torch.from_numpy(b[2]),
                         graph_mask=torch.from_numpy(b[3]),
                         y=torch.from_numpy(b[4]))


@pytest.fixture(scope="module", params=[(m, k) for m in sorted(_BACKBONES)
                                        for k in ("mae", "mse")],
                ids=lambda p: "-".join(p))
def qm9_case(request):
    """The JAX side of one backbone and loss (f64 params, the driver's
    backbone apply and head), the steps' batches and the port's net."""
    model_3d, kind = request.param
    make_jax, make_port, to_port, jax_ctx = _BACKBONES[model_3d]
    steps = [_batch(50 + s) for s in range(4)]
    jm = make_jax()
    head = jcommon.make_head(model_3d, EMB)
    with S.x64():
        k1, k2 = jax.random.split(jax.random.PRNGKey(9))
        z, pos, mask = (jnp.asarray(a) for a in steps[0][:3])
        params = {"model": jax.jit(jm.init)(k1, z, pos.astype(jnp.float32),
                                            mask)["params"],
                  "graph_pred_linear": head.init(
                      k2, jnp.zeros((2, EMB)))["params"]}
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        params)

    def backbone_apply(p, atom_type, positions, node_mask):
        return jm.apply({"params": p}, atom_type, positions, node_mask)

    def port_net():
        # PaiNN: the JAX model's XLA path, whose port is plain=True
        net = FQ.QM9Net(make_port(), common.make_head(model_3d, EMB),
                        plain=model_3d == "painn").double()
        net.model.load_state_dict(to_port(params["model"]))
        net.graph_pred_linear.load_state_dict(
            head_state_dict_from_flax(params["graph_pred_linear"]))
        return net

    def as_port(tree):
        sd = {f"model.{k}": v for k, v in to_port(tree["model"]).items()}
        sd.update({f"graph_pred_linear.{k}": v for k, v in
                   head_state_dict_from_flax(tree["graph_pred_linear"]).items()})
        return sd

    return dict(kind=kind, jax_ctx=jax_ctx, backbone_apply=backbone_apply,
                head=head, params=params, steps=steps, port_net=port_net,
                as_port=as_port)


def test_qm9_loss_and_every_gradient_match_jax_f64(qm9_case):
    c = qm9_case
    head, apply_ = c["head"], c["backbone_apply"]

    def loss_fn(params, batch, mean, std):  # finetune_qm9.py:49-58
        graph_repr, _ = apply_(params["model"], batch.atom_type,
                               batch.positions, batch.node_mask)
        pred = head.apply({"params": params["graph_pred_linear"]}, graph_repr)
        y = (batch.y[:, 0] - mean) / std
        err = pred - y
        per = jnp.abs(err) if c["kind"] == "mae" else err**2
        return jcommon.graph_masked_mean(per, batch.graph_mask)

    with S.x64(), c["jax_ctx"]():
        want, jgrad = jax.jit(jax.value_and_grad(loss_fn))(
            c["params"], _jax_batch(c["steps"][0]), MEAN, STD)
        jgrad = c["as_port"](jax.tree_util.tree_map(np.asarray, jgrad))
    net = c["port_net"]()
    loss = FQ.make_loss_fn(c["kind"], MEAN, STD)(net, _port_batch(c["steps"][0]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-10)
    named = dict(net.named_parameters())
    assert sorted(named) == sorted(jgrad)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), jgrad[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def test_qm9_adam_trajectory_and_eval_match_jax_f64(qm9_case):
    """4 steps of the JAX driver's train_step against the port's
    finetune_step (Adam with weight decay, per-epoch cosine over 2 epochs of
    2 steps), then its eval_step's denormalized predictions."""
    c = qm9_case
    lr, decay = 5e-3, 0.01
    with S.x64(), c["jax_ctx"]():
        tx = joptim.make_optimizer(lr, 2, 2, decay, "CosineAnnealingLR")
        state = jcommon.TrainState.create(
            jax.tree_util.tree_map(jnp.asarray, c["params"]), tx)
        train_step, _, _ = jqm9_driver.make_train_step(
            c["backbone_apply"], c["head"], tx, c["kind"])
        want = []
        for step in c["steps"]:
            state, loss = train_step(state, _jax_batch(step), MEAN, STD)
            want.append(float(loss))
        eval_step = jqm9_driver.make_eval_step(c["backbone_apply"], c["head"])
        want_pred = np.asarray(eval_step(state.params,
                                         _jax_batch(c["steps"][0]), MEAN, STD))
        final = c["as_port"](jax.tree_util.tree_map(np.asarray, state.params))
    net = c["port_net"]()
    opt, sched = optim.make_optimizer(net.parameters(), lr, 2, 2, decay,
                                      "CosineAnnealingLR")
    loss_fn = FQ.make_loss_fn(c["kind"], MEAN, STD)
    got = [common.finetune_step(net, opt, sched, [_port_batch(s)],
                                loss_fn).item() for s in c["steps"]]
    np.testing.assert_allclose(got, want, rtol=1e-10)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    with torch.no_grad():
        pred = FQ.predict(net, _port_batch(c["steps"][0]), MEAN, STD)
    np.testing.assert_allclose(pred.numpy(), want_pred, rtol=1e-10)


# -- the CLI on the CPU ------------------------------------------------------------

TINY = ["--emb_dim", "16", "--num_filters", "16", "--num_interactions", "2",
        "--num_gaussians", "8", "--batch_size", "8", "--painn_n_rbf", "8",
        "--painn_n_interactions", "2"]


def _argv(out, *extra, size=48):
    return ["--device", "cpu", "--synthetic", "--synthetic_size", str(size),
            "--output_model_dir", str(out), *TINY, *extra]


def test_qm9_train_split_stats_match_the_jax_driver():
    """mean/std of the task column over the train split: NumPy on float32
    with ddof 0, as the JAX driver computes them."""
    args = FQ.build_parser().parse_args(["--synthetic", "--synthetic_size",
                                         "300", "--task", "alpha"])
    splits, mean, std = FQ.load_splits(args)
    store = jqm9.load_qm9("", synthetic=True, synthetic_size=300)
    tr, va, te = jsplit.qm9_random_customized_01(len(store), seed=0)
    col = store.select(tr).y[:, 1]
    assert (mean, std) == (float(col.mean()), float(col.std()))
    assert [len(s) for s in splits] == [len(tr), len(va), len(te)]
    np.testing.assert_array_equal(splits[2].y[:, 0], store.select(te).y[:, 1])


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """model.pth files from the port's DDM pretraining at the tiny width,
    per backbone."""
    out = {}
    for m in ("schnet", "painn"):
        d = tmp_path_factory.mktemp(f"pretrain_{m}")
        PG.main(["--device", "cpu", "--synthetic", "--synthetic_size", "8",
                 "--epochs", "1", "--bucket", "32", "--output_model_dir",
                 str(d), "--model_3d", m, *TINY])
        out[m] = str(d / "model.pth")
    return out


def _loader_order(store, buckets):
    """Store indices in a non-shuffling loader's order (bucket by bucket)."""
    bucket_of = tbucket.assign_buckets(store.num_atoms(), buckets)
    return np.concatenate([np.nonzero(bucket_of == b)[0]
                           for b in np.unique(bucket_of)])


@pytest.mark.parametrize("model_3d,loss", [("schnet", "mae"),
                                           ("painn", "mse")])
def test_qm9_cli_on_cpu(tmp_path, capsys, pretrained, model_3d, loss):
    extra = ["--model_3d", model_3d, "--loss", loss]
    net, best, test_at_best, losses = FQ.main(_argv(
        tmp_path, "--epochs", "2", "--input_model_file", pretrained[model_3d],
        *extra))
    out = capsys.readouterr().out
    assert "Train mean:" in out and "Loaded pretrained backbone" in out
    assert "Epoch: 2\tLoss" in out and "best val MAE" in out
    assert losses and np.isfinite(losses).all() and np.isfinite(best)
    saved = checkpoints.load_checkpoint(str(tmp_path / "model.pth"))
    assert set(saved) == {"model", "graph_pred_linear", "y_mean", "y_std"}
    assert saved["y_mean"].dtype == saved["y_std"].dtype == torch.float32
    final = checkpoints.load_checkpoint(str(tmp_path / "model_final.pth"))
    assert set(final) == set(saved)
    args = FQ.build_parser().parse_args(_argv(tmp_path, *extra))
    splits, mean, std = FQ.load_splits(args)
    assert (float(saved["y_mean"]), float(saved["y_std"])) == \
        (np.float32(mean), np.float32(std))
    ev = np.load(str(tmp_path / "evaluation_best.npz"))
    order = _loader_order(splits[2], common.buckets(args))
    np.testing.assert_array_equal(ev["test_target"], splits[2].y[order, 0])
    np.testing.assert_allclose(tmetrics.mae(ev["test_target"], ev["test_pred"]),
                               test_at_best, rtol=1e-6)
    # the Predictor serves the fine-tuned model.pth (the stack route at
    # N <= 128) to the driver's test predictions
    pred = serve.Predictor.from_checkpoint(
        str(tmp_path / "model.pth"), common.model_config_from_args(args),
        device="cpu", bucket_sizes=common.buckets(args))
    np.testing.assert_allclose(pred.predict(splits[2])[order], ev["test_pred"],
                               rtol=1e-5, atol=1e-5 * std)
    # --eval_only with the checkpoint's own y_mean/y_std
    _, val_e, test_e, none = FQ.main(_argv(
        tmp_path / "eval", "--eval_only", "--input_model_file",
        str(tmp_path / "model.pth"), *extra))
    assert none == [] and "eval-only (mu)" in capsys.readouterr().out
    np.testing.assert_allclose([val_e, test_e], [best, test_at_best],
                               rtol=1e-6)
    # --resume runs only the epochs left
    _, _, _, more = FQ.main(_argv(tmp_path, "--epochs", "3", "--resume",
                                  *extra))
    assert "Resumed from" in capsys.readouterr().out
    assert len(more) == len(losses) // 2


def test_qm9_cli_rotation_and_refusals(tmp_path, pretrained, monkeypatch):
    _, best, _, losses = FQ.main(_argv(tmp_path, "--epochs", "1",
                                       "--use_rotation_transform"))
    assert np.isfinite(losses).all() and np.isfinite(best)
    with pytest.raises(SystemExit, match="FINE-TUNED"):
        FQ.main(_argv(tmp_path / "e", "--eval_only", "--input_model_file",
                      pretrained["schnet"]))
    with pytest.raises(SystemExit, match="pick one"):
        FQ.main(_argv(tmp_path, "--steps_per_call", "2", "--grad_accum", "2"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path, "--epochs", "1")
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FQ.main(argv)


# -- repairs -----------------------------------------------------------------------


def test_schnet_makes_the_envelope_once_per_forward(monkeypatch):
    calls = []
    real = tschnet.cosine_envelope

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tschnet, "cosine_envelope", counted)
    model = SchNet(**{**S.SMALL, "num_interactions": 3}).double()
    z, pos, mask = (torch.from_numpy(a) for a in S.molecules(3, 12, seed=2))
    model(z.long(), pos, mask)
    assert len(calls) == 1
    tschnet.fused_stack_apply(model.float(), z.long(), pos.float(), mask)
    assert len(calls) == 2


@pytest.mark.parametrize("model_3d,batch_size", [("schnet", 16),
                                                 ("painn", 16),
                                                 ("schnet", 128)])
def test_serving_packs_partial_chunks_to_multiples_of_8(monkeypatch, model_3d,
                                                        batch_size):
    """Each bucket's last chunk in ceil8(count) slots; the predictions of
    the batch_size-slot packing (128 by default) on the CPU."""
    cfg = ModelConfig(model_3d=model_3d, emb_dim=EMB,
                      schnet=SchNetConfig(hidden_channels=EMB, num_filters=EMB,
                                          num_interactions=2, num_gaussians=8),
                      painn=PaiNNConfig(n_atom_basis=EMB, n_interactions=2,
                                        n_rbf=8))
    gen = torch.Generator().manual_seed(0)
    state = {"model": common.make_backbone(cfg, gen).state_dict(),
             "graph_pred_linear": common.make_head(model_3d, EMB,
                                                   gen).state_dict()}
    store = synthetic_qm9(45, seed=7)
    pred = serve.Predictor(cfg, state, batch_size=batch_size,
                           bucket_sizes=(16, 32), device="cpu")
    sizes = store.num_atoms()
    want = {}
    for b, n in ((16, int((sizes <= 16).sum())), (32, int((sizes > 16).sum()))):
        full, rest = divmod(n, batch_size)
        want[b] = [batch_size] * full + ([-(-rest // 8) * 8] if rest else [])
    got = {}
    for chunk, batch in pred._batches(store):
        got.setdefault(batch.max_atoms, []).append(batch.batch_size)
        assert batch.batch_size >= len(chunk)
    assert got == want and any(s % batch_size for s in sum(got.values(), []))
    assert serve.batch_slots(5, 128) == 8 and serve.batch_slots(8, 128) == 8
    assert serve.batch_slots(127, 128) == 128 and serve.batch_slots(9, 10) == 10
    packed = pred.predict(store)
    monkeypatch.setattr(serve, "batch_slots", lambda count, size: size)
    # the same per-graph arithmetic (bitwise here; CPU matmuls may block
    # rows by the batch's size, so within f32 rounding)
    np.testing.assert_allclose(packed, pred.predict(store), rtol=1e-6,
                               atol=1e-7)


def _cfg(model_3d="schnet", emb=128, filters=128, g=51, r=20, max_nb=None,
         **kw):
    return ModelConfig(model_3d=model_3d, emb_dim=emb,
                       schnet=SchNetConfig(hidden_channels=emb,
                                           num_filters=filters,
                                           num_gaussians=g),
                       painn=PaiNNConfig(n_atom_basis=emb, n_rbf=r),
                       max_neighbors=max_nb, **kw)


CUDA = torch.device("cuda")


@pytest.mark.parametrize("cfg,routes,flag", [
    # SchNet's per-block kernels take any --num_filters; the stack pads up
    # to 128 and refuses wider
    (_cfg(emb=192, filters=192), dict(backward=True, stack=True),
     "--num_filters 192"),
    (_cfg(emb=256, filters=256), dict(backward=False, stack=True,
                                      per_block=False), "--num_filters 256"),
    # the PaiNN kernels take any width and R >= 2; the stack pads up to
    # 128 and refuses wider
    (_cfg("painn", r=1), dict(backward=True), "--painn_n_rbf 1"),
    (_cfg("painn", r=1), dict(backward=False, per_block=False, stack=True),
     "--painn_n_rbf 1"),
    (_cfg("painn", emb=256), dict(backward=False, per_block=False,
                                  stack=True), "--emb_dim 256"),
    # the NCSN head kernels take emb up to 256
    (_cfg(emb=320), dict(backward=True, ncsn=True), "--emb_dim 320"),
    # the bf16 CFConv backwards take no column blocks
    (_cfg(emb=256, filters=256, filter_mxu="bf16"), dict(backward=True),
     "--num_filters 256"),
    (_cfg(filters=192, compute_dtype="bfloat16"), dict(backward=True),
     "--num_filters 192"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_kernel_limits_refused_on_cuda_only(cfg, routes, flag):
    """Each refusal names its flag and limit on a CUDA device (nothing is
    allocated, so no card is needed); the CPU takes the same values."""
    with pytest.raises(ValueError, match=flag):
        common.check_kernel_limits(cfg, CUDA, **routes)
    common.check_kernel_limits(cfg, torch.device("cpu"), **routes)


@pytest.mark.parametrize("cfg,routes", [
    (_cfg(), dict(backward=True, stack=True, ncsn=True)),
    (_cfg("painn", r=31), dict(backward=True, stack=True, ncsn=True)),
    # PaiNN at any width per block (padded to 128, or column blocks of
    # 128), up to 128 in the stack, and any R >= 2 (streamed above 31)
    (_cfg("painn", emb=64), dict(backward=True)),
    (_cfg("painn", r=32), dict(backward=False, stack=True)),
    (_cfg("painn", emb=96, r=64), dict(backward=True, stack=True, ncsn=True)),
    (_cfg("painn", emb=256, r=2), dict(backward=True, ncsn=True)),
    # SchNet's emb_dim does not reach the per-block kernels, and a
    # num_filters != emb_dim model never takes the stack
    (_cfg(emb=64), dict(backward=True, stack=True)),
    # any Gaussian count: above 64 the CFConv kernels stream W1 (both
    # forwards, both backwards and the stack)
    (_cfg(g=192, max_nb=32), dict(backward=False)),
    (_cfg(g=100, max_nb=32), dict(backward=False, stack=False)),
    (_cfg(g=65), dict(backward=False)),
    (_cfg(g=65, max_nb=32), dict(backward=True)),
    (_cfg(g=193, max_nb=32), dict(backward=False)),
    (_cfg(g=100, max_nb=32), dict(backward=False, stack=True)),
    # any --num_filters per block (padded to 128, or column blocks of 128),
    # up to 128 in the stack; the NCSN head up to --emb_dim 256
    (_cfg(filters=64), dict(backward=True)),
    (_cfg(filters=96), dict(backward=True, stack=True)),
    (_cfg(emb=96, filters=96), dict(backward=True, stack=True, ncsn=True)),
    (_cfg(emb=256, filters=256), dict(backward=True, ncsn=True)),
    (_cfg(emb=200, filters=300, g=300), dict(backward=True, ncsn=True)),
    (_cfg(emb=64), dict(backward=True, ncsn=True)),
    # bf16: forwards at any width, backwards up to 128 (padded)
    (_cfg(emb=256, filters=256, filter_mxu="bf16"), dict(backward=False)),
    (_cfg(emb=96, filters=96, compute_dtype="bfloat16"),
     dict(backward=True, ncsn=True)),
])
def test_kernel_limits_accept_what_the_kernels_run(cfg, routes):
    assert common.kernel_limit_errors(cfg, **routes) == []
    common.check_kernel_limits(cfg, CUDA, **routes)


@pytest.mark.parametrize("driver,argv,flag", [
    # the per-block kernels take any width and any RBF count from 2: the
    # refusals left are PaiNN's R below 2, the NCSN head's above 256 and
    # the bf16 backwards' above 128
    (PG, ["--model_3d", "painn", "--painn_n_rbf", "1"], "--painn_n_rbf 1"),
    (PG, ["--emb_dim", "320"], "--emb_dim 320"),
    (PG, ["--emb_dim", "256", "--num_filters", "256", "--filter_mxu",
          "bf16"], "--num_filters 256"),
])
def test_drivers_refuse_kernel_limits_at_startup(monkeypatch, tmp_path, driver,
                                                 argv, flag):
    """On CUDA (no card needed: the refusal comes before anything is
    allocated or loaded), not with --use_pallas off, not on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    base = ["--synthetic", "--output_model_dir", str(tmp_path)]
    with pytest.raises(ValueError, match=flag):
        driver.main(base + argv)
    args = driver.build_parser().parse_args(base + argv + ["--use_pallas",
                                                           "off"])
    common.check_driver_limits(args, common.model_config_from_args(args), CUDA)


def _driver_limits(driver, argv):
    """The startup limit check of ``driver`` (a module name of
    ``geossl_tpu_torch.train``) for ``argv`` on a CUDA device, as its
    ``main`` runs it."""
    import importlib

    mod = importlib.import_module(f"geossl_tpu_torch.train.{driver}")
    base = ["--synthetic", "--output_model_dir", "unused"]
    if driver == "pretrain_baselines":
        args = mod.build_parser("supervised").parse_args(base + argv)
    else:
        args = mod.build_parser().parse_args(base + argv)
    cfg = common.model_config_from_args(args)
    if driver == "finetune_md17":
        common.check_kernel_limits(cfg, CUDA, backward=True)
    else:
        common.check_driver_limits(args, cfg, CUDA,
                                   ncsn=driver == "pretrain_geossl")
    return cfg


@pytest.mark.parametrize("argv", [
    ["--emb_dim", "32"], ["--emb_dim", "96"], ["--emb_dim", "256"],
    ["--painn_n_rbf", "32"], ["--painn_n_rbf", "40"], ["--painn_n_rbf", "64"],
], ids=lambda v: " ".join(v))
@pytest.mark.parametrize("driver", [
    "finetune_qm9", "finetune_lba", "finetune_lep", "finetune_md17",
    "pretrain_geossl", "pretrain_baselines"])
def test_drivers_accept_painn_widths_and_rbf_counts(driver, argv):
    """Every driver starts PaiNN on CUDA at any --emb_dim (the per-block
    kernels padded or in column blocks) and any --painn_n_rbf from 2
    (streamed above 31): its startup check passes, and the kernels' limits
    name nothing (no card needed)."""
    cfg = _driver_limits(driver, ["--model_3d", "painn", *argv])
    assert common.kernel_limit_errors(cfg, backward=True, ncsn=True) == []


def test_predictor_refuses_kernel_limits_at_startup(monkeypatch):
    cfg = _cfg("painn", r=1)
    state = {"model": common.make_backbone(cfg).state_dict()}
    serve.Predictor(cfg, state, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="--painn_n_rbf 1"):
        serve.Predictor(cfg, state)
    # PaiNN at other widths and RBF counts: the per-block kernels beyond
    # the stack's 128, the padded stack below it
    for wide in (_cfg("painn", emb=256, r=64), _cfg("painn", emb=96, r=40)):
        assert common.kernel_limit_errors(wide, backward=False,
                                          per_block=True,
                                          stack=wide.emb_dim <= 128) == []
    # SchNet: the stack's buckets (num_filters = emb_dim) check the stack,
    # which takes any Gaussian count
    assert common.kernel_limit_errors(_cfg(g=100, max_nb=32), backward=False,
                                      per_block=False, stack=True) == []
