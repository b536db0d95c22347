"""The Atom3D fine-tune slice of geossl_tpu_torch (LBA, LEP) against the JAX
package on the CPU, where every kernel wrapper takes its plain version.

* Data: the NumPy pieces give identical output: the structure parsers,
  ``transform_lba``, ``build_lba`` (store arrays and a byte-identical
  ``pdb_id2data_id`` JSON), the LEP record decoding and caches, the splits,
  ``synthetic_lep``, ``MolStore.select``, ``bucket_chunks`` and the dual
  loader's batches; the metrics to 1e-12.
* The drivers in f64 (real f64 on the JAX side, inside x64), both
  backbones: the LBA MSE and the LEP BCE loss, every gradient and a 4-step
  Adam trajectory against the JAX drivers' ``loss_fn``/``step_body`` at
  rtol 1e-10, the weights carried across by ``utils/torch_import``.
* The CLIs end to end on the CPU: two epochs, a pretrain ``model.pth`` in,
  the fine-tuned ``model.pth`` back under ``--eval_only``, ``--resume``,
  the refusals.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geossl_tpu.data import bucketing as jbucket
from geossl_tpu.data import lba as jlba
from geossl_tpu.data import lep as jlep
from geossl_tpu.data import splitters as jsplit
from geossl_tpu.data import structio as jstructio
from geossl_tpu.data import synthetic as jsyn
from geossl_tpu.models.painn import PaiNN as JPaiNN
from geossl_tpu.models.schnet import SchNet as JSchNet
from geossl_tpu.train import common as jcommon
from geossl_tpu.train import finetune_lep as jlep_driver
from geossl_tpu.train import optim as joptim
from geossl_tpu.utils import metrics as jmetrics
from geossl_tpu_torch.data import bucketing as tbucket
from geossl_tpu_torch.data import lba as tlba
from geossl_tpu_torch.data import lep as tlep
from geossl_tpu_torch.data import splitters as tsplit
from geossl_tpu_torch.data import structio as tstructio
from geossl_tpu_torch.data import synthetic as tsyn
from geossl_tpu_torch.data.batch import DenseMolBatch, DualMolBatch
from geossl_tpu_torch.data.store import MolStore
from geossl_tpu_torch.models.painn import PaiNN
from geossl_tpu_torch.models.schnet import SchNet
from geossl_tpu_torch.train import checkpoints, common, optim
from geossl_tpu_torch.train import finetune_lba as FL
from geossl_tpu_torch.train import finetune_lep as FE
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

EMB = 16

# -- data: identical output -------------------------------------------------------


def _pdb_text():
    """The ingestion tests' protein plus an altloc pair, a blank element
    column, a long hydrogen name and an NMR second model."""
    extra = [
        ING.pdb_line(7, " CB", "SER", "B", 4, (2.0, 1.0, 0.0), "C", altloc="A"),
        ING.pdb_line(8, " CB", "SER", "B", 4, (2.1, 1.0, 0.0), "C", altloc="B"),
        ING.pdb_line(9, "FE1", "HEM", "B", 5, (3.0, 0.0, 1.0), " ",
                     record="HETATM"),
        ING.pdb_line(10, "HG11", "VAL", "B", 6, (4.0, 0.0, 1.0), " "),
        ING.pdb_line(11, " N", "ALA", "C", 7, (5.0, 1.0, 1.0), "N", icode="A"),
        "ENDMDL",
        ING.pdb_line(12, " N", "ALA", "C", 8, (9.0, 9.0, 9.0), "N"),
    ]
    return ING.make_protein_pdb().replace("END", "\n".join(extra))


def test_structure_parsers_match_jax():
    text = _pdb_text()
    got, want = tstructio.parse_pdb(text), jstructio.parse_pdb(text)
    for name in ("elements", "res_names", "chain_ids", "icodes"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("coords", "res_seqs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.residue_keys() == want.residue_keys() and len(got) == 10
    v2000 = ING.make_ligand_sdf(("C", "CL", "Br"), ((0, 0, 1), (1, 0, 2),
                                                   (0.5, 1.5, 3)))
    v3000 = "\n".join(["lig", "  x", "", "  0  0  0     0  0            999 V3000",
                       "M  V30 BEGIN CTAB", "M  V30 COUNTS 2 0 0 0 0",
                       "M  V30 BEGIN ATOM", "M  V30 1 C 0.1 0.2 0.3 0",
                       "M  V30 2 CL 1.5 -2.0 0.25 0", "M  V30 END ATOM",
                       "M  V30 END CTAB", "M  END"])
    for sdf in (v2000, v3000):
        (ge, gc), (we, wc) = tstructio.parse_sdf(sdf), jstructio.parse_sdf(sdf)
        assert ge == we
        np.testing.assert_array_equal(gc, wc)
    with pytest.raises(ValueError):
        tstructio.parse_sdf("too\nshort")
    index = ("# comment\n1abc  2.00  2015  4.50  Kd=31uM  // x\n"
             "2xyz 1.9 2016 7.25 Ki=1nM\nbad line\n")
    assert tstructio.parse_index_refined(index) == \
        jstructio.parse_index_refined(index)


def _complex(seed):
    rng = np.random.default_rng(seed)
    elems = ["C", "N", "O", "H", "S", "Zn", "CL", "F", "P", "Se"]
    pocket_e = list(rng.choice(elems, 60))
    ligand_e = list(rng.choice(elems, 12))
    pocket = rng.normal(scale=6.0, size=(60, 3)).astype(np.float32)
    ligand = rng.normal(scale=1.5, size=(12, 3)).astype(np.float32)
    return pocket_e, pocket, ligand_e, ligand


@pytest.mark.parametrize("dist,maxnum", [(6.0, 500), (4.0, 20)])
def test_transform_lba_matches_jax(dist, maxnum):
    args = _complex(seed=int(dist))
    got = tlba.transform_lba(*args, dist=dist, maxnum=maxnum)
    want = jlba.transform_lba(*args, dist=dist, maxnum=maxnum)
    np.testing.assert_array_equal(got.atom_type, want.atom_type)
    np.testing.assert_array_equal(got.positions, want.positions)
    assert got.atom_type.dtype == want.atom_type.dtype


def test_build_lba_and_pocket_match_jax(tmp_path):
    roots = []
    for name in ("jax", "port"):
        roots.append(str(tmp_path / name))
        ING.write_lba_raw(roots[-1], pdb_ids=("3def", "1abc", "2xyz"),
                          labels=(5.0, 4.5, 7.25))
    want, got = jlba.build_lba(roots[0]), tlba.build_lba(roots[1])
    assert_same_store(got, want)
    texts = []
    for r in roots:
        with open(os.path.join(r, "processed", "pdb_id2data_id_2020.json"),
                  "rb") as f:
            texts.append(f.read())
    assert texts[0] == texts[1] and json.loads(texts[1])["1abc"] == 0
    assert_same_store(tlba.load_lba(roots[1]), want)
    protein = tstructio.parse_pdb(ING.make_protein_pdb())
    lig = np.asarray([[0, 0, 1.0]], np.float32)
    np.testing.assert_array_equal(
        tlba.get_pocket_atom_indices(protein, lig),
        jlba.get_pocket_atom_indices(jstructio.parse_pdb(ING.make_protein_pdb()),
                                     lig))
    with pytest.raises(FileNotFoundError):
        tlba.load_lba(str(tmp_path / "none"))


def test_lep_records_and_caches_match_jax(tmp_path):
    items = [ING.make_lep_item(label=lab, n_prot=20, n_lig=4, seed=s)
             for s, lab in enumerate("AIAI")]
    items.append(ING.make_lep_item(label="I", far=True, seed=9))
    for item in items:
        raw = ING.atom3d_serialize(item)
        assert tlep.deserialize_lmdb_item(raw) == jlep.deserialize_lmdb_item(raw)
        for kw in ({}, {"dist": 3.0, "maxnum": 10}):
            got, want = tlep.item_to_records(item, **kw), \
                jlep.item_to_records(item, **kw)
            assert got[2] == want[2]
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(g.atom_type, w.atom_type)
                np.testing.assert_array_equal(g.positions, w.positions)
    got = tlep.build_lep_split(items, str(tmp_path / "port"), "val")
    want = jlep.build_lep_split(items, str(tmp_path / "jax"), "val")
    for g, w in zip(got[:2], want[:2]):
        assert_same_store(g, w)
    np.testing.assert_array_equal(got[2], want[2])
    loaded = tlep.load_lep(str(tmp_path / "jax"), "val")
    assert_same_store(loaded[0], want[0])
    np.testing.assert_array_equal(loaded[2], want[2])
    with pytest.raises(FileNotFoundError):
        tlep.load_lep(str(tmp_path / "none"), "train")


def test_splits_and_select_match_jax(tmp_path):
    for n, seed in ((10, 42), (97, 3)):
        for got, want in zip(tsplit.random_split(n, seed=seed),
                             jsplit.random_split(n, seed=seed)):
            np.testing.assert_array_equal(got, want)
    proc = tmp_path / "processed"
    (proc / "targets").mkdir(parents=True)
    (proc / "pdb_id2data_id_2019.json").write_text(
        json.dumps({"1abc": 0, "2xyz": 1, "3def": 2, "4ghi": 3}))
    for mode, ids in (("train", "3def\n1abc\n"), ("val", "4ghi\n\n"),
                      ("test", "2xyz\n")):
        (proc / "targets" / f"{mode}.txt").write_text(ids)
    for got, want in zip(tsplit.atom3d_lba_split(str(tmp_path), 2019),
                         jsplit.atom3d_lba_split(str(tmp_path), 2019)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    store = jsyn.synthetic_molecule3d(12, seed=2, max_atoms=30)
    tstore = MolStore(store.atom_type, store.positions, store.offsets,
                      store.chirality, store.bond_index, store.bond_offsets,
                      store.y)
    idx = np.asarray([7, 2, 11, 2, 0])
    assert_same_store(tstore.select(idx), store.select(idx))


def test_synthetic_lep_matches_jax():
    got, want = tsyn.synthetic_lep(9, max_atoms=120), \
        jsyn.synthetic_lep(9, max_atoms=120)
    for g, w in zip(got[:2], want[:2]):
        assert_same_store(g, w)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("shuffle,batch_size", [(True, 3), (False, 3),
                                                (True, 4), (False, 4)])
def test_bucket_chunks_match_jax(shuffle, batch_size):
    bucket_of = np.asarray([32, 64, 32, 32, 128, 64, 32, 64, 32, 128, 32])
    got = tbucket.bucket_chunks(bucket_of, batch_size,
                                np.random.default_rng(4), shuffle)
    want = jbucket.bucket_chunks(bucket_of, batch_size,
                                 np.random.default_rng(4), shuffle)
    assert [b for b, _ in got] == [b for b, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shuffle", [True, False])
def test_dual_loader_batches_match_jax(monkeypatch, shuffle):
    """Batch for batch, on both packages' NumPy paths (the JAX DualLoader's
    C++ packer switched off; the port's by ``GEOSSL_NO_NATIVE``)."""
    from geossl_tpu.native import packing

    monkeypatch.setattr(packing, "available", lambda: False)
    monkeypatch.setenv("GEOSSL_NO_NATIVE", "1")
    _check_dual_loader(shuffle)


@pytest.mark.parametrize("shuffle", [True, False])
def test_dual_loader_batches_match_jax_native(shuffle):
    """Batch for batch, on both packages' default paths (the C++ packer)."""
    _check_dual_loader(shuffle)


def _check_dual_loader(shuffle):
    act, inact, labels = jsyn.synthetic_lep(11, max_atoms=70)
    jl = jlep_driver.DualLoader(act, inact, labels, 4, (32, 64, 128),
                                shuffle=shuffle, seed=5)
    tl = FE.DualLoader(*(MolStore(s.atom_type, s.positions, s.offsets)
                         for s in (act, inact)), labels, 4, (32, 64, 128),
                       shuffle=shuffle, seed=5)
    assert (tl._native is None) == (jl._native is None)
    assert len(tl) == len(jl)
    jbs, tbs = list(jl.epoch(2)), list(tl.epoch(2))
    assert len(jbs) == len(tbs) > 1
    for jb, tb in zip(jbs, tbs):
        np.testing.assert_array_equal(tb.y.numpy(), np.asarray(jb.y))
        for tower in ("active", "inactive"):
            for name in ("atom_type", "positions", "node_mask", "graph_mask"):
                np.testing.assert_array_equal(
                    getattr(getattr(tb, tower), name).numpy(),
                    np.asarray(getattr(getattr(jb, tower), name)))


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    y = rng.normal(size=200)
    f = np.round(y + rng.normal(scale=0.7, size=200), 1)  # ties
    for name in ("mse", "rmse", "pearson", "spearman"):
        np.testing.assert_allclose(getattr(tmetrics, name)(y, f),
                                   getattr(jmetrics, name)(y, f), rtol=1e-12)
    np.testing.assert_array_equal(tmetrics._rankdata(f), jmetrics._rankdata(f))
    labels = rng.integers(0, 2, 200).astype(np.float32)
    scores = np.round(labels + rng.normal(size=200), 1)
    for name in ("roc_auc", "pr_auc"):
        np.testing.assert_allclose(getattr(tmetrics, name)(labels, scores),
                                   getattr(jmetrics, name)(labels, scores),
                                   rtol=1e-12)
        assert np.isnan(getattr(tmetrics, name)(np.zeros(4), scores[:4]))


# -- the drivers in f64 ------------------------------------------------------------


_BACKBONES = {
    "schnet": (lambda: JSchNet(**S.SMALL), lambda: SchNet(**S.SMALL),
               schnet_state_dict_from_flax, contextlib.nullcontext),
    "painn": (lambda: JPaiNN(**P.SMALL), lambda: PaiNN(**P.SMALL),
              painn_state_dict_from_flax, P.f64_casts),
}


def _batch(seed, n=24):
    """Three padded complexes (the last slot empty) and their labels."""
    z, pos, mask = S.molecules(3, n, seed=seed, spread=1.4)
    mask[2], z[2], pos[2] = False, 0, 0.0
    y = np.random.default_rng(seed).normal(size=(3, 1))
    return z, pos, mask, mask.any(axis=1), y


def _label(b):
    """LEP's binary label of a batch made by :func:`_batch`."""
    return (b[4][:, 0] > 0).astype(np.float64)


def _dense(z, pos, mask, gm, y=None):
    return DenseMolBatch(atom_type=torch.from_numpy(z).long(),
                         positions=torch.from_numpy(pos),
                         node_mask=torch.from_numpy(mask),
                         graph_mask=torch.from_numpy(gm),
                         y=None if y is None else torch.from_numpy(y))


@pytest.fixture(scope="module", params=[(d, m) for d in ("lba", "lep")
                                        for m in sorted(_BACKBONES)],
                ids=lambda p: "-".join(p))
def driver_case(request):
    """The JAX driver's jitted value_and_grad(loss_fn), the JAX f64
    params, the steps' inputs, and the port's net, batches and state_dict
    names, of one driver and backbone."""
    task, model_3d = request.param
    make_jax, make_port, to_port, jax_ctx = _BACKBONES[model_3d]
    steps = [(_batch(30 + s), _batch(40 + s)) for s in range(4)]
    jm = make_jax()
    head = jcommon.DualHead() if task == "lep" else \
        jcommon.make_head(model_3d, EMB)
    z, pos, mask = (jnp.asarray(a) for a in steps[0][0][:3])
    with S.x64():
        k1, k2 = jax.random.split(jax.random.PRNGKey(7))
        params = {"model": jax.jit(jm.init)(k1, z, pos.astype(jnp.float32),
                                            mask)["params"]}
        h = jnp.zeros((2, EMB))
        params["graph_pred_linear"] = (head.init(k2, h, h) if task == "lep"
                                       else head.init(k2, h))["params"]
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                        params)

    def graph(p, b):
        with jax_ctx():
            g, _ = jm.apply({"params": p["model"]}, jnp.asarray(b[0]),
                            jnp.asarray(b[1]), jnp.asarray(b[2]))
        return g

    def jax_loss(p, step):
        """As finetune_lba/finetune_lep.main build loss_fn."""
        b, b2 = step
        apply = lambda *g: head.apply({"params": p["graph_pred_linear"]}, *g)
        if task == "lba":
            per = (apply(graph(p, b)) - jnp.asarray(b[4])[:, 0]) ** 2
        else:  # towers: b active, b2 inactive at the same width
            logits = apply(graph(p, b), graph(p, b2))
            per = optax.sigmoid_binary_cross_entropy(logits,
                                                     jnp.asarray(_label(b)))
        return jcommon.graph_masked_mean(per, jnp.asarray(b[3]))

    def port_batch(step):
        b, b2 = step
        if task == "lba":
            return _dense(*b)
        return DualMolBatch(_dense(*b[:4]), _dense(*b2[:4]),
                            torch.from_numpy(_label(b)))

    def port_net():
        # PaiNN: the JAX model's XLA path, whose port is plain=True
        net_cls = FL.LBANet if task == "lba" else FE.LEPNet
        phead = (common.DualHead(EMB) if task == "lep"
                 else common.make_head(model_3d, EMB))
        net = net_cls(make_port(), phead, plain=model_3d == "painn").double()
        net.model.load_state_dict(to_port(params["model"]))
        net.graph_pred_linear.load_state_dict(
            head_state_dict_from_flax(params["graph_pred_linear"]))
        return net

    def as_port(tree):
        sd = {f"model.{k}": v for k, v in to_port(tree["model"]).items()}
        sd.update({f"graph_pred_linear.{k}": v for k, v in
                   head_state_dict_from_flax(tree["graph_pred_linear"]).items()})
        return sd

    loss_fn = FL.loss_fn if task == "lba" else FE.loss_fn
    # one compile serves both tests (op by op, the f64 PaiNN runs slowly)
    return dict(value_and_grad=jax.jit(jax.value_and_grad(jax_loss)),
                params=params, steps=steps,
                port_batch=port_batch, port_net=port_net, as_port=as_port,
                loss_fn=loss_fn)


def test_finetune_loss_and_every_gradient_match_jax_f64(driver_case):
    c = driver_case
    with S.x64():
        want, jgrad = c["value_and_grad"](c["params"], c["steps"][0])
        jgrad = c["as_port"](jax.tree_util.tree_map(np.asarray, jgrad))
    net = c["port_net"]()
    loss = c["loss_fn"](net, c["port_batch"](c["steps"][0]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-10)
    named = dict(net.named_parameters())
    assert sorted(named) == sorted(jgrad)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), jgrad[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def test_finetune_adam_trajectory_matches_jax_f64(driver_case):
    """4 steps of the JAX driver's step_body against the port's
    finetune_step (Adam with weight decay, per-epoch cosine over 2 epochs of
    2 steps)."""
    c = driver_case
    lr, decay = 5e-3, 0.01
    with S.x64():
        tx = joptim.make_optimizer(lr, 2, 2, decay, "CosineAnnealingLR")
        state = jcommon.TrainState.create(
            jax.tree_util.tree_map(jnp.asarray, c["params"]), tx)

        @jax.jit
        def step_body(state, step):  # as the driver's train_step
            loss, grads = c["value_and_grad"](state.params, step)
            return jcommon.apply_updates(state, grads, tx), loss

        want = []
        for step in c["steps"]:
            state, loss = step_body(state, step)
            want.append(float(loss))
        final = c["as_port"](jax.tree_util.tree_map(np.asarray, state.params))
    net = c["port_net"]()
    opt, sched = optim.make_optimizer(net.parameters(), lr, 2, 2, decay,
                                      "CosineAnnealingLR")
    got = [common.finetune_step(net, opt, sched, [c["port_batch"](s)],
                                c["loss_fn"]).item() for s in c["steps"]]
    np.testing.assert_allclose(got, want, rtol=1e-10)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


# -- the CLIs on the CPU ---------------------------------------------------------

TINY = ["--emb_dim", "16", "--num_filters", "16", "--num_interactions", "2",
        "--num_gaussians", "8", "--batch_size", "8", "--bucket", "128", "256"]
_DRIVERS = {"lba": (FL, "MSE", 24), "lep": (FE, "ROC", 40)}


def _argv(out, size, *extra):
    return ["--device", "cpu", "--synthetic", "--synthetic_size", str(size),
            "--output_model_dir", str(out), *TINY, *extra]


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A model.pth from the port's DDM pretraining at the same tiny width."""
    out = tmp_path_factory.mktemp("pretrain")
    PG.main(["--device", "cpu", "--synthetic", "--synthetic_size", "8",
             "--synthetic_max_atoms", "30", "--epochs", "1",
             "--output_model_dir", str(out), *TINY[:-2], "32"])
    return str(out / "model.pth")


@pytest.mark.parametrize("task", sorted(_DRIVERS))
def test_finetune_cli_on_cpu(tmp_path, capsys, pretrained, task):
    driver, metric, size = _DRIVERS[task]
    log = str(tmp_path / "log.jsonl")
    net, best, best_test, losses = driver.main(_argv(
        tmp_path, size, "--epochs", "2", "--input_model_file", pretrained,
        "--log_file", log))
    out = capsys.readouterr().out
    assert "Loaded pretrained backbone" in out and "Epoch: 2\tLoss" in out
    assert f"best val {metric}" in out
    assert losses and np.isfinite(losses).all() and np.isfinite(best)
    with open(log) as f:
        lines = [json.loads(line) for line in f]
    assert [r.get("epoch") for r in lines[:2]] == [1, 2] and lines[-1]["final"]
    # the pretrained backbone went in: its untrained embedding rows agree
    pre = checkpoints.load_checkpoint(pretrained)["model"]
    assert set(pre) == set(net.model.state_dict())
    # the fine-tuned model.pth reloads under --eval_only
    saved = checkpoints.load_checkpoint(str(tmp_path / "model.pth"))
    assert set(saved) == {"model", "graph_pred_linear"}
    _, val, test, none = driver.main(_argv(
        tmp_path / "eval", size, "--eval_only", "--input_model_file",
        str(tmp_path / "model.pth")))
    assert none == [] and "eval-only" in capsys.readouterr().out
    np.testing.assert_allclose(val, best, rtol=1e-6)
    assert test.keys() == best_test.keys()
    with pytest.raises(SystemExit, match="FINE-TUNED"):
        driver.main(_argv(tmp_path / "e2", size, "--eval_only",
                          "--input_model_file", pretrained))
    # --resume runs only the epochs left
    _, _, _, more = driver.main(_argv(tmp_path, size, "--epochs", "3",
                                      "--resume"))
    assert "Resumed from" in capsys.readouterr().out
    assert len(more) == len(losses) // 2


@pytest.mark.parametrize("task,extra", [("lba", ["--pair_devices", "2"]),
                                        ("lep", ["--num_processes", "2"])])
def test_finetune_cli_refuses_unported_paths(tmp_path, task, extra):
    driver, _, size = _DRIVERS[task]
    with pytest.raises(NotImplementedError, match=extra[0]):
        driver.main(_argv(tmp_path, size, "--epochs", "1", *extra))


@pytest.mark.parametrize("task", sorted(_DRIVERS))
def test_finetune_runs_on_cuda_by_default(tmp_path, monkeypatch, task):
    driver, _, size = _DRIVERS[task]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path, size, "--epochs", "1")
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.main(argv)
