"""The rest of serving in geossl_tpu_torch on the CPU, against the JAX
package: the reader of flax's msgpack ``.ckpt`` files, JAX checkpoints in
the Predictor and the fine-tunes, ``.sdf`` input, LEP pair serving, the
kernels' custom ops and the CLIs (the sealed artifacts are in
``test_torch_port_sealed.py``).

Tolerances: the ``.ckpt`` reader and ``store_from_sdf`` are exact (equal
arrays, dtypes and shapes); the port's Predictor against the JAX one on the
same ``.ckpt`` within rtol 1e-5 / atol 1e-6 in f32; the CLIs' CSV against
the Predictor within rtol 1e-6 (predict, pairs: ``str`` of an f32) and rtol
/ atol 1e-5 (embed: six significant digits).
"""

import functools
import io
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from geossl_tpu.config import ModelConfig as JModelConfig
from geossl_tpu.config import PaiNNConfig as JPaiNNConfig
from geossl_tpu.config import SchNetConfig as JSchNetConfig
from geossl_tpu.serve import Predictor as JPredictor
from geossl_tpu.serve import store_from_sdf as jstore_from_sdf
from geossl_tpu.train import checkpoints as jcheckpoints
from geossl_tpu.train import common as jcommon
from geossl_tpu_torch import __main__ as front
from geossl_tpu_torch import serve
from geossl_tpu_torch.config import ModelConfig, PaiNNConfig, SchNetConfig
from geossl_tpu_torch.ops import _launch
from geossl_tpu_torch.ops import ncsn as tns
from geossl_tpu_torch.serve import Predictor
from geossl_tpu_torch.train import checkpoints as tcheckpoints
from geossl_tpu_torch.train import finetune_lba as FL
from geossl_tpu_torch.train import finetune_lep as FE
from geossl_tpu_torch.train.common import DualHead, make_backbone, make_head
from geossl_tpu_torch.utils import flax_msgpack
from geossl_tpu_torch.utils.torch_import import (
    head_state_dict_from_flax,
    painn_state_dict_from_flax,
    schnet_state_dict_from_flax,
)
from tests.test_torch_port_data import assert_same_store
from tests.test_torch_port_serve import _store

SMALL = dict(num_filters=16, num_interactions=2, num_gaussians=8)
PSMALL = dict(n_interactions=2, n_rbf=8)
BACKBONES = ("schnet", "painn")


def _cfgs(model_3d):
    """(JAX config, port config) of a small backbone, width 16."""
    if model_3d == "painn":
        return (JModelConfig(model_3d="painn", emb_dim=16,
                             painn=JPaiNNConfig(n_atom_basis=16, **PSMALL)),
                ModelConfig(model_3d="painn", emb_dim=16,
                            painn=PaiNNConfig(n_atom_basis=16, **PSMALL)))
    return (JModelConfig(emb_dim=16, schnet=JSchNetConfig(**SMALL)),
            ModelConfig(emb_dim=16, schnet=SchNetConfig(**SMALL)))


@functools.lru_cache(maxsize=None)
def _jax_tree_of(model_3d, dual):
    return _jax_tree(_cfgs(model_3d)[0], dual)


def _jax_tree(jcfg, dual):
    """A JAX fine-tune checkpoint tree: backbone and head (LEP's DualHead
    with ``dual``), with the QM9 driver's ``y_mean``/``y_std`` otherwise.
    Use ``_jax_tree_of``: each init takes seconds, so each tree is made
    once."""
    module, _ = jcommon.make_backbone(jcfg)
    rng = jax.random.PRNGKey(int(dual))
    z = jnp.zeros((2, jcfg.emb_dim))
    if dual:
        head = jcommon.DualHead().init(rng, z, z)["params"]
    else:
        head = jcommon.make_head(jcfg.model_3d, jcfg.emb_dim).init(rng, z)[
            "params"]
    tree = {"model": jcommon.init_backbone(module, rng, n_max=64),
            "graph_pred_linear": head}
    tree = jax.tree_util.tree_map(np.asarray, tree)
    if not dual:
        tree.update(y_mean=np.float32(0.75), y_std=np.float32(2.5))
    return tree


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# -- the .ckpt reader -----------------------------------------------------------


@pytest.mark.parametrize("case", ["schnet_qm9", "painn_lep", "chunked"])
def test_ckpt_reader_reads_flax_bytes(case, tmp_path, monkeypatch):
    """The port's reader against flax's own restore, on the bytes
    ``flax.serialization.msgpack_serialize`` wrote: equal arrays, dtypes and
    shapes, numpy scalars of the same type."""
    if case == "chunked":
        # arrays above 64 bytes are split into chunks
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
        tree = {"model": {"w": np.arange(50, dtype=np.float32).reshape(5, 10),
                          "i": np.arange(40, dtype=np.int64)},
                "step": 7, "name": "x" * 40, "flag": True, "none": None,
                "f": -1.5, "lst": [1, -200000, 3.25]}
    else:
        tree = _jax_tree_of("schnet" if case == "schnet_qm9" else "painn",
                            case == "painn_lep")
    path = tmp_path / "model.ckpt"
    blob = serialization.msgpack_serialize(tree)
    path.write_bytes(blob)
    got = tcheckpoints.load_checkpoint(str(path))
    _assert_same_tree(got, serialization.msgpack_restore(blob))
    if case == "schnet_qm9":  # numpy scalars (ext type 3) stay scalars
        assert type(got["y_mean"]) is np.float32


def test_ckpt_reader_refuses_bfloat16_and_other_ext_types():
    with pytest.raises(ValueError, match="bfloat16"):
        flax_msgpack.loads(serialization.msgpack_serialize(
            {"w": np.ones(3, jnp.bfloat16)}))
    with pytest.raises(ValueError, match="ext type 2"):
        flax_msgpack.loads(serialization.msgpack_serialize({"c": 1 + 2j}))


# -- JAX checkpoints in the Predictor and the fine-tunes --------------------------


@pytest.mark.parametrize("model_3d", BACKBONES)
def test_predictor_on_a_jax_ckpt_matches_jax(model_3d, tmp_path):
    """The JAX Predictor on a ``.ckpt`` it saved against the port's
    ``Predictor.from_checkpoint`` on the same file: ``predict`` (y_mean /
    y_std from the file) and, on a LEP checkpoint, ``predict_pairs`` over
    pairs of four bucket combinations with partial chunks."""
    jcfg, tcfg = _cfgs(model_3d)
    kw = dict(batch_size=4, bucket_sizes=(32, 64))
    single, lep = str(tmp_path / "model.ckpt"), str(tmp_path / "lep.ckpt")
    jcheckpoints.save_checkpoint(single, _jax_tree_of(model_3d, False))
    jcheckpoints.save_checkpoint(lep, _jax_tree_of(model_3d, True))
    store = _store(9, 3, 60, seed=0)
    got = Predictor.from_checkpoint(single, tcfg, device="cpu", **kw)
    np.testing.assert_allclose(
        got.predict(store),
        JPredictor.from_checkpoint(single, jcfg, **kw).predict(store),
        rtol=1e-5, atol=1e-6)
    active, inactive = _store(11, 3, 60, seed=1), _store(11, 3, 60, seed=2)
    pairs = Predictor.from_checkpoint(lep, tcfg, device="cpu", **kw)
    assert pairs.head_kind == "dual"
    np.testing.assert_allclose(
        pairs.predict_pairs(active, inactive),
        JPredictor.from_checkpoint(lep, jcfg, **kw).predict_pairs(active,
                                                                  inactive),
        rtol=1e-5, atol=1e-6)
    other = "schnet" if model_3d == "painn" else "painn"
    with pytest.raises(ValueError, match=f"holds a {model_3d} backbone.*"
                                         f"model_3d='{other}'"):
        Predictor.from_checkpoint(single, _cfgs(other)[1], device="cpu")


@pytest.mark.parametrize("driver,model_3d,dual", [
    (FL, "schnet", False), (FE, "painn", True)], ids=["lba-schnet", "lep-painn"])
def test_load_input_model_reads_a_jax_ckpt(driver, model_3d, dual, tmp_path):
    """``--input_model_file model.ckpt``: the net's backbone and head
    states equal the JAX tree's, converted."""
    tree = _jax_tree_of(model_3d, dual)
    path = str(tmp_path / "model.ckpt")
    jcheckpoints.save_checkpoint(path, tree)
    flags = ["--model_3d", model_3d, "--emb_dim", "16", "--num_filters", "16",
             "--num_interactions", "2", "--num_gaussians", "8",
             "--painn_n_interactions", "2", "--painn_n_rbf", "8",
             "--input_model_file", path]
    args = driver.build_parser().parse_args(flags)
    from geossl_tpu_torch.train import common

    net = driver.make_net(args, common.model_config_from_args(args),
                          torch.Generator().manual_seed(0))
    ckpt = common.load_input_model(args, net)
    convert = (painn_state_dict_from_flax if model_3d == "painn"
               else schnet_state_dict_from_flax)
    for got, want in ((net.model.state_dict(), convert(tree["model"])),
                      (net.graph_pred_linear.state_dict(),
                       head_state_dict_from_flax(tree["graph_pred_linear"]))):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert ("y_mean" in ckpt) == (not dual)


# -- .sdf input -----------------------------------------------------------------

_V2000 = """h2o
  test

  3  2  0  0  0  0  0  0  0  0999 V2000
    0.0000    0.0000    0.1173 O   0  0  0  0  0  0  0  0  0  0  0  0
    0.0000    0.7572   -0.4692 H   0  0  0  0  0  0  0  0  0  0  0  0
    0.0000   -0.7572   -0.4692 H   0  0  0  0  0  0  0  0  0  0  0  0
  1  2  1  0
  1  3  1  0
M  END
$$$$
"""
_V3000 = """ch3cl
  test

  0  0  0     0  0            999 V3000
M  V30 BEGIN CTAB
M  V30 COUNTS 5 0 0 0 0
M  V30 BEGIN ATOM
M  V30 1 C 0.0 0.0 0.0 0
M  V30 2 Cl 1.78 0.0 0.0 0
M  V30 3 H -0.36 1.03 0.0 0
M  V30 4 H -0.36 -0.51 0.89 0
M  V30 5 H -0.36 -0.51 -0.89 0
M  V30 END ATOM
M  V30 END CTAB
M  END
$$$$
"""
_ETHANOL = """ethanol
  test

  9  8  0  0  0  0  0  0  0  0999 V2000
   -0.0014    1.0859    0.0080 C   0  0
    0.0021   -0.0041    0.0020 C   0  0
    0.9650   -0.5190    0.0000 O   0  0
   -1.0260    1.4480    0.0000 H   0  0
    0.5090    1.4600    0.8950 H   0  0
    0.5050    1.4560   -0.8800 H   0  0
   -0.5070   -0.3900    0.8880 H   0  0
   -0.5070   -0.3900   -0.8880 H   0  0
    1.8790   -0.2000    0.0000 H   0  0
  1  2  1  0
  2  3  1  0
  1  4  1  0
  1  5  1  0
  1  6  1  0
  2  7  1  0
  2  8  1  0
  3  9  1  0
M  END
$$$$
"""


def test_store_from_sdf_matches_jax(tmp_path):
    """V2000 blocks with hydrogens and bonds and a V3000 block: every array
    of the store equal to the JAX package's (its path without RDKit); an
    unparseable block raises with its index in both."""
    path = tmp_path / "mols.sdf"
    path.write_text(_V2000 + _V3000 + _ETHANOL)
    got = serve.load_input_store(str(path))
    assert_same_store(got, jstore_from_sdf(str(path)))
    assert len(got) == 3 and list(got.num_atoms()) == [3, 5, 9]
    assert got.bond_index.shape == (2, 4 + 0 + 16)
    bad = tmp_path / "bad.sdf"
    bad.write_text(_V2000 + "broken\n  test\n\n  x  y\n$$$$\n" + _ETHANOL)
    for load in (serve.store_from_sdf, jstore_from_sdf):
        with pytest.raises(ValueError, match="block #1"):
            load(str(bad))


# -- predict_pairs --------------------------------------------------------------


def test_predict_pairs_refusals():
    """Each head serves its own entry points; stores of different lengths
    and a backbone-only checkpoint are refused."""
    _, cfg = _cfgs("schnet")
    gen = torch.Generator().manual_seed(0)
    backbone = make_backbone(cfg, gen).state_dict()
    single = Predictor(cfg, {"model": backbone, "graph_pred_linear": make_head(
        "schnet", 16, gen).state_dict()}, device="cpu")
    dual = Predictor(cfg, {"model": backbone, "graph_pred_linear": DualHead(
        16, gen).state_dict()}, device="cpu")
    bare = Predictor(cfg, {"model": backbone}, device="cpu")
    a, b = _store(3, 3, 20, seed=0), _store(3, 3, 20, seed=1)
    assert (single.head_kind, dual.head_kind, bare.head_kind) == (
        "single", "dual", None)
    with pytest.raises(ValueError, match="needs LEP's dual head"):
        single.predict_pairs(a, b)
    for call in (lambda: dual.predict(a), lambda: dual.predict_forces(a)):
        with pytest.raises(ValueError, match="use predict_pairs"):
            call()
    with pytest.raises(ValueError, match="backbone-only"):
        bare.predict_pairs(a, b)
    with pytest.raises(ValueError, match="lengths differ: 3 vs 2"):
        dual.predict_pairs(a, _store(2, 3, 20, seed=2))
    assert dual.predict_pairs(a.select([]), b.select([])).shape == (0,)


# -- the custom ops ---------------------------------------------------------------


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g)

    b, n, f, ng, nr, layers, e = 2, 8, 4, 3, 3, 2, 8
    d = torch.rand((b, n, n), generator=g) * 3
    d = (d + d.transpose(1, 2)) / 2
    env = torch.rand((b, n, n), generator=g)
    filt = (r(ng, f), r(f), r(f, f), r(f))
    dirs = (r(b, n, n), r(b, n, n), r(b, n, n))
    x3, mu, wk, bk = r(b, n, 3 * f), r(b, n, 3 * f), r(nr, 3 * f), r(3 * f)
    sstack = [r(layers, f, f), r(layers, ng, f), r(layers, f),
              r(layers, f, f), r(layers, f), r(layers, f, f), r(layers, f),
              r(layers, f, f), r(layers, f)]
    pstack = [r(layers, f, f), r(layers, f), r(layers, f, 3 * f),
              r(layers, 3 * f), r(layers, nr, 3 * f), r(layers, 3 * f),
              r(layers, f, 2 * f), r(layers, 2 * f, f), r(layers, f),
              r(layers, f, 3 * f), r(layers, 3 * f)]
    heads = [r(*s) * 0.3 for s in tns.weight_shapes(e)]
    sel = (torch.rand((b, n, n), generator=g) > 0.5).float()
    sigma = torch.rand((b,), generator=g) + 0.1
    cases = {}
    for sym in (False, True):
        tag = "sym" if sym else "plain"
        cases[f"cfconv_fwd-{tag}"] = ("cfconv_fwd", (
            d, env, r(b, n, f), *filt, 0.0, 5.0, ng, sym, sym))
        cases[f"cfconv_bwd-{tag}"] = ("cfconv_bwd", (
            d, env, r(b, n, f), r(b, n, f), *filt, 0.0, 5.0, ng, sym, True))
        cases[f"schnet_stack-{tag}"] = ("schnet_stack", (
            d, env, r(b, n, f), sstack, 0.0, 5.0, ng, sym))
        cases[f"painn_fwd-{tag}"] = ("painn_fwd", (
            d, env, *dirs, x3, mu, wk, bk, 5.0, sym, not sym))
        cases[f"painn_bwd-{tag}"] = ("painn_bwd", (
            d, env, *dirs, x3, mu, wk, bk, r(b, n, f), r(b, n, 3 * f), 5.0,
            sym, True))
    for name in ("painn_stack", "painn_stack_train"):
        cases[name] = (name, (d, env, *dirs, r(b, n, f), pstack, 5.0, 1e-8))
    u = r(b, n, e)
    cases["ncsn_score_fwd"] = ("ncsn_score_fwd", (
        d, r(b, n, n), sel, sigma, u, heads, 2.0))
    cases["ncsn_score_bwd"] = ("ncsn_score_bwd", (
        d, r(b, n, n), sel, sigma, u, r(b, n), heads, 2.0))
    return cases


_OP_CASES = sorted(_op_cases())


@pytest.mark.parametrize("case", _OP_CASES)
def test_kernel_op_passes_opcheck(case):
    """``torch.library.opcheck`` (schema, fake implementation against the
    real one, autograd registration, AOT dispatch) of each kernel's custom
    op in each of its modes, at small shapes on the CPU (its CPU
    implementation: the wrapper's plain version)."""
    name, args = _op_cases()[case]
    torch.library.opcheck(_launch.OPS[name], args)


def test_every_launch_is_an_op_in_one_namespace():
    assert sorted(_launch.OPS) == sorted(
        {name for name, _ in _op_cases().values()})
    for op in _launch.OPS.values():
        assert op._qualname.startswith("geossl_torch::")


# -- the CLIs ---------------------------------------------------------------------


def test_serve_pairs_cli_and_its_usage_error(tmp_path, capsys):
    """``--mode pairs`` without ``--input_inactive`` exits before it opens
    ``--output`` (an existing file is left as it was); with it, one
    probability per pair, as ``predict_pairs``."""
    cfg = ModelConfig()  # the CLI serves the default configuration
    gen = torch.Generator().manual_seed(0)
    ckpt = str(tmp_path / "lep.pth")
    torch.save({"model": make_backbone(cfg, gen).state_dict(),
                "graph_pred_linear": DualHead(128, gen).state_dict()}, ckpt)
    a, b = _store(3, 3, 12, seed=0), _store(3, 3, 12, seed=1)
    npz_a, npz_b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    a.save(npz_a)
    b.save(npz_b)
    out = tmp_path / "pairs.csv"
    out.write_text("keep me\n")
    base = ["--ckpt", ckpt, "--input", npz_a, "--output", str(out),
            "--mode", "pairs", "--device", "cpu", "--bucket", "16"]
    with pytest.raises(SystemExit, match="--input_inactive"):
        serve.main(base)
    assert out.read_text() == "keep me\n"
    serve.main(base + ["--input_inactive", npz_b])
    rows = [line.split(",") for line in out.read_text().splitlines()]
    want = Predictor.from_checkpoint(ckpt, cfg, bucket_sizes=(16,),
                                     device="cpu").predict_pairs(a, b)
    assert [r[0] for r in rows] == ["0", "1", "2"]
    np.testing.assert_allclose([float(r[1]) for r in rows], want, rtol=1e-6)


def test_front_door_usage_and_seal(tmp_path, capsys):
    """``python -m geossl_tpu_torch``: the usage text names every command,
    the JAX package's unported ones exit with 2, and ``seal`` writes an
    artifact that ``serve`` replays."""
    assert front.main([]) == 0
    usage = capsys.readouterr().out
    for cmd in ("pretrain", "pretrain-baseline", "finetune-qm9",
                "finetune-md17", "finetune-lba", "finetune-lep", "serve",
                "seal", "data", "evalkit", "doctor"):
        assert cmd in usage
    for cmd in ("data", "evalkit", "doctor"):
        assert front.main([cmd]) == 2
        assert "not ported" in capsys.readouterr().err
    assert front.main(["nope"]) == 2
    gen = torch.Generator().manual_seed(0)
    cfg = ModelConfig()
    ckpt, art = str(tmp_path / "model.pth"), str(tmp_path / "m.sealed")
    torch.save({"model": make_backbone(cfg, gen).state_dict()}, ckpt)
    assert front.main(["seal", "--ckpt", ckpt, "--out", art, "--modes",
                       "embed", "--bucket", "16", "--batch_size", "8",
                       "--device", "cpu"]) == 0
    assert "sealed 1 programs" in capsys.readouterr().out
    with zipfile.ZipFile(art) as z:
        assert sorted(z.namelist()) == ["meta.json", "programs/embed_16.pt2",
                                        "weights.pt"]
        state = torch.load(io.BytesIO(z.read("weights.pt")),
                           weights_only=True)
    # the weights once: in weights.pt, not in the program
    assert "model.embedding.weight" in state["weights"]
    store = _store(3, 3, 12, seed=3)
    npz = str(tmp_path / "m.npz")
    store.save(npz)
    assert front.main(["serve", "--ckpt", art, "--input", npz, "--mode",
                       "embed"]) == 0
    lines = capsys.readouterr().out.splitlines()
    want = Predictor.from_checkpoint(ckpt, cfg, batch_size=8,
                                     bucket_sizes=(16,),
                                     device="cpu").embed(store)
    got = np.asarray([[float(v) for v in line.split(",")[1:]]
                      for line in lines], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
