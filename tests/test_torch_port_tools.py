"""The port's tools against the JAX package's: ``doctor`` (its checks on
the CPU, its failure without a card, ``--mesh``, the kernel checks' harness
on the plain versions), the front door (its commands, the doctor's exit
code), ``evalkit`` (the cells and every driver command line against the
JAX kit's, ``report``, a CPU smoke of one cell per family and its resume),
and ``parallel/mesh.rank_device``, which uses the CPU only when asked."""

import json
import os
import time

import numpy as np
import pytest
import torch

from geossl_tpu import __main__ as jfront
from geossl_tpu import evalkit as jkit
from geossl_tpu.train import finetune_lba as jlba
from geossl_tpu.train import finetune_lep as jlep
from geossl_tpu.train import finetune_md17 as jmd17
from geossl_tpu.train import finetune_qm9 as jqm9
from geossl_tpu_torch import __main__ as front
from geossl_tpu_torch import doctor
from geossl_tpu_torch import evalkit as tkit
from geossl_tpu_torch.config import ModelConfig, SchNetConfig
from geossl_tpu_torch.ops._launch import launch_counts
from geossl_tpu_torch.parallel import mesh as pmesh
from geossl_tpu_torch.train import common
from geossl_tpu_torch.train import finetune_lba as tlba
from geossl_tpu_torch.train import finetune_lep as tlep
from geossl_tpu_torch.train import finetune_md17 as tmd17
from geossl_tpu_torch.train import finetune_qm9 as tqm9

# Six test workers share the machine's cores: one intra-op thread each.
torch.set_num_threads(1)

KEYS = {"ok", "backend", "build", "dispatch", "kernels", "native"}


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# -- doctor ---------------------------------------------------------------------


def test_doctor_on_the_cpu_passes_and_launches_nothing(capsys):
    assert doctor.main(["--device", "cpu", "--json"]) == 0
    out = capsys.readouterr().out
    s = json.loads(out.strip().splitlines()[-1])
    assert set(s) == KEYS and s["ok"]
    assert s["backend"]["platform"] == "cpu"
    assert s["kernels"] == {"ok": True, "mode": "not run (--device cpu)",
                            "checked": []}
    assert "[skip] cuda kernels: --device cpu" in out
    assert s["dispatch"]["value"] == 256.0 ** 3
    assert set(s["dispatch"]) >= {"first_s", "steady_ms", "synced_ms",
                                  "fence_reliable"}
    if s["build"]["nvcc"] is None:  # no CUDA toolkit: a warning on the CPU
        assert "[warn] build" in out


def test_doctor_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert doctor.main(["--json"]) == 1
    s = _summary(capsys)
    assert not s["ok"] and s["backend"]["ok"] is False
    assert "kernels" not in s  # nothing ran on the CPU in its place
    assert front.main(["doctor", "--json"]) == 1  # the front door's rc
    capsys.readouterr()
    assert front.main(["doctor", "--device", "cpu"]) == 0


def test_doctor_mesh_two_gloo_ranks(capsys):
    assert doctor.main(["--device", "cpu", "--mesh", "2", "--json"]) == 0
    s = _summary(capsys)
    assert s["mesh"] == {"ok": True, "n": 2, "sums": [3.0, 3.0]}


def test_doctor_kernel_checks_cover_every_kernel():
    """The checks' harness on CPU tensors (the wrappers' plain versions):
    every kernel with a launch counter has its checks, and no count moves,
    which the doctor on the card reports as a failure."""
    rows = doctor.run_kernel_checks(torch.device("cpu"))
    assert set(rows) == set(launch_counts())
    for name, row in rows.items():
        assert row["checks"] >= 1 and row["launches"] == 0, name
        if name in ("cfconv_fwd", "cfconv_fwd_sym", "schnet_stack",
                    "ncsn_score_fwd", "ncsn_score_bwd", "painn_fwd",
                    "painn_fwd_sym", "painn_stack", "painn_stack_train"):
            assert row["failures"] == [] and row["max_abs_err"] == 0.0, name


def test_front_door_has_the_jax_commands(capsys):
    assert list(front.COMMANDS) == list(jfront.COMMANDS)
    assert front.main(["--help"]) == 0
    usage = capsys.readouterr().out
    assert "not ported" not in usage
    for cmd in jfront.COMMANDS:
        assert f"  {cmd} " in usage
    assert front.main(["nope"]) == 2


def test_rank_device_uses_the_cpu_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.rank_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.rank_device("cuda")
    assert pmesh.rank_device("cpu") == torch.device("cpu")
    assert pmesh.rank_device("cuda:1") == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert pmesh.rank_device() == torch.device("cuda", 1)


# -- evalkit ----------------------------------------------------------------------

_DRIVERS = {"qm9": (jqm9, tqm9), "md17": (jmd17, tmd17),
            "lba": (jlba, tlba), "lep": (jlep, tlep)}


def _canned(family, seed):
    """A driver's result in each package's form: (JAX, port)."""
    val = 0.25 + seed / 100
    test = {"qm9": 0.5, "md17": (1.5, 0.75),
            "lba": {"mse": 2.0 + seed, "rmse": 1.25, "pearson": 0.5,
                    "spearman": 0.25},
            "lep": {"roc": 0.625, "pr": 0.5 + seed / 1000}}[family]
    return (val, test), (None, val, test, [])


@pytest.mark.parametrize("model_3d", ["schnet", "painn"])
@pytest.mark.parametrize("budget", ["smoke", "paper"])
def test_evalkit_cells_and_driver_argv_match_jax(tmp_path, monkeypatch,
                                                 model_3d, budget):
    import jax

    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    seen = {"jax": [], "port": []}
    for family, mods in _DRIVERS.items():
        for pkg, mod in zip(("jax", "port"), mods):
            def fake(argv, family=family, pkg=pkg):
                seen[pkg].append((family, list(argv)))
                seed = int(argv[argv.index("--seed") + 1])
                return _canned(family, seed)[pkg == "port"]
            monkeypatch.setattr(mod, "main", fake)
    base = ["--input_model_file", "m.pth", "--model_3d", model_3d,
            "--budget", budget, "--qm9_tasks", "mu", "gap", "--md17_tasks",
            "aspirin", "--atom3d_seeds", "12", "22", "--data_root", "d"]
    want = jkit.main(base + ["--out_dir", str(tmp_path / "jax")])
    got = tkit.main(base + ["--out_dir", str(tmp_path / "port"), "--device",
                            "cpu"])
    assert got == want
    assert len(seen["port"]) == len(seen["jax"]) == 2 + 1 + 2 + 2
    for (fam_t, t), (fam_j, j) in zip(seen["port"], seen["jax"]):
        i = t.index("--device")
        assert fam_t == fam_j and t[i + 1] == "cpu"
        t = t[:i] + t[i + 2:]
        # the output directories are the two kits' own
        o_t, o_j = t.index("--output_model_dir"), j.index("--output_model_dir")
        assert os.path.relpath(t[o_t + 1], tmp_path / "port") == \
            os.path.relpath(j[o_j + 1], tmp_path / "jax")
        assert t[:o_t] + t[o_t + 2:] == j[:o_j] + j[o_j + 2:]
    # the default device is the card
    assert tkit.build_parser().parse_args(
        ["--input_model_file", "x"]).device == "cuda"


def test_evalkit_report_is_the_jax_string():
    results = {"qm9/mu": {"val_mae": 0.03, "test_mae": 0.031},
               "md17/aspirin": {"test_force_mae": 1.0, "test_energy_mae": 0.0},
               "lep/seed12": {"val": -1.0},
               "lba/mean": {"rmse": 1.4, "rmse_std": 0.1}}
    expected = {"qm9": {"mu": {"test_mae": 0.025}},
                "md17": {"aspirin": {"test_force_mae": 0.0,
                                     "test_energy_mae": 0.5}},
                "lba": {"mean": 3}}
    for exp in (expected, None, {}):
        assert tkit.report(results, exp) == jkit.report(results, exp)
    table = tkit.report(results, expected)
    assert "+24.0%" in table and "+1.00000 (abs)" in table and "—" in table


SMALL = ["--emb_dim", "16", "--num_filters", "16", "--num_interactions", "2",
         "--num_gaussians", "8"]


def test_evalkit_cpu_smoke_and_resume(tmp_path, monkeypatch):
    """One cell per family through the port's drivers on the CPU (at small
    widths: each driver's command line gets SMALL appended), then a second
    call that runs no driver."""
    cfg = ModelConfig(emb_dim=16, schnet=SchNetConfig(
        hidden_channels=16, num_filters=16, num_interactions=2,
        num_gaussians=8))
    pth = str(tmp_path / "released.pth")
    torch.save({"model": common.make_backbone(
        cfg, torch.Generator().manual_seed(0)).state_dict()}, pth)
    calls = []
    for _, mod in _DRIVERS.values():
        def small(argv, main=mod.main):
            calls.append(argv)
            return main(list(argv) + SMALL)
        monkeypatch.setattr(mod, "main", small)
    argv = ["--input_model_file", pth, "--out_dir", str(tmp_path / "kit"),
            "--budget", "smoke", "--qm9_tasks", "mu", "--md17_tasks",
            "aspirin", "--atom3d_seeds", "42", "--device", "cpu"]
    results = tkit.main(argv)
    assert len(calls) == 4
    for key in ("qm9/mu", "md17/aspirin", "lba/seed42", "lep/seed42"):
        vals = list(results[key].values())
        assert vals and all(np.isfinite(vals)), key
    assert "lba/mean" in results and "lep/mean" in results
    with open(tmp_path / "kit" / "results.json") as f:
        assert json.load(f) == results
    assert "qm9/mu" in (tmp_path / "kit" / "report.md").read_text()
    for _, mod in _DRIVERS.values():
        monkeypatch.setattr(mod, "main", lambda argv: pytest.fail(
            "a finished cell was run again"))
    t0 = time.time()
    assert tkit.main(argv) == results
    assert time.time() - t0 < 10
