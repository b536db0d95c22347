"""Released-checkpoint evaluation kit (counterpart of ``geossl_tpu/
evalkit.py``): one command that runs the paper's whole downstream protocol
from a pretrained checkpoint, through the port's four fine-tune drivers.

    python -m geossl_tpu_torch evalkit --input_model_file model.pth \\
        --data_root data --out_dir output/evalkit

Protocol (the reference sweep scripts' hyperparameters):

* QM9, 12 targets: lr 5e-4, CosineAnnealingLR, 1000 epochs, batch 128,
  seed 42, customized_01 split (``scripts/finetune/submit_finetune_qm9_schnet.sh:6-16``)
* MD17, 8 molecules: lr 5e-4, CosineAnnealingLR, 1000 epochs, train
  batch 5, seed 42, 1000/1000 split (``submit_finetune_md17_schnet.sh:9-19``)
* LBA: lr 1e-4, batch 64, 300 epochs, atom3d 30% split, seeds
  12/22/32/42/52 (``submit_finetune_lba_lep_schnet.sh:8-33``)
* LEP: lr 1e-4, batch 16, 300 epochs, the same seeds

Every fine-tune runs resumable (``--ckpt_every``/``--resume``) and lands in
``results.json`` cell by cell, so the sweep survives restarts: running the
command again skips the finished cells. ``--budget smoke`` cuts epochs and
corpora to a dry run on the synthetic stand-ins. ``--expected table.json``
({"qm9": {"mu": {...}}, ...}) adds the published numbers and the deltas to
the report.

The drivers run on ``--device`` (default ``cuda``); ``--platform`` is
accepted and unused, as by the drivers.
"""

from __future__ import annotations

import argparse
import json
import os

QM9_TASKS = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve",
             "u0", "u298", "h298", "g298", "cv"]
MD17_TASKS = ["aspirin", "benzene2018", "ethanol", "malonaldehyde",
              "naphthalene", "salicylic", "toluene", "uracil"]
ATOM3D_SEEDS = [12, 22, 32, 42, 52]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_model_file", required=True,
                   help="pretrained backbone: a released .pth or a JAX .ckpt "
                        "(train/common.load_input_model)")
    p.add_argument("--data_root", default="data",
                   help="root holding QM9/ MD17/ LBA/ LEP/ raw trees")
    p.add_argument("--out_dir", default="output/evalkit")
    p.add_argument("--tasks", nargs="+",
                   default=["qm9", "md17", "lba", "lep"],
                   choices=["qm9", "md17", "lba", "lep"])
    p.add_argument("--model_3d", default="schnet",
                   choices=["schnet", "painn"])
    p.add_argument("--budget", default="paper", choices=["paper", "smoke"],
                   help="paper: published epochs/corpora; smoke: 2-epoch "
                        "synthetic dry-run (no raw files needed)")
    p.add_argument("--expected", default=None,
                   help="JSON of published numbers to diff against")
    p.add_argument("--device", default="cuda",
                   help="the drivers' device: cuda (default) or cpu")
    p.add_argument("--platform", default=None,
                   help="accepted for the JAX command line; unused")
    p.add_argument("--qm9_tasks", nargs="+", default=QM9_TASKS)
    p.add_argument("--md17_tasks", nargs="+", default=MD17_TASKS)
    p.add_argument("--atom3d_seeds", type=int, nargs="+",
                   default=ATOM3D_SEEDS)
    return p


def _common(args, smoke):
    c = ["--model_3d", args.model_3d, "--num_devices", "1",
         "--input_model_file", args.input_model_file,
         "--ckpt_every", "5", "--resume"]
    if smoke:
        c += ["--synthetic"]
    else:
        c += ["--data_root", args.data_root]
    return c + ["--device", args.device]


def _run(module, argv):
    """The driver's (best val metric, test metrics at the best epoch): the
    port's drivers return (net, best_val, test, losses)."""
    out = module.main(argv)
    if out is None:
        raise RuntimeError(f"{module.__name__} returned no result (a "
                           "launcher that started ranks); evalkit runs one "
                           "process")
    return out[1], out[2]


def run_qm9(args, results, save):
    from geossl_tpu_torch.train import finetune_qm9

    smoke = args.budget == "smoke"
    for task in args.qm9_tasks:
        key = f"qm9/{task}"
        if key in results:
            continue
        out = os.path.join(args.out_dir, "qm9", task)
        argv = _common(args, smoke) + [
            "--task", task, "--seed", "42", "--lr", "5e-4",
            "--lr_scheduler", "CosineAnnealingLR", "--batch_size", "128",
            "--output_model_dir", out,  # split: customized_01 (driver's own)
            "--epochs", "2" if smoke else "1000",
        ] + (["--synthetic_size", "96"] if smoke else [])
        best_val, test_at_best = _run(finetune_qm9, argv)
        results[key] = {"val_mae": float(best_val),
                        "test_mae": float(test_at_best)}
        save(results)


def run_md17(args, results, save):
    from geossl_tpu_torch.train import finetune_md17

    smoke = args.budget == "smoke"
    for task in args.md17_tasks:
        key = f"md17/{task}"
        if key in results:
            continue
        out = os.path.join(args.out_dir, "md17", task)
        argv = _common(args, smoke) + [
            "--task", task, "--seed", "42", "--lr", "5e-4",
            "--lr_scheduler", "CosineAnnealingLR",
            "--MD17_train_batch_size", "5", "--output_model_dir", out,
            "--epochs", "2" if smoke else "1000",
        ] + (["--synthetic_size", "24"] if smoke else [])
        best_val_f, (test_e, test_f) = _run(finetune_md17, argv)
        results[key] = {"val_force_mae": float(best_val_f),
                        "test_energy_mae": float(test_e),
                        "test_force_mae": float(test_f)}
        save(results)


def _run_atom3d(args, results, save, dataset):
    import numpy as np

    if dataset == "lba":
        from geossl_tpu_torch.train import finetune_lba as mod

        batch, extra = 64, ["--split", "atom3d_lba_split30"]
    else:
        from geossl_tpu_torch.train import finetune_lep as mod

        batch, extra = 16, []
    smoke = args.budget == "smoke"
    per_seed = {}
    for seed in args.atom3d_seeds:
        key = f"{dataset}/seed{seed}"
        if key not in results:
            out = os.path.join(args.out_dir, dataset, str(seed))
            argv = _common(args, smoke) + extra + [
                "--seed", str(seed), "--lr", "1e-4",
                "--lr_scheduler", "CosineAnnealingLR",
                "--batch_size", str(batch), "--output_model_dir", out,
                "--epochs", "2" if smoke else "300",
            ] + (["--synthetic_size", "24", "--bucket", "64"] if smoke
                 else [])
            best_val, best_test = _run(mod, argv)
            if dataset == "lep":
                # the JAX LEP driver starts its best val ROC at -1.0 where
                # the port's starts at -inf: a run whose val ROC is never
                # defined (one class in val) reports -1.0 in both
                best_val = max(best_val, -1.0)
            results[key] = {"val": float(best_val),
                            **{k: float(v) for k, v in best_test.items()}}
            save(results)
        per_seed[seed] = results[key]
    # the published protocol reports the mean over the seeds
    agg_key = f"{dataset}/mean"
    metrics = [k for k in next(iter(per_seed.values())) if k != "val"]
    results[agg_key] = {
        m: float(np.mean([per_seed[s][m] for s in per_seed]))
        for m in metrics
    }
    results[agg_key].update({
        f"{m}_std": float(np.std([per_seed[s][m] for s in per_seed]))
        for m in metrics
    })
    save(results)


def report(results, expected):
    """Markdown table of every cell, with the deltas to the published
    numbers where an expected table was given."""
    lines = ["| task | metric | value | published | delta |",
             "|---|---|---|---|---|"]
    for key in sorted(results):
        group, name = key.split("/", 1)
        exp_group = expected.get(group, {}) if expected else {}
        for metric, val in results[key].items():
            exp = exp_group.get(name, {}).get(metric) if isinstance(
                exp_group.get(name), dict) else None
            # None: no published number; 0: a relative delta is undefined,
            # so the absolute one is printed
            delta = ("—" if exp is None
                     else f"{val - exp:+.5f} (abs)" if exp == 0
                     else f"{100 * (val - exp) / abs(exp):+.1f}%")
            lines.append(f"| {key} | {metric} | {val:.5f} | "
                         f"{exp if exp is not None else '—'} | {delta} |")
    return "\n".join(lines)


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    results_path = os.path.join(args.out_dir, "results.json")
    results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)

    def save(r):
        with open(results_path, "w") as f:
            json.dump(r, f, indent=1)

    if "qm9" in args.tasks:
        run_qm9(args, results, save)
    if "md17" in args.tasks:
        run_md17(args, results, save)
    if "lba" in args.tasks:
        _run_atom3d(args, results, save, "lba")
    if "lep" in args.tasks:
        _run_atom3d(args, results, save, "lep")

    expected = None
    if args.expected:
        with open(args.expected) as f:
            expected = json.load(f)
    table = report(results, expected)
    print(table)
    with open(os.path.join(args.out_dir, "report.md"), "w") as f:
        f.write(table + "\n")
    print(f"\nwrote {results_path} and report.md", flush=True)
    return results


if __name__ == "__main__":
    main()
