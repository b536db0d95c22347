"""One front door for the port: ``python -m geossl_tpu_torch <command> ...``
(counterpart of ``geossl_tpu/__main__.py``, with the same commands).

Each command delegates to its module's ``main(argv)``, so
``python -m geossl_tpu_torch pretrain ...`` and
``python -m geossl_tpu_torch.train.pretrain_geossl ...`` are the same run.

    python -m geossl_tpu_torch data molecule3d --root data/Molecule3D
    python -m geossl_tpu_torch pretrain --GeoSSL_option DDM --synthetic
    python -m geossl_tpu_torch finetune-qm9 --task mu --input_model_file ckpt
    python -m geossl_tpu_torch seal --ckpt runs/x/model.pth --out m.sealed
    python -m geossl_tpu_torch serve --ckpt m.sealed --input mols.sdf
    python -m geossl_tpu_torch doctor --json

Run ``python -m geossl_tpu_torch <command> --help`` for its flags.
"""

from __future__ import annotations

import importlib
import sys

# command -> (module with main(argv), one-line help)
COMMANDS = {
    "data": ("geossl_tpu_torch.data.__main__",
             "build dataset caches from raw files (molecule3d/qm9/md17/lba/lep)"),
    "pretrain": ("geossl_tpu_torch.train.pretrain_geossl",
                 "GeoSSL pretraining (DDM / InfoNCE / EBM-NCE / RR)"),
    "pretrain-baseline": (
        "geossl_tpu_torch.train.pretrain_baselines",
        "baseline SSL pretraining (supervised/charge/distance/torsion/"
        "infograph/contextpred)"),
    "finetune-qm9": ("geossl_tpu_torch.train.finetune_qm9",
                     "QM9 property regression fine-tune (12 targets)"),
    "finetune-md17": ("geossl_tpu_torch.train.finetune_md17",
                      "MD17 energy+force fine-tune (-dE/dpos)"),
    "finetune-lba": ("geossl_tpu_torch.train.finetune_lba",
                     "Atom3D LBA binding-affinity fine-tune"),
    "finetune-lep": ("geossl_tpu_torch.train.finetune_lep",
                     "Atom3D LEP ligand-efficacy fine-tune (dual tower)"),
    "evalkit": ("geossl_tpu_torch.evalkit",
                "published downstream protocol from a pretrained checkpoint "
                "(QM9 12 targets + MD17 8 molecules + LBA/LEP, resumable)"),
    "serve": ("geossl_tpu_torch.serve",
              "batched inference on a checkpoint or a sealed artifact "
              "(predict/embed/forces/pairs)"),
    "seal": ("geossl_tpu_torch.export",
             "seal a checkpoint into a serving artifact (torch.export)"),
    "doctor": ("geossl_tpu_torch.doctor",
               "environment health check (backend/build/dispatch/native/"
               "kernels)"),
}


def _usage() -> str:
    width = max(len(c) for c in COMMANDS)
    lines = ["usage: python -m geossl_tpu_torch <command> [args...]", "",
             "commands:"]
    lines += [f"  {cmd:<{width}}  {help_}"
              for cmd, (_, help_) in COMMANDS.items()]
    lines += ["", "per-command flags: python -m geossl_tpu_torch <command> "
              "--help"]
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_usage())
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    module = importlib.import_module(COMMANDS[cmd][0])
    # the drivers' mains return their results for programmatic callers; as
    # a command, finishing without raising is success. An int is an exit
    # code (the doctor's): pass it on.
    rc = module.main(argv[1:])
    return rc if isinstance(rc, int) else 0


if __name__ == "__main__":
    sys.exit(main())
