"""One front door for the port: ``python -m geossl_tpu_torch <command> ...``
(counterpart of ``geossl_tpu/__main__.py``).

Each command delegates to its module's ``main(argv)``, so
``python -m geossl_tpu_torch pretrain ...`` and
``python -m geossl_tpu_torch.train.pretrain_geossl ...`` are the same run.

    python -m geossl_tpu_torch pretrain --GeoSSL_option DDM --synthetic
    python -m geossl_tpu_torch finetune-qm9 --task mu --input_model_file ckpt
    python -m geossl_tpu_torch seal --ckpt runs/x/model.pth --out m.sealed
    python -m geossl_tpu_torch serve --ckpt m.sealed --input mols.sdf

Run ``python -m geossl_tpu_torch <command> --help`` for its flags. The JAX
package's ``data``, ``evalkit`` and ``doctor`` are not ported yet: they
exit with code 2.
"""

from __future__ import annotations

import importlib
import sys

# command -> (module with main(argv), one-line help)
COMMANDS = {
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
    "serve": ("geossl_tpu_torch.serve",
              "batched inference on a checkpoint or a sealed artifact "
              "(predict/embed/forces/pairs)"),
    "seal": ("geossl_tpu_torch.export",
             "seal a checkpoint into a serving artifact (torch.export)"),
}
# the JAX package's commands that the port does not have yet
NOT_PORTED = {
    "data": "build dataset caches from raw files",
    "evalkit": "published downstream protocol from a pretrained checkpoint",
    "doctor": "environment health check",
}


def _usage() -> str:
    width = max(len(c) for c in (*COMMANDS, *NOT_PORTED))
    lines = ["usage: python -m geossl_tpu_torch <command> [args...]", "",
             "commands:"]
    lines += [f"  {cmd:<{width}}  {help_}"
              for cmd, (_, help_) in COMMANDS.items()]
    lines += ["", "not ported yet (run them with python -m geossl_tpu):"]
    lines += [f"  {cmd:<{width}}  {help_}" for cmd, help_ in NOT_PORTED.items()]
    lines += ["", "per-command flags: python -m geossl_tpu_torch <command> "
              "--help"]
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_usage())
        return 0
    cmd = argv[0]
    if cmd in NOT_PORTED:
        print(f"{cmd!r} is not ported to geossl_tpu_torch yet; run "
              f"python -m geossl_tpu {cmd}", file=sys.stderr)
        return 2
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    module = importlib.import_module(COMMANDS[cmd][0])
    # the drivers' mains return their results for programmatic callers; as
    # a command, finishing without raising is success
    module.main(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
