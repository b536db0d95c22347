"""Dataset caches from raw files (counterpart of ``geossl_tpu/data/
__main__.py``; reference: examples/generate_Molecule3D.py and the
DatasetLBA/DatasetLEP process() paths). Each writes the same cache files as
the JAX package.

    python -m geossl_tpu_torch.data molecule3d --root data/Molecule3D [--subset 1000000]
    python -m geossl_tpu_torch.data qm9        --root data/QM9
    python -m geossl_tpu_torch.data md17       --root data/MD17 --task aspirin
    python -m geossl_tpu_torch.data lba        --root data/LBA --year 2020
    python -m geossl_tpu_torch.data lep        --root data/LEP --lep_split train
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset", choices=["molecule3d", "qm9", "md17", "lba", "lep"])
    p.add_argument("--root", required=True)
    p.add_argument("--subset", type=int, default=None)
    p.add_argument("--task", default="aspirin")
    p.add_argument("--year", type=int, default=2020, help="LBA PDBBind year")
    p.add_argument("--dist", type=float, default=6.0)
    p.add_argument("--maxnum", type=int, default=None,
                   help="env-selection atom cap (LBA default 500, LEP 400)")
    p.add_argument("--lep_split", default="all",
                   choices=["all", "train", "val", "test"])
    p.add_argument("--lep_droph", action="store_true")
    p.add_argument("--smiles_drop_file", default=None,
                   help="qm9 no-RDKit builds: file of 0-based raw-row "
                        "indices to drop in lieu of the RDKit invalid-"
                        "SMILES filter (build_qm9 docstring)")
    args = p.parse_args(argv)
    if args.dataset == "molecule3d":
        from geossl_tpu_torch.data.molecule3d import load_molecule3d

        store = load_molecule3d(args.root, subset=args.subset)
    elif args.dataset == "qm9":
        from geossl_tpu_torch.data.qm9 import load_qm9

        store = load_qm9(args.root, smiles_drop_file=args.smiles_drop_file)
    elif args.dataset == "md17":
        from geossl_tpu_torch.data.md17 import load_md17

        store = load_md17(args.root, args.task)
    elif args.dataset == "lba":
        from geossl_tpu_torch.data.lba import build_lba

        store = build_lba(args.root, year=args.year, dist=args.dist,
                          maxnum=args.maxnum or 500)
    else:
        from geossl_tpu_torch.data.lep import build_lep

        splits = (["train", "val", "test"] if args.lep_split == "all"
                  else [args.lep_split])
        for s in splits:
            a, _, labels = build_lep(args.root, s, dist=args.dist,
                                     maxnum=args.maxnum or 400,
                                     droph=args.lep_droph)
            print(f"lep/{s}: {len(a)} pairs cached "
                  f"({int(labels.sum())} active)")
        return
    print(f"{args.dataset}: {len(store)} molecules cached")


if __name__ == "__main__":
    main()
