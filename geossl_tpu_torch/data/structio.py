"""Dependency-free structural-biology file parsers (PDB / SDF / PDBBind
index): the port's own copy of ``geossl_tpu/data/structio.py``, the same
parsers with the same output.

The reference reads protein structures through Bio.PDB + atom3d
(``Geom3D/datasets/datasets_LBA.py:173-242``, ``PDBBind_utils.py:16-49``)
and ligands through RDKit's ``SDMolSupplier`` with ``sanitize=False,
removeHs=False`` (``datasets_LBA.py:188``). The downstream pipeline only
needs element symbols, coordinates and residue identity, so these are small
fixed-width/record parsers over plain Python and NumPy. ``parse_sdf_mol``
reads one V2000 molecule with its bonds (QM9's ``gdb9.sdf`` through
``data/featurize.sdf_block_to_arrays``), ``iter_sdf_blocks`` streams a
multi-molecule file.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

# Element symbol -> atomic number (H..Rn). Enough for every organic /
# biomolecular dataset here; unknown symbols map to the vocab's mask token
# downstream (featurize.atomic_number_to_index).
_SYMBOLS = (
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co "
    "Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb "
    "Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re "
    "Os Ir Pt Au Hg Tl Pb Bi Po At Rn"
).split()
SYMBOL_TO_Z = {s: i + 1 for i, s in enumerate(_SYMBOLS)}


@dataclass
class PDBStructure:
    """Flat per-atom view of a PDB file (ATOM + HETATM records)."""

    elements: List[str]  # element symbols, e.g. "C", "Zn"
    coords: np.ndarray  # [N, 3] float32, Å
    res_names: List[str]  # 3-letter residue names ("HOH" for water)
    chain_ids: List[str]
    res_seqs: np.ndarray  # [N] int32 residue sequence numbers
    icodes: List[str]  # insertion codes ("" if none)

    def __len__(self) -> int:
        return len(self.elements)

    def residue_keys(self) -> List[Tuple[str, int, str, str]]:
        """Per-atom hashable residue identity (chain, resseq, icode, resname)
        — the equality Bio.PDB uses when collecting ``res.get_parent()``
        objects into a set (``PDBBind_utils.py:42-48``)."""
        return [
            (c, int(s), i, r)
            for c, s, i, r in zip(
                self.chain_ids, self.res_seqs, self.icodes, self.res_names
            )
        ]


def _element_from_atom_name(name: str) -> str:
    """Fallback element inference from the atom-name columns (13-16) when
    columns 77-78 are blank: strip digits/primes; two-letter elements keep
    their PDB-style leading position (e.g. ``FE1`` -> Fe handled via title
    casing of the alpha prefix)."""
    alpha = "".join(ch for ch in name if ch.isalpha())
    if not alpha:
        return ""
    # Standard PDB convention: a name starting in column 13 means EITHER a
    # two-character element symbol OR a four-character hydrogen name
    # (``HG11``, ``HE21``, ``1HB `` …) — long hydrogens start at column 13
    # too. Disambiguate before the two-char-element lookup: an H-prefixed
    # name containing digits is a hydrogen, not Hg/He/Ho (a real metal like
    # mercury appears as ``HG  `` with no digits).
    if name[:1] != " ":
        if alpha[:1].upper() == "H" and any(ch.isdigit() for ch in name):
            return "H"
        if len(alpha) >= 2 and alpha[:2].capitalize() in _KNOWN_TWO:
            return alpha[:2].capitalize()
    return alpha[0].upper()


_KNOWN_TWO = {
    "He", "Li", "Be", "Ne", "Na", "Mg", "Al", "Si", "Cl", "Ar", "Ca", "Sc",
    "Ti", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se",
    "Br", "Kr", "Rb", "Sr", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag",
    "Cd", "In", "Sn", "Sb", "Te", "Xe", "Cs", "Ba", "Hg", "Pb", "Bi",
}


def parse_pdb(text: str) -> PDBStructure:
    """Parse ATOM/HETATM records of a PDB file (fixed-width columns per the
    wwPDB format spec). Altloc handling matches Bio.PDB's default: keep the
    blank altloc or the first seen altloc per (residue, atom name). Stops at
    the first ENDMDL so NMR multi-model files contribute one model, like
    Bio.PDB's ``structure.get_atoms()`` order over model 0 usage in
    ``PDBBind_utils.py:29``."""
    elements: List[str] = []
    res_names: List[str] = []
    chain_ids: List[str] = []
    icodes: List[str] = []
    res_seqs: List[int] = []
    coords: List[Tuple[float, float, float]] = []
    seen_altloc: Dict[Tuple[str, int, str, str], str] = {}

    for line in text.splitlines():
        rec = line[:6]
        if rec == "ENDMDL":
            break
        if rec not in ("ATOM  ", "HETATM"):
            continue
        line = line.ljust(80)
        atom_name = line[12:16]
        altloc = line[16]
        res_name = line[17:20].strip()
        chain_id = line[21]
        try:
            res_seq = int(line[22:26])
        except ValueError:
            continue
        icode = line[26].strip()
        key = (chain_id, res_seq, icode, atom_name.strip())
        # Keep the FIRST record per (residue, atom name) across ALL altlocs:
        # real files mix a blank-altloc primary with lettered alternates of
        # the same physical atom, and tracking only lettered altlocs would
        # keep both (duplicating the atom).
        if key in seen_altloc:
            continue
        try:
            x, y, z = float(line[30:38]), float(line[38:46]), float(line[46:54])
        except ValueError:
            # do NOT mark the key seen: a malformed primary record must not
            # shadow a later well-formed altloc of the same physical atom
            continue
        seen_altloc[key] = altloc
        element = line[76:78].strip()
        if element:
            element = element.capitalize()
        else:
            element = _element_from_atom_name(atom_name)
        elements.append(element)
        coords.append((x, y, z))
        res_names.append(res_name)
        chain_ids.append(chain_id)
        res_seqs.append(res_seq)
        icodes.append(icode)

    return PDBStructure(
        elements=elements,
        coords=np.asarray(coords, np.float32).reshape(-1, 3),
        res_names=res_names,
        chain_ids=chain_ids,
        res_seqs=np.asarray(res_seqs, np.int32),
        icodes=icodes,
    )


def parse_sdf(text: str) -> Tuple[List[str], np.ndarray]:
    """First molecule of an SDF/MOL file -> (elements, coords [N,3]).

    Covers V2000 (fixed-width counts + atom block) and V3000 (``M  V30``
    atom records) — the PDBBind ligand files the reference feeds to
    ``Chem.SDMolSupplier(..., sanitize=False, removeHs=False)``
    (``datasets_LBA.py:188``); with sanitization off, RDKit too only
    contributes symbols + conformer coordinates downstream.
    """
    lines = text.splitlines()
    if len(lines) < 4:
        raise ValueError("SDF too short")
    counts = lines[3].ljust(39)
    if "V3000" in counts:
        return _parse_sdf_v3000(lines)
    try:
        n_atoms = int(counts[0:3])
    except ValueError as e:
        raise ValueError(f"bad SDF counts line: {lines[3]!r}") from e
    elements: List[str] = []
    coords = np.zeros((n_atoms, 3), np.float32)
    for i in range(n_atoms):
        line = lines[4 + i].ljust(69)
        coords[i] = (float(line[0:10]), float(line[10:20]), float(line[20:30]))
        elements.append(line[31:34].strip().capitalize())
    return elements, coords


def _parse_sdf_v3000(lines: List[str]) -> Tuple[List[str], np.ndarray]:
    elements: List[str] = []
    coords: List[Tuple[float, float, float]] = []
    in_atoms = False
    for line in lines:
        s = line.strip()
        if s.startswith("M  V30 BEGIN ATOM"):
            in_atoms = True
            continue
        if s.startswith("M  V30 END ATOM"):
            break
        if in_atoms and s.startswith("M  V30"):
            parts = s.split()
            # M V30 index type x y z aamap ...
            elements.append(parts[3].capitalize())
            coords.append((float(parts[4]), float(parts[5]), float(parts[6])))
    return elements, np.asarray(coords, np.float32).reshape(-1, 3)


def iter_sdf_blocks(path: str):
    """Stream molecule blocks (the text up to each ``$$$$``) from an SDF
    file without loading the whole file."""
    buf: List[str] = []
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith("$$$$"):
                yield "".join(buf)
                buf = []
            else:
                buf.append(line)
    if any(line.strip() for line in buf):
        yield "".join(buf)


def parse_sdf_mol(text: str) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """One SDF molecule -> (elements, coords [N,3], bonds [E,3] 0-based
    (i, j, order)). V2000 with bonds; a V3000 block gives its atoms and no
    bonds.

    Compared to the reference's sanitizing RDKit parse
    (``datasets_Molecule3D.py:61-75``), this reads the file as written:
    kekulized bond orders (no aromaticity perception) and no chirality
    tags. The workloads consume only atom types, positions and bond
    topology, which are the same.
    """
    lines = text.splitlines()
    if len(lines) < 4:
        raise ValueError("SDF too short")
    counts = lines[3].ljust(39)
    if "V3000" in counts:
        elements, coords = _parse_sdf_v3000(lines)
        return elements, coords, np.zeros((0, 3), np.int32)
    n_atoms = int(counts[0:3])
    n_bonds = int(counts[3:6])
    elements: List[str] = []
    coords = np.zeros((n_atoms, 3), np.float32)
    for i in range(n_atoms):
        line = lines[4 + i].ljust(69)
        coords[i] = (float(line[0:10]), float(line[10:20]), float(line[20:30]))
        elements.append(line[31:34].strip().capitalize())
    bonds = np.zeros((n_bonds, 3), np.int32)
    for e in range(n_bonds):
        line = lines[4 + n_atoms + e].ljust(12)
        i, j = int(line[0:3]) - 1, int(line[3:6]) - 1
        if not (0 <= i < n_atoms and 0 <= j < n_atoms):
            # an out-of-range endpoint would poison every consumer of the
            # topology
            raise ValueError(f"SDF bond {e} references atom {max(i, j) + 1} "
                             f"of {n_atoms}")
        bonds[e] = (i, j, int(line[6:9]))
    return elements, coords, bonds


def parse_index_refined(text: str) -> Dict[str, float]:
    """``INDEX_refined_data.{year}`` -> {pdb_id: -logKd/Ki}. Lines starting
    with ``#`` are comments; the label is whitespace field 3
    (``datasets_LBA.py:205-215``)."""
    labels: Dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        fields = line.strip().split()
        if len(fields) < 4:
            continue
        labels[fields[0]] = float(fields[3])
    return labels
