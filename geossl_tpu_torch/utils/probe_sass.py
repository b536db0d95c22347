"""Compare one kernel's SASS in two builds of the port: for each pair of
mangled-name prefixes, the instruction counts, the opcodes whose counts
differ and the lines of a diff of the two instruction lists, with
addresses and immediate constants (constant-bank offsets among them)
masked.

    python geossl_tpu_torch/utils/probe_sass.py TREE_A TREE_B LIB \\
        PREFIX_A PREFIX_B [PREFIX_A PREFIX_B ...]

TREE_A and TREE_B are checkouts whose ``geossl_tpu_torch/ops/_build``
holds the built library LIB (``painn_fwd``, ...); it needs
``cuobjdump`` from the CUDA toolkit (``$CUDA_HOME/bin``, by default
``/usr/local/cuda/bin``). Each prefix must name one function of its
build.
"""

from __future__ import annotations

import collections
import difflib
import glob
import os
import re
import subprocess
import sys


def functions(sass: str) -> dict:
    """{function name: its instructions} of ``cuobjdump -sass`` output,
    each instruction with its hexadecimal numbers masked as X."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if cur and m:
            funcs[cur].append(re.sub(r"0x[0-9a-f]+", "X", m.group(1)).strip())
    return funcs


def compare(a: list, b: list) -> dict:
    """Instruction counts, per-opcode count differences (b - a) and the
    changed lines of a diff of two instruction lists."""
    def opcodes(ins):
        return collections.Counter(
            i.split()[1] if i.startswith("@") else i.split()[0] for i in ins)

    ca, cb = opcodes(a), opcodes(b)
    diff = [line for line in difflib.unified_diff(a, b, lineterm="", n=0)
            if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    return {"instructions": (len(a), len(b)),
            "opcode_deltas": {k: cb[k] - ca[k] for k in sorted(set(ca) | set(cb))
                              if cb[k] != ca[k]},
            "diff": diff}


def _sass(tree: str, lib: str) -> dict:
    so = glob.glob(os.path.join(tree, "geossl_tpu_torch", "ops", "_build",
                                f"{lib}-*.so"))
    if len(so) != 1:
        raise SystemExit(f"{tree}: expected one built {lib}, found {so}")
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    return functions(subprocess.run([tool, "-sass", so[0]], capture_output=True,
                                    text=True, check=True).stdout)


def _pick(funcs: dict, prefix: str) -> list:
    names = [n for n in funcs if n.startswith(prefix)]
    if len(names) != 1:
        raise SystemExit(f"{prefix}: matches {names}")
    return funcs[names[0]]


def main(argv):
    if len(argv) < 5 or len(argv) % 2 == 0:
        sys.exit(__doc__)
    tree_a, tree_b, lib, *prefixes = argv
    fa, fb = _sass(tree_a, lib), _sass(tree_b, lib)
    for pa, pb in zip(prefixes[::2], prefixes[1::2]):
        out = compare(_pick(fa, pa), _pick(fb, pb))
        print(f"sass {pa} -> {pb}: {out['instructions'][0]} -> "
              f"{out['instructions'][1]} instructions; opcode deltas "
              f"{out['opcode_deltas']}; diff lines {len(out['diff'])}")
        for line in out["diff"][:60]:
            print("   ", line)


if __name__ == "__main__":
    main(sys.argv[1:])
