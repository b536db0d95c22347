"""Write a copy of the ``geossl_tpu_torch`` package in which every PaiNN
kernel launch (#8-#12) takes its streamed instance, whatever R: at R <= 31
one pass over a single chunk of the filter product's rows, reading the
plain version's RBF offsets, in place of the one-pass instance. Timing the
copy against the package in turns with ``probe_gaussians.py`` shows what
the one-pass instances save.

    python geossl_tpu_torch/utils/probe_streamed.py OUT
    for t in c s s c c s s c; do
      tree=.; [ $t = s ] && tree=OUT
      env PYTHONPATH=$tree python geossl_tpu_torch/utils/probe_gaussians.py \\
          --tag $t --model_3d painn --rbf 20
    done

OUT is a directory outside the package (one that ``.gitignore`` lists);
the copy builds its own kernels under ``OUT/geossl_tpu_torch/ops/_build``.
The stack's streamed instance has K = 32 rows a pass where the one-pass
instance has 24 at R <= 23, so its row compares two K as well.
"""

from __future__ import annotations

import os
import shutil
import sys

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (file under the package, text, its replacement): each text occurs once
EDITS = (
    ("ops/csrc/painn_fwd.cu",
     "  const bool streamed = R > kOnePassR;\n  if (F != kF",
     "  const bool streamed = true;\n  if (F != kF"),
    ("ops/csrc/painn_bwd.cu",
     "  if (R <= kOnePassR) {\n    err = cudaFuncSetAttribute(",
     "  if (false) {\n    err = cudaFuncSetAttribute("),
    ("ops/csrc/painn_bwd.cu", "(R > kOnePassR && !offs)", "(!offs)"),
    ("ops/csrc/painn_stack.cu",
     "  const bool streamed = R > kOnePassR;\n  if (F != kF",
     "  const bool streamed = true;\n  if (F != kF"),
    ("ops/painn.py",
     "    if num_r <= ONE_PASS_R:\n        return None\n    return jax_linspace",
     "    return jax_linspace"),
)


def write_copy(out: str) -> None:
    dest = os.path.join(out, "geossl_tpu_torch")
    if os.path.commonpath([os.path.abspath(out), PACKAGE]) == PACKAGE:
        raise ValueError(f"{out}: must lie outside the package")
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(PACKAGE, dest, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    for name, text, new in EDITS:
        path = os.path.join(dest, name)
        with open(path) as f:
            src = f.read()
        if src.count(text) != 1:
            raise RuntimeError(f"{name}: expected one {text!r}")
        with open(path, "w") as f:
            f.write(src.replace(text, new))


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    write_copy(sys.argv[1])
