"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface (no PyTorch headers, so a
build takes seconds), under ``ops/_build/``, and loaded with ``ctypes``. A
source may also build into further libraries with a macro set (the NCSN
head's E = 256 instance, ``ncsn_score_e256``). The library's file name
carries a hash of the sources and flags, so an edited kernel is rebuilt.
All libraries build at once, one ``nvcc`` each, on first use; nothing is
built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
# library -> (its csrc/ source, the nvcc flags it adds)
SOURCES = {name: (name, ()) for name in (
    "cfconv_fwd", "cfconv_bwd", "cfconv_bwd_bf16w", "ncsn_score",
    "ncsn_score_wide", "schnet_stack", "painn_fwd", "painn_bwd",
    "painn_stack")}
SOURCES["ncsn_score_e256"] = ("ncsn_score", ("-DNCSN_E=256",))
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from geossl_tpu_torch/ops/csrc with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256((" ".join(FLAGS) + repr(sorted(SOURCES.items())))
                       .encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_digest()}.so")


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.
    Returns ``{name: compiler output}`` (ptxas's register and spill report)
    for what was built; raises if any compile failed."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name, (src, extra) in SOURCES.items():
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *FLAGS, *extra, "-o", tmp, os.path.join(CSRC, src + ".cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            with open(out + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def build_log(name: str) -> str:
    """The compiler output kept beside library ``name`` when it was built
    (ptxas's register and spill report); empty if none was kept."""
    path = lib_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def kernel_fn(lib: str, fn: str, argtypes, restype=ctypes.c_int):
    """The C entry ``fn`` of library ``lib`` (built on first use), with its
    argument and result types declared."""
    with _lock:
        if lib not in _libs:
            path = lib_path(lib)
            if not os.path.exists(path):
                build_all()
            _libs[lib] = ctypes.CDLL(path)
    f = getattr(_libs[lib], fn)
    f.argtypes = list(argtypes)
    f.restype = restype
    return f
