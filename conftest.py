"""Builds the JAX package's C++ host runtime once, before any test module
is imported.

``geossl_tpu/native/packing.py`` compiles ``libgeossl_native.so`` straight
onto the path it loads, whenever the file is missing or older than its
source, and caches a failed load for the life of the process. Under
``pytest -n 6`` every worker on a tree without the library compiles it at
once: a worker that has finished its own link can ``dlopen`` the file while
another worker's linker has truncated it ("file too short"), and from then on
that worker sees no native runtime: ``tests/test_native.py`` is skipped there
(its ``skipif`` runs at import) and the parity tests of
``tests/test_torch_port_native.py`` fail.

This file is loaded by pytest's main process before it starts any worker,
and by each worker before it collects a test. It builds the library with
``packing.py``'s own command into a temporary file and moves it onto the
library's path in one ``os.replace``, under a file lock, so the JAX package's
loader always finds a whole, fresh library and builds nothing itself. It
imports nothing of either package.
"""

import fcntl
import os
import subprocess
import tempfile

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "geossl_tpu", "native")
_SRC = os.path.join(_NATIVE, "geossl_native.cpp")
_SO = os.path.join(_NATIVE, "libgeossl_native.so")


def _fresh() -> bool:
    # geossl_tpu/native/packing.py's own test for a rebuild.
    return os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)


def _build_jax_native_library() -> None:
    if not os.path.exists(_SRC) or _fresh():
        return
    lock = os.path.join(tempfile.gettempdir(), "geossl_native_build.lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        if _fresh():
            return
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=600)
            os.replace(tmp, _SO)
        except (OSError, subprocess.SubprocessError):
            # No toolchain: the JAX package falls back as it would alone.
            if os.path.exists(tmp):
                os.remove(tmp)


_build_jax_native_library()
