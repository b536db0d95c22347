"""What every kernel wrapper of ``ops/`` shares: the device check that picks
kernel or plain version, the ctypes argument helpers, the launch-error and
shared-memory checks, and the launch counters.

Each wrapper is registered with :func:`counted`, which gives it a
``launches`` attribute; the wrapper adds one where it launches its kernel,
and nowhere else. :func:`launch_counts` reads every registered wrapper.
"""

from __future__ import annotations

import ctypes

import torch

# Dynamic shared memory a block may use on Hopper.
MAX_SMEM = 232448

_WRAPPERS: dict = {}


def counted(name: str):
    """Register a kernel wrapper under ``name`` with a launch counter."""
    def register(fn):
        fn.launches = 0
        _WRAPPERS[name] = fn
        return fn
    return register


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def on_cpu(name: str, *tensors) -> bool:
    """True for CPU tensors (plain version); False after checking that the
    tensors are f32, contiguous and on one CUDA device (kernel)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous float32 "
                             f"tensors (got {t.dtype}, contiguous="
                             f"{t.is_contiguous()})")
    return False


def refuse_grad(name: str, missing: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when autograd would need a gradient
    through kernel ``name``, which has no backward: its output would
    otherwise be silently detached from the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} has no gradient: {missing}")


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_launch(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def check_smem(name, nbytes):
    if nbytes > MAX_SMEM:
        raise ValueError(f"{name}: needs {nbytes} bytes of shared memory, "
                         f"above the {MAX_SMEM} a block may use")
