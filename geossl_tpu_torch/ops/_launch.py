"""What every kernel wrapper of ``ops/`` shares: the device check that picks
kernel or plain version, the ctypes argument helpers, the launch-error and
shared-memory checks, and the launch counters.

Each wrapper is registered with :func:`counted`, which gives it a
``launches`` attribute; the wrapper adds one where it launches its kernel,
and nowhere else. :func:`launch_counts` reads every registered wrapper.

Every kernel launch is also a ``torch.library`` custom op in the
``geossl_torch`` namespace (:data:`OPS`), so that ``torch.export`` can
capture it (``export.py``'s sealed programs). Each op's CUDA
implementation is the launch code, its CPU implementation the wrapper's
plain version, and its fake implementation gives the output shapes. Eager
calls run the launch code directly and go through the op only while
exporting (:func:`launch`): on the H100's host the op's dispatch adds
about 37 us to a launch, above the 5 us a launch may add
(``chip_smoke.py``'s ``custom_op_overhead:`` line, PERF.md). Both routes
run the same kernel.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import torch

# Dynamic shared memory a block may use on Hopper.
MAX_SMEM = 232448

_WRAPPERS: dict = {}
# the namespace of the kernels' custom ops
NAMESPACE = "geossl_torch"
# op name -> the custom op
OPS: dict = {}


def counted(name: str):
    """Register a kernel wrapper under ``name`` with a launch counter."""
    def register(fn):
        fn.launches = 0
        _WRAPPERS[name] = fn
        return fn
    return register


def instance_counter(name: str):
    """A launch counter of its own, registered under ``name`` beside the
    wrappers', for a kernel instance that a wrapper launches in place of
    its default one (the CFConv kernels' bf16 instances): the wrapper adds
    one to it, not to its own count, where it launches that instance."""
    counter = SimpleNamespace(launches=0)
    _WRAPPERS[name] = counter
    return counter


def kernel_op(name: str, fake, plain):
    """Register the launch function it decorates as custom op
    ``geossl_torch::<name>`` on CUDA, with ``plain`` (the same signature;
    its outputs made contiguous, as the kernel's are) as its CPU
    implementation and ``fake`` as its fake one. The decorated
    function is left as it is (eager calls run it directly); the op is
    ``OPS[name]`` and ``fn.op``. The signature's annotations give the op's
    schema; the op mutates none of its inputs."""
    def register(fn):
        op = torch.library.custom_op(f"{NAMESPACE}::{name}", fn,
                                     mutates_args=(), device_types="cuda")
        op.register_kernel("cpu")(lambda *args: _contiguous(plain(*args)))
        op.register_fake(fake)
        OPS[name] = fn.op = op
        return fn
    return register


def fresh_thread(fn, *args):
    """``fn(*args)`` on a thread of its own. An op's kernel runs below
    autograd (its dispatch keys are excluded on the calling thread), so the
    plain backwards, which are autograd over the plain forward, run in a
    thread with the default dispatch state."""
    with ThreadPoolExecutor(1) as pool:
        return pool.submit(fn, *args).result()


def flat(tensors):
    """The tensors flattened into one (a backward op's weight gradients:
    an op's outputs may not be views of one buffer)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _contiguous(out):
    """The plain version's outputs in the kernels' contiguous layout."""
    if isinstance(out, (tuple, list)):
        return tuple(t.contiguous() for t in out)
    return out.contiguous()


def launch(fn, *args):
    """Launch kernel function ``fn`` (registered by :func:`kernel_op`):
    through its custom op while ``torch.export`` traces, else directly."""
    if torch.compiler.is_exporting():
        return fn.op(*args)
    return fn(*args)


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


def refuse_second_order(name: str) -> None:
    """Raise ``NotImplementedError`` in the backward of a first-order
    autograd Function when autograd asks it to build a graph (a double
    backward)."""
    if torch.is_grad_enabled():
        raise NotImplementedError(
            f"{name} is first order only: it has no double backward (nor "
            "has its counterpart in the JAX package)")


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
