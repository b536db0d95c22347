"""Tracing and timing on the card by ``torch.profiler`` (the port's
counterpart of ``geossl_tpu/utils/profiling.py``).

* :func:`trace` records everything inside it (host operators and, on CUDA,
  the device's kernels) and writes a Chrome trace into a directory:
  ``pretrain_geossl --profile_dir`` traces its first epoch with it.
* :class:`StepTimer` times steps on the host clock, fenced by
  ``torch.cuda.synchronize`` on CUDA, with the first step (kernel builds,
  graph captures) kept apart from the steady state.
* :func:`top_device_ops` runs a function once under the profiler and
  returns the device kernels with the most time; ``chip_smoke.py`` prints
  its table for each backbone's training step and serving pass (the
  ``top_ops:`` lines). It needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, cuda: Optional[bool] = None) -> Iterator[str]:
    """Profile the body and write its Chrome trace to
    ``<logdir>/trace.json`` (yielded). ``cuda`` (default: whether a card is
    available) adds the device's activity."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


class StepTimer:
    """Host-clock step times; on CUDA each step ends in
    ``torch.cuda.synchronize()`` so that it counts the device's work. The
    first step (kernel builds, graph captures) is kept apart from the
    steady state."""

    def __init__(self, cuda: Optional[bool] = None):
        self.cuda = torch.cuda.is_available() if cuda is None else cuda
        self.first_step_s: Optional[float] = None
        self.steady_s: list = []

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if self.cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if self.first_step_s is None:
            self.first_step_s = dt
        else:
            self.steady_s.append(dt)

    def summary(self) -> dict:
        steady = self.steady_s
        return {
            "first_step_s": self.first_step_s,
            "steady_mean_ms": 1e3 * statistics.fmean(steady) if steady else None,
            "steady_p50_ms": 1e3 * statistics.median(steady) if steady else None,
            "steps": len(steady) + (self.first_step_s is not None),
        }


def top_device_ops(fn, top: int = 10, warmup: int = 3) -> list:
    """[(kernel, device ms, calls)] of one call of ``fn`` after ``warmup``
    calls, the ``top`` largest by device time (``None``: all). Only the
    device's own events are counted (the host operators that launch them
    would count each kernel's time a second time), and not the user
    annotations on its timeline (Adam's ``Optimizer.step`` range spans its
    kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us * 1e-3, e.count))
    return sorted(rows, key=lambda r: -r[1])[:top]
