"""Device-time breakdowns on the card by ``torch.profiler`` (the port's
counterpart of ``geossl_tpu/utils/profiling.py``'s trace capture).

``top_device_ops(fn)`` runs ``fn`` once under the profiler and returns the
device kernels with the most time. ``chip_smoke.py`` prints its table for
each backbone's training step and serving pass (the ``top_ops:`` lines).
It needs a CUDA device.
"""

from __future__ import annotations

import torch


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
