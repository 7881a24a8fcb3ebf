"""Device time of a call, from a ``torch.profiler`` trace.

A host clock around a CUDA call measures the enqueue unless it waits
for the card, and then it also counts the host's gaps between launches.
``device_time`` traces ``iters`` calls with CUDA activity and sums the
device-side events (kernels, memory copies and sets), so it reads the
card's busy time per call.

One difference from the JAX package's ``device_time``: that one takes
the largest per-module total of the TPU's "XLA Modules" track (the one
jitted program); this one sums every device event, since an eager
PyTorch call is many kernels.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch


def device_rows(prof) -> List[Tuple[str, float, int]]:
    """``(name, device ms, count)`` of each device-side event kind of a
    finished ``torch.profiler.profile``, largest first.  User
    annotations on the device timeline are left out: they cover kernels
    that are counted already."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if ev.self_device_time_total <= 0 or getattr(ev, "is_user_annotation", False):
            continue
        rows.append((ev.key, ev.self_device_time_total / 1e3, ev.count))
    return sorted(rows, key=lambda r: -r[1])


def device_time(
    fn: Callable,
    args: Sequence,
    iters: int = 10,
    warmup: int = 2,
) -> float:
    """Seconds of device time per call of ``fn(*args)``.

    Runs ``warmup`` calls and waits for the card, then traces ``iters``
    calls and divides the device-side time by ``iters``.  A trace that
    holds no device event is taken once more (on an H100, one trace of
    10 launches of a 16 us kernel once came back without them, where
    other runs of the same calls held all 10); if the second holds none
    either (a function that runs on the CPU, or no card), it raises
    ``RuntimeError``: there is no fallback to host time."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    for _ in range(warmup):
        fn(*args)
    for _ in range(2):
        if cuda:
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*args)
            if cuda:
                torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows:
            return sum(ms for _, ms, _ in rows) / 1e3 / iters
    raise RuntimeError("no device events captured")
