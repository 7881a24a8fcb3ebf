"""Tracing and profiling hooks.

- ``trace(log_dir)``: a context manager over ``torch.profiler.profile``
  (CPU activity, and CUDA activity where there is a card) that writes a
  Chrome trace JSON into ``log_dir`` when the block ends (TensorBoard's
  profiler plugin and Perfetto read it); it yields the profiler, whose
  ``key_averages()`` stay readable after the block.
- ``scope(name)``: ``torch.profiler.record_function``, a named range in
  the trace.
- ``wall_breakdown``: host wall-clock time summed per phase.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, Iterator

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

scope = torch.profiler.record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # acc_events: key_averages() after the block covers all of it
    with profile(activities=activities, acc_events=True,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class wall_breakdown:
    """Accumulate wall-clock per phase: ``with wb.phase("decode"): ...``"""

    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)
