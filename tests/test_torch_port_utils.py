"""The port's timing and profiling utilities (``pwstablenet_tpu_torch.utils``)
on the CPU: the phase timer, the Chrome trace that ``trace`` writes, and
``device_time`` refusing a call that puts nothing on a card."""

import glob
import json

import pytest
import torch

from pwstablenet_tpu.utils.profiling import wall_breakdown as jax_wall_breakdown

from pwstablenet_tpu_torch.utils import device_time, scope, trace, wall_breakdown


def test_wall_breakdown_adds_up_its_phases(monkeypatch):
    """Both packages' phase timers, on a scripted clock: each phase's
    body advances the clock by its units, so the sums are exact and no
    host load can reorder them."""
    import types

    import pwstablenet_tpu.utils.profiling as jax_profiling

    import pwstablenet_tpu_torch.utils.profiling as port_profiling

    now = [0.0]
    clock = types.SimpleNamespace(perf_counter=lambda: now[0])
    for module in (port_profiling, jax_profiling):
        monkeypatch.setattr(module, "time", clock)
    wb, ref = wall_breakdown(), jax_wall_breakdown()
    for timer in (wb, ref):
        for name, units in (("decode", 10.0), ("compute", 25.0), ("decode", 10.0)):
            with timer.phase(name):
                now[0] += units
    got = wb.as_dict()
    assert got == ref.as_dict() == {"decode": 20.0, "compute": 25.0}
    with pytest.raises(KeyError, match="inside"):
        with wb.phase("failing"):
            now[0] += 5.0
            raise KeyError("inside")
    assert wb.as_dict()["failing"] == 5.0  # a phase that raised still counts


def test_trace_writes_a_chrome_trace_with_the_scope(tmp_path):
    with trace(str(tmp_path)) as prof:
        with scope("pwst_scope_under_test"):
            x = torch.randn(64, 64)
            (x @ x).sum()
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "pwst_scope_under_test" for e in events)
    assert any(e.key == "pwst_scope_under_test" for e in prof.key_averages())


def test_device_time_of_a_cpu_call_raises():
    x = torch.randn(32, 32)
    with pytest.raises(RuntimeError, match="no device events captured"):
        device_time(lambda a: a @ a, (x,), iters=2, warmup=1)
