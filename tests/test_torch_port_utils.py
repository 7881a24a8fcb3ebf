"""The port's timing and profiling utilities (``pwstablenet_tpu_torch.utils``)
on the CPU: the phase timer, the Chrome trace that ``trace`` writes, and
``device_time`` refusing a call that puts nothing on a card."""

import glob
import json
import time

import pytest
import torch

from pwstablenet_tpu.utils.profiling import wall_breakdown as jax_wall_breakdown

from pwstablenet_tpu_torch.utils import device_time, scope, trace, wall_breakdown


def test_wall_breakdown_adds_up_its_phases():
    wb, ref = wall_breakdown(), jax_wall_breakdown()
    for timer in (wb, ref):
        for name in ("decode", "compute", "decode"):
            with timer.phase(name):
                time.sleep(0.01)
    got = wb.as_dict()
    assert set(got) == set(ref.as_dict()) == {"decode", "compute"}
    assert got["decode"] >= 0.02 and got["compute"] >= 0.01
    assert got["decode"] > got["compute"]
    with pytest.raises(KeyError, match="inside"):
        with wb.phase("failing"):
            raise KeyError("inside")
    assert "failing" in wb.as_dict()  # a phase that raised still counts


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
