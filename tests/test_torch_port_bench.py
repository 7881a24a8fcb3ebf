"""The port's benchmark suite (``pwstablenet_tpu_torch.bench``) on the CPU:
its keys against the JAX suite's (the root ``bench.py``, read as text),
the measuring function at a TINY model and frame sizes with
``device_time`` on a host clock, the flop count against the generator's
convolutions counted independently, the parity gates and their refusal,
the refusal without a card, and an import that loads no JAX; then the
wall-clock windows (``measure_windows``) at TINY and small sizes, their
summary against numpy and the busy-interval union."""

import importlib.util
import inspect
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from pwstablenet_tpu_torch import bench
from pwstablenet_tpu_torch.cli import main as cli_main
from pwstablenet_tpu_torch.config import ModelConfig
from pwstablenet_tpu_torch.kernels import grid_sample as K
from pwstablenet_tpu_torch.models.generator import CascadedGenerator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ModelConfig(temporal_window=3, num_levels=4, base_features=8, max_features=16,
                   model_resolution=(32, 32), num_stages=2, disc_num_layers=2,
                   feat_channels=(8, 16), compute_dtype="float32")
GATE_KEYS = {"f32_kernel_vs_plain_mse", "grad_kernel_vs_plain_mse",
             "f32_kernel_offlane_vs_plain_mse", "packed_kernel_max_code_diff"}
MFU_KEYS = {"mfu_720p", "mfu_generator", "train_mfu"}


def host_clock(fn, args, iters=10, warmup=2):
    """``device_time``'s signature on the host's clock: one call."""
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


@pytest.fixture(scope="module")
def tiny_run():
    """``measure`` at TINY, frames of a few dozen pixels, a 2-step loop."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "device_time", host_clock)
        return bench.measure(torch.device("cpu"), np.random.default_rng(0), TINY,
                             hd=(36, 64), sd=(24, 40), fhd=(40, 72), uhd=(48, 80),
                             loop_steps=2)


def _jax_suite_keys():
    """The ``results[...]`` keys of the root ``bench.py``, read as text,
    with ``{nlat}`` over the causal mode's (1, 4)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    keys = set()
    for is_f, key in re.findall(r'results\[(f?)"([^"]+)"\]', src):
        keys |= {key.format(nlat=n) for n in (1, 4)} if is_f else {key}
    return keys


def test_keys_map_the_jax_suite_one_to_one(tiny_run):
    _, results = tiny_run
    jax_keys = _jax_suite_keys()
    assert "causal_720p_ms_per_frame_chunk4" in jax_keys and len(jax_keys) == 26
    assert set(bench.KEYS_OF_JAX_SUITE) == jax_keys
    port_keys = list(bench.KEYS_OF_JAX_SUITE.values())
    assert len(set(port_keys)) == len(port_keys)
    assert set(port_keys) == set(results) | GATE_KEYS | MFU_KEYS
    assert not (set(results) & MFU_KEYS)  # no peak off the card


def test_tiny_run_writes_every_reading(tiny_run):
    fps, results = tiny_run
    assert fps == results["fps_720p_device"]
    assert {"gflops_per_chunk_720p", "train_gflops_per_step"} <= set(results)
    bad = {k: v for k, v in results.items() if not (math.isfinite(v) and v > 0)}
    assert not bad, bad
    assert results["train_mesh_devices"] == 1
    # a step runs forward and backward over 16 windows; a chunk forward
    # over 8: the counted step is the larger
    assert results["train_gflops_per_step"] > results["gflops_per_chunk_720p"]


def test_flop_count_is_the_generators_convolutions(monkeypatch):
    """FlopCounterMode over one TINY generator forward against a sum over
    its Conv2d and ConvTranspose2d modules: 2 * C_in/groups * C_out * k_h
    * k_w a position, over the output positions (the input positions for
    a transposed conv).  The port's blocks call ``F.conv2d`` on each
    module's weight rather than the module, so the positions are taken
    from those calls."""
    g = CascadedGenerator(TINY, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 32, 32, TINY.stack_channels, generator=torch.Generator().manual_seed(1))
    convs = [m for m in g.modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    calls = []
    conv, deconv = F.conv2d, F.conv_transpose2d

    def counting_conv(inp, w, *a, **k):
        out = conv(inp, w, *a, **k)
        c_out, c_in_g, kh, kw = w.shape
        calls.append((False, tuple(w.shape), 2 * c_in_g * c_out * kh * kw * out[0, 0].numel()
                      * out.shape[0]))
        return out

    def counting_deconv(inp, w, *a, **k):
        out = deconv(inp, w, *a, **k)
        c_in, c_out_g, kh, kw = w.shape
        calls.append((True, tuple(w.shape), 2 * c_in * c_out_g * kh * kw * inp[0, 0].numel()
                      * inp.shape[0]))
        return out

    with torch.no_grad():
        counted = bench._counted_flops(g, x)
        monkeypatch.setattr(F, "conv2d", counting_conv)
        monkeypatch.setattr(F, "conv_transpose2d", counting_deconv)
        g(x)
    # one call a module, each with that module's weight
    assert sorted((t, s) for t, s, _ in calls) == sorted(
        (isinstance(m, nn.ConvTranspose2d), tuple(m.weight.shape)) for m in convs)
    assert counted == sum(f for _, _, f in calls) > 0


@pytest.mark.parametrize("frames, h, w, backward", [
    (8, 720, 1280, False), (16, 256, 256, True), (1, 64, 208, False),
])
def test_warp_flops_are_the_jax_suites(frames, h, w, backward):
    spec = importlib.util.spec_from_file_location("jax_bench_suite", os.path.join(REPO, "bench.py"))
    jax_suite = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_suite)
    assert bench._warp_flops(frames, h, w, backward=backward) == jax_suite._warp_flops(
        frames, h, w, backward=backward)


def test_peak_is_read_from_the_cards_name(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert bench._peak_flops(torch.device("cuda")) == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Some Other Card")
    assert bench._peak_flops(torch.device("cuda")) is None
    assert "no bf16 peak known for 'Some Other Card'" in capsys.readouterr().err
    assert bench._peak_flops(torch.device("cpu")) is None


def test_parity_gates_hold_where_kernel_and_plain_agree():
    """On the CPU each wrapper runs its plain version: every gate reads 0."""
    results = {}
    assert bench.parity_gates(torch.device("cpu"), np.random.default_rng(0), results)
    assert results == dict.fromkeys(GATE_KEYS, 0.0) | {"packed_kernel_max_code_diff": 0}


def _off_by(name, delta):
    real = getattr(K, name)
    return lambda *a, **k: real(*a, **k) + delta


# the d/dgrid wrapper runs its plain version by name on the CPU, so its
# case moves the wrapper's result instead
@pytest.mark.parametrize("name, delta", [
    ("grid_sample_f32_plain", 0.1), ("grid_sample_grad_f32", 0.1),
    ("grid_sample_packed_u8_plain", 2),
], ids=["f32", "grad", "packed"])
def test_a_failed_gate_prints_the_error_headline(monkeypatch, capsys, name, delta):
    monkeypatch.setattr(bench, "_card", lambda: torch.device("cpu"))
    monkeypatch.setattr(K, name, _off_by(name, delta))

    def unreached(*a, **k):
        raise AssertionError("measured after a failed gate")

    monkeypatch.setattr(bench, "measure", unreached)
    assert bench.main() == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in out] == [{
        "metric": "720p stabilized frames/sec/chip", "value": 0.0,
        "unit": "frames/sec/chip", "vs_baseline": 0.0, "error": "kernel parity failure",
    }]


def test_the_headline_is_the_only_stdout_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_card", lambda: torch.device("cpu"))
    readings = {"fps_720p_device": 412.34567, "train_mesh_devices": 1}
    monkeypatch.setattr(bench, "measure", lambda device, rng: (412.34567, dict(readings)))
    windows = {"live_720p_chunk1_ms": 14.123456, "live_720p_chunk1_ms_n": 200}
    monkeypatch.setattr(bench, "measure_windows", lambda device, rng: dict(windows))
    assert bench.main() == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line == {
        "metric": "720p stabilized frames/sec/chip", "value": 412.3,
        "unit": "frames/sec/chip", "vs_baseline": 2.062,
        "detail": {**dict.fromkeys(GATE_KEYS, 0.0), "fps_720p_device": 412.3457,
                   "train_mesh_devices": 1, "live_720p_chunk1_ms": 14.1235,
                   "live_720p_chunk1_ms_n": 200},
    }


def test_a_failing_window_fails_the_run(monkeypatch, capsys):
    """A reading that raises is not caught: no headline, no exit 0."""
    monkeypatch.setattr(bench, "_card", lambda: torch.device("cpu"))
    monkeypatch.setattr(bench, "measure", lambda device, rng: (1.0, {}))

    def failing(device, rng):
        raise RuntimeError("the traced window holds no device event")

    monkeypatch.setattr(bench, "measure_windows", failing)
    with pytest.raises(RuntimeError, match="no device event"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_no_card_no_headline(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_main(["bench"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no CUDA device" in captured.err


def test_the_suite_imports_no_jax():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import pwstablenet_tpu_torch.bench\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pwstablenet_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    # -I: no PYTHON* variables and no user site, so only the suite's own
    # imports can load a module
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# ---------------------------------------------------------------------
# the wall-clock windows
# ---------------------------------------------------------------------

WINDOW_COUNTS = {"wall_fps_720p_clip": 3, "wall_fps_1080p_clip": 3, "live_720p_chunk1_ms": 10,
                 "train_steps_per_s_pool": 2, "train_steps_per_s_deepstab": 2}


@pytest.mark.parametrize("n", [1, 7, 99, 100, 250])
def test_summary_is_numpys(n):
    samples = np.random.default_rng(n).lognormal(0.0, 0.5, n)
    s = bench._summary(list(samples))
    assert s["median"] == pytest.approx(float(np.median(samples)), rel=1e-12)
    assert s["q1"] == pytest.approx(float(np.percentile(samples, 25)), rel=1e-12)
    assert s["q3"] == pytest.approx(float(np.percentile(samples, 75)), rel=1e-12)
    assert s["n"] == n and s["q1"] <= s["median"] <= s["q3"]
    if n >= 100:
        assert s["p90"] == pytest.approx(float(np.percentile(samples, 90)), rel=1e-12)
        assert int((samples > s["p90"]).sum()) >= 10
    else:
        assert set(s) == {"median", "q1", "q3", "n"}


@pytest.mark.parametrize("spans, seconds", [
    ([], 0.0),
    ([(0.0, 10.0)], 10e-6),
    ([(20.0, 30.0), (0.0, 10.0)], 20e-6),            # disjoint, unsorted
    ([(0.0, 10.0), (5.0, 15.0)], 15e-6),             # overlapping
    ([(0.0, 30.0), (5.0, 10.0), (12.0, 40.0)], 40e-6),  # nested, then past it
    ([(0.0, 10.0), (10.0, 20.0)], 20e-6),            # touching
])
def test_busy_is_the_union_of_device_intervals(spans, seconds):
    assert bench._union_seconds(spans) == pytest.approx(seconds, abs=1e-15)


def test_window_keys_are_apart_from_the_jax_suites():
    assert not set(bench.WINDOW_KEYS) & set(bench.KEYS_OF_JAX_SUITE.values())
    assert not set(bench.WINDOW_KEYS) & set(bench.KEYS_OF_JAX_SUITE)
    assert len(set(bench.WINDOW_KEYS)) == len(bench.WINDOW_KEYS) == 21
    assert bench.WINDOW_SAMPLES == {
        "wall_fps_720p_clip": 7, "wall_fps_1080p_clip": 7, "live_720p_chunk1_ms": 200,
        "train_steps_per_s_pool": 7, "train_steps_per_s_deepstab": 7}
    # the defaults give those counts: 7 clip calls, 200 chunks, 7 logs
    defaults = {k: p.default for k, p in inspect.signature(bench.measure_windows).parameters.items()}
    assert (defaults["clip_calls"], defaults["live_chunks"], defaults["train_logs"]) == (7, 200, 7)
    assert (defaults["clip_frames"], defaults["hd"], defaults["fhd"]) == (240, (720, 1280), (1080, 1920))
    assert (defaults["log_every"], defaults["tree"]) == (10, (4, 60, 360, 640))


@pytest.fixture(scope="module")
def tiny_windows():
    """``measure_windows`` at TINY on the CPU: 12-frame clips of 36x64 and
    40x72, 12 live chunks (2 warm), 6 train steps a run (log every 2) from
    the pool of 8 batches and from a 1-pair tree of 12 frames of 64x96.
    Records every ``train`` call's logs and every live chunk's frames."""
    from pwstablenet_tpu_torch.pipeline import Stabilizer
    from pwstablenet_tpu_torch.train import loop

    runs, live = [], []
    real_train, real_dispatch = loop.train, Stabilizer._dispatch_chunk

    def recording_train(*a, log_fn, **k):
        logs = []
        runs.append((logs, k))
        return real_train(*a, log_fn=lambda m: (logs.append(m), log_fn(m)), **k)

    def recording_dispatch(self, frames, allow_short=False):
        if self.pipeline_cfg.batch_windows == 1:
            live.append((frames.shape, self.model_cfg.temporal_center))
        return real_dispatch(self, frames, allow_short)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "train", recording_train)
        mp.setattr(Stabilizer, "_dispatch_chunk", recording_dispatch)
        results = bench.measure_windows(
            torch.device("cpu"), np.random.default_rng(0), TINY, hd=(36, 64), fhd=(40, 72),
            clip_frames=12, clip_calls=3, live_warm=2, live_chunks=10, train_logs=2,
            log_every=2, tree=(1, 12, 64, 96))
    return results, runs, live


def test_windows_write_every_key(tiny_windows):
    results, _, _ = tiny_windows
    # on the CPU: no idle share, no peak memory, and no p90 under 100 samples
    assert set(results) == set(bench.WINDOW_KEYS)
    bad = {k: v for k, v in results.items() if not (math.isfinite(v) and v > 0)}
    assert not bad, bad
    for key, n in WINDOW_COUNTS.items():
        assert results[f"{key}_n"] == n
        assert results[f"{key}_q1"] <= results[key] <= results[f"{key}_q3"]


def test_live_chunks_are_causal_windows_of_one(tiny_windows):
    _, _, live = tiny_windows
    T = TINY.temporal_window
    assert live == [((T, 36, 64, 3), T - 1)] * 12


def test_train_samples_are_the_logs_after_the_first(tiny_windows):
    results, runs, _ = tiny_windows
    assert len(runs) == 2
    for key, (logs, kwargs) in zip(("train_steps_per_s_pool", "train_steps_per_s_deepstab"), runs):
        assert kwargs["max_steps"] == 6 and kwargs["device"] == torch.device("cpu")
        assert [m["step"] for m in logs] == [2, 4, 6]
        s = bench._summary([1.0 / m["sec_per_step"] for m in logs[1:]])
        assert (results[key], results[f"{key}_q1"], results[f"{key}_q3"]) == (
            s["median"], s["q1"], s["q3"])
