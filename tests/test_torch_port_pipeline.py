"""Port ``Stabilizer`` vs the JAX ``Stabilizer`` on the CPU: streaming
with halo carry and a short flush chunk, the causal mode, float input,
the border crop and ``apply_warp_fields``; plus the port's import
boundary and its refusal to run without a card unless asked for the
CPU."""

import dataclasses
import os
import subprocess
import sys
import tracemalloc

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pwstablenet_tpu import pipeline as jax_pipeline
from pwstablenet_tpu.config import ModelConfig as JaxModelConfig
from pwstablenet_tpu.config import PipelineConfig as JaxPipelineConfig
from pwstablenet_tpu.models import CascadedGenerator as JaxGenerator

from pwstablenet_tpu_torch import pipeline
from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig
from pwstablenet_tpu_torch.interop.from_jax import jax_params_to_state_dict

SMALL = dict(
    temporal_window=5,
    num_levels=4,
    base_features=8,
    max_features=16,
    model_resolution=(32, 32),
    num_stages=2,
    compute_dtype="float32",
)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_params(jcfg, seed):
    h, w = jcfg.model_resolution
    params = JaxGenerator(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, jcfg.stack_channels))
    )
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        a = np.asarray(leaf)
        if path[-1].key == "kernel":
            return (rng.standard_normal(a.shape) * 0.05).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(redraw, params)


def _clip(frames=11, h=48, w=64, seed=0):
    """A smooth uint8 clip (a coarse random pattern, upsampled)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (frames, 6, 8, 3)).astype(np.float32)
    up = jax.image.resize(jnp.asarray(coarse), (frames, h, w, 3), "bilinear")
    return np.clip(np.asarray(up), 0, 255).round().astype(np.uint8)


def _pair(overrides=None, batch_windows=4, **pipe):
    o = {**SMALL, **(overrides or {})}
    jcfg, cfg = JaxModelConfig(**o), ModelConfig(**o)
    params = _random_params(jcfg, seed=3)
    ref = jax_pipeline.Stabilizer(
        jcfg, JaxPipelineConfig(batch_windows=batch_windows, **pipe), params=params
    )
    port = pipeline.Stabilizer(
        cfg, PipelineConfig(batch_windows=batch_windows, **pipe),
        state_dict=jax_params_to_state_dict(params, cfg), device="cpu",
    )
    return ref, port


def _assert_close(out, flows, ref_out, ref_flows):
    assert out.shape == ref_out.shape and out.dtype == ref_out.dtype
    assert flows.shape == ref_flows.shape and flows.dtype == ref_flows.dtype
    assert np.abs(ref_flows).max() > 1e-2  # a real warp
    np.testing.assert_allclose(flows, ref_flows, atol=5e-4)
    if out.dtype == np.uint8:
        diff = np.abs(out.astype(np.int32) - ref_out.astype(np.int32))
        assert diff.max() <= 1
    else:
        np.testing.assert_allclose(out, ref_out, atol=5e-4)


MODES = (("centered", {}), ("causal", {"temporal_center": SMALL["temporal_window"] - 1}))
REFERENCE_CASES = [
    pytest.param(overrides, 11, 4, id=mode) for mode, overrides in MODES
] + [
    pytest.param(overrides, frames, bw, id=f"{mode}-bw{bw}-{frames}f")
    for mode, overrides in MODES
    for bw in (1, 4)
    for frames in (1, 5, 11, 13, 2 * bw + SMALL["temporal_window"] - 1)
    if (frames, bw) != (11, 4)
]


@pytest.mark.parametrize("overrides,frames,batch_windows", REFERENCE_CASES)
def test_stabilize_frames_matches_reference(overrides, frames, batch_windows):
    """The port's stream against the reference's at every clip length the
    stream treats apart: one frame and clips shorter than one chunk (only
    a padded flush chunk), 11 frames in chunks of 4 windows (two full
    chunks carrying the halo, then a padded flush chunk), two full chunks
    and no flush, and one window a chunk."""
    ref, port = _pair(overrides, batch_windows)
    clip = _clip(frames=frames)
    ref_out, ref_flows = ref.stabilize_frames(clip)
    out, flows = port.stabilize_frames(clip)
    assert out.shape == clip.shape and flows.shape == (frames, 32, 32, 2)
    _assert_close(out, flows, ref_out, ref_flows)


def test_stabilize_float_clip_and_fp16_fields():
    ref, port = _pair(warp_field_dtype="float16")
    clip = _clip(frames=6).astype(np.float32) / 127.5 - 1.0
    ref_out, ref_flows = ref.stabilize_frames(clip)
    out, flows = port.stabilize_frames(clip)
    assert flows.dtype == np.float16
    _assert_close(out, flows.astype(np.float32), ref_out,
                  ref_flows.astype(np.float32))


def test_stabilize_bf16_fields_match_reference():
    """bfloat16 warp fields come back as ``ml_dtypes.bfloat16``, as the
    reference's do: the port's float32 fields rounded to bfloat16, and
    the reference's values within its float32 tolerance plus one
    bfloat16 rounding step (2^-8 relative)."""
    import ml_dtypes

    ref, port = _pair(warp_field_dtype="bfloat16")
    clip = _clip(frames=6)
    ref_out, ref_flows = ref.stabilize_frames(clip)
    out, flows = port.stabilize_frames(clip)
    assert flows.dtype == ref_flows.dtype == np.dtype(ml_dtypes.bfloat16)
    assert flows.shape == ref_flows.shape == (6, 32, 32, 2)
    np.testing.assert_array_equal(out, port.stabilize_frames(clip)[0])
    assert np.abs(out.astype(np.int32) - ref_out.astype(np.int32)).max() <= 1
    f32 = pipeline.Stabilizer(ModelConfig(**SMALL), PipelineConfig(batch_windows=4),
                              state_dict=port.model.state_dict(), device="cpu")
    _, flows32 = f32.stabilize_frames(clip)
    np.testing.assert_array_equal(flows.view(np.int16),
                                  flows32.astype(ml_dtypes.bfloat16).view(np.int16))
    np.testing.assert_allclose(flows.astype(np.float32), ref_flows.astype(np.float32),
                               atol=5e-4, rtol=2.0**-8)


def test_bf16_archive_round_trip_and_apply(tmp_path):
    """A bfloat16 archive written by ``WarpFieldWriter`` loads back as the
    same bfloat16 values (the reference's loader reads the same bytes as
    2-byte voids), and ``apply_warp_fields`` takes it and the array
    alike, as the reference takes the array."""
    import ml_dtypes

    from pwstablenet_tpu.data import warp_fields as jax_warp_fields
    from pwstablenet_tpu_torch.data import warp_fields

    _, port = _pair(warp_field_dtype="bfloat16")
    clip = _clip(frames=7)
    out, flows = port.stabilize_frames(clip)
    path = str(tmp_path / "wf.npz")
    with warp_fields.WarpFieldWriter(path) as w:
        w.write(flows[:4])
        w.write(flows[4:])
    loaded = warp_fields.load_warp_fields(path)
    assert loaded.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(loaded.view(np.int16), flows.view(np.int16))
    np.testing.assert_array_equal(jax_warp_fields.load_warp_fields(path).view(np.int16),
                                  flows.view(np.int16))
    cfg = ModelConfig(**SMALL)
    redo = pipeline.apply_warp_fields(clip, loaded, cfg, batch_frames=3, device="cpu")
    # the stream warped with the flows before their bfloat16 rounding
    assert np.abs(redo.astype(np.int32) - out.astype(np.int32)).max() <= 1
    np.testing.assert_array_equal(
        redo, pipeline.apply_warp_fields(clip, flows.astype(np.float32), cfg, device="cpu"))
    ref = jax_pipeline.apply_warp_fields(clip, flows, JaxModelConfig(**SMALL), batch_frames=3)
    assert np.abs(redo.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_bf16_fields_without_ml_dtypes_refused_at_construction(monkeypatch):
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # import raises
    with pytest.raises(RuntimeError, match="ml_dtypes"):
        pipeline.Stabilizer(ModelConfig(**SMALL),
                            PipelineConfig(warp_field_dtype="bfloat16"), device="cpu")
    pipeline.Stabilizer(ModelConfig(**SMALL), PipelineConfig(warp_field_dtype="float16"),
                        device="cpu")


def test_stream_chunks_equal_one_shot():
    """Decoded chunks of any size give the same frames as one array:
    chunks of 3, 6 and 4 frames, of 1, of 3, of 9, and of mixed sizes;
    and a view of the clip with a negative stride."""
    _, port = _pair()
    clip = _clip(frames=13)
    out, flows = port.stabilize_frames(clip)
    for sizes in ([3, 6, 4], [1] * 13, [3] * 5, [9, 4], [1, 9, 2, 1], [5, 0, 1, 7]):
        bounds = np.cumsum([0, *sizes])
        parts = list(port._stream(iter([clip[a:b] for a, b in zip(bounds, bounds[1:])]),
                                  None))
        np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), out,
                                      err_msg=str(sizes))
        np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), flows,
                                      err_msg=str(sizes))
    backwards = clip[::-1].copy()[::-1]
    np.testing.assert_array_equal(port.stabilize_frames(backwards)[0], out)


def test_border_crop_matches_reference():
    ref, port = _pair(border_crop_frac=0.1)
    frames = _clip(frames=3)
    cropped = port._border_crop(frames)
    np.testing.assert_array_equal(cropped, ref._border_crop(frames))
    assert cropped.shape == (3, 48 - 2 * 4, 64 - 2 * 6, 3)


def test_apply_warp_fields_matches_reference_and_reproduces_output():
    _, port = _pair()
    clip = _clip(frames=9)
    out, flows = port.stabilize_frames(clip)
    redo = pipeline.apply_warp_fields(
        clip, flows, ModelConfig(**SMALL), batch_frames=4, device="cpu"
    )
    np.testing.assert_array_equal(redo, out)
    ref = jax_pipeline.apply_warp_fields(
        clip, flows, JaxModelConfig(**SMALL), batch_frames=4
    )
    assert np.abs(redo.astype(np.int32) - ref.astype(np.int32)).max() <= 1
    with pytest.raises(ValueError, match="same time steps"):
        pipeline.apply_warp_fields(clip, flows[:5], device="cpu")


def test_untrained_stabilizer_is_identity():
    st = pipeline.Stabilizer(
        ModelConfig(**SMALL), PipelineConfig(batch_windows=4), seed=5, device="cpu"
    )
    clip = _clip(frames=7)
    out, flows = st.stabilize_frames(clip)
    np.testing.assert_array_equal(out, clip)
    assert not flows.any()


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(**SMALL)
    clip = _clip(frames=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.Stabilizer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.Stabilizer(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.stabilize(clip, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.apply_warp_fields(clip, np.zeros((2, 32, 32, 2), np.float32), cfg)
    out, _ = pipeline.stabilize(clip, cfg, device="cpu")
    assert out.shape == clip.shape


def test_port_imports_nothing_of_jax():
    """Importing every module of the port (and chip_smoke.py,
    kernel_ab.py) leaves jax, flax and pwstablenet_tpu out of
    sys.modules; importing ``cli.__main__`` does not run the CLI."""
    code = r"""
import importlib, pkgutil, sys
import pwstablenet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
assert len(names) >= 38, names
assert "pwstablenet_tpu_torch.cli.__main__" in names, names
for name in names:
    importlib.import_module(name)
import chip_smoke, kernel_ab
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "pwstablenet_tpu"))
assert not bad, bad
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_cli_help_runs_without_jax():
    """``python -m pwstablenet_tpu_torch.cli --help`` exits 0 with
    JAX_PLATFORMS unset, and imports (``-X importtime``) no jax, flax or
    pwstablenet_tpu module."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "pwstablenet_tpu_torch.cli", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "stabilize" in proc.stdout and "apply-warp" in proc.stdout
    imported = [ln.rsplit("|", 1)[-1].strip() for ln in proc.stderr.splitlines()
                if ln.startswith("import time:")]
    assert "pwstablenet_tpu_torch.cli.main" in imported
    bad = sorted(m for m in imported
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "pwstablenet_tpu"))
    assert not bad, bad


# ---------------------------------------------------------------------
# the stream against the chunk-by-chunk algorithm it replaced
# ---------------------------------------------------------------------


def _port(overrides=None, batch_windows=4, **pipe):
    """A port ``Stabilizer`` at SMALL with seeded weights and nonzero warp
    heads (no JAX weights: these tests compare the port with itself)."""
    st = pipeline.Stabilizer(ModelConfig(**{**SMALL, **(overrides or {})}),
                             PipelineConfig(batch_windows=batch_windows, **pipe),
                             seed=2, device="cpu")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, m in st.model.named_children():
            if name.startswith("stage"):
                m.head.weight.copy_(torch.randn(m.head.weight.shape, generator=gen) * 0.05)
    return st


def _chunk_by_chunk(st, clip):
    """``stabilize_frames`` as it was: lead- and tail-pad the whole clip on
    the host, send each group of ``n + T - 1`` frames at stride ``n``
    through ``_chunk_step`` (the last padded to ``batch_windows`` windows
    with copies of its last frame), keep each group's valid rows, and
    concatenate."""
    cfg = st.model_cfg
    T, n = cfg.temporal_window, st.pipeline_cfg.batch_windows
    padded = np.concatenate([np.repeat(clip[:1], cfg.center_index, axis=0), clip,
                             np.repeat(clip[-1:], cfg.future_frames, axis=0)])
    outs, flows = [], []
    for s in range(0, len(clip), n):
        take = min(n, len(clip) - s)
        group = padded[s : s + take + T - 1]
        group = np.concatenate([group, np.repeat(group[-1:], n - take, axis=0)])
        out, flow = st._chunk_step(torch.from_numpy(group))
        outs.append(out[:take].numpy())
        flows.append(pipeline._to_numpy(flow[:take]))
    return np.concatenate(outs), np.concatenate(flows)


STREAM_CASES = [
    pytest.param(frames, bw, mode, "uint8", id=f"{mode}-bw{bw}-{frames}f")
    for mode in ("centred", "causal")
    for bw in (1, 4)
    for frames in (1, 5, 11, 13, 2 * bw + SMALL["temporal_window"] - 1)
] + [pytest.param(11, 4, "centred", "float32", id="centred-bw4-11f-float32-bf16")]


@pytest.mark.parametrize("frames,batch_windows,mode,dtype", STREAM_CASES)
def test_stabilize_frames_bitwise_equal_to_chunk_by_chunk(
        monkeypatch, frames, batch_windows, mode, dtype):
    """The stream is bitwise equal to the chunk-by-chunk algorithm, and
    each frame of the clip is staged to the device and downscaled once."""
    overrides = {"temporal_center": SMALL["temporal_window"] - 1} if mode == "causal" else {}
    pipe = {"warp_field_dtype": "bfloat16"} if dtype == "float32" else {}
    st = _port(overrides, batch_windows, **pipe)
    clip = _clip(frames=frames)
    if dtype == "float32":
        clip = clip.astype(np.float32) / 127.5 - 1.0
    staged, downscaled = [], []
    send, downscale = pipeline._Ring.send, pipeline.Stabilizer._downscale
    monkeypatch.setattr(pipeline._Ring, "send",
                        lambda ring: staged.append(ring.filled) or send(ring))
    monkeypatch.setattr(pipeline.Stabilizer, "_downscale",
                        lambda self, f: downscaled.append(len(f)) or downscale(self, f))
    out, flows = st.stabilize_frames(clip)
    monkeypatch.undo()
    assert sum(staged) == sum(downscaled) == frames, (staged, downscaled)
    want_out, want_flows = _chunk_by_chunk(st, clip)
    assert out.dtype == want_out.dtype and flows.dtype == want_flows.dtype
    assert out.shape == clip.shape and flows.shape == (frames, 32, 32, 2)
    assert np.abs(want_flows.astype(np.float32)).max() > 1e-3  # a real warp
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_array_equal(flows.view(np.uint8), want_flows.view(np.uint8))


def test_results_belong_to_the_caller():
    """Two calls share no memory, writing into the first leaves the second
    as it was, and the pieces ``_stream`` yields stay as they were after
    the stream ends."""
    st = _port()
    clip = _clip(frames=11)
    first, first_flows = st.stabilize_frames(clip)
    second, second_flows = st.stabilize_frames(clip)
    assert not np.shares_memory(first, second)
    assert not np.shares_memory(first_flows, second_flows)
    want, want_flows = second.copy(), second_flows.copy()
    first[...] = 0
    first_flows[...] = 0
    np.testing.assert_array_equal(second, want)
    np.testing.assert_array_equal(second_flows, want_flows)
    parts = list(st._stream(iter([clip[:4], clip[4:]]), None))
    assert len(parts) == 3
    assert not any(np.shares_memory(a[0], b[0]) for i, a in enumerate(parts)
                   for b in parts[i + 1:])
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), want)
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), want_flows)


def test_stream_allocates_no_clip_sized_host_copy():
    """``_stream`` over a 64-frame clip given as one source chunk, each
    result dropped as it comes: the numpy and Python allocations at their
    peak stay within one chunk of frames (``n + T - 1``), not the clip."""
    st = _port()
    clip = _clip(frames=64, h=96, w=128)
    chunk_bytes = (4 + SMALL["temporal_window"] - 1) * clip[0].nbytes
    for _ in st._stream(iter([clip[:8]]), None):  # first-call imports and caches
        pass
    tracemalloc.start()
    try:
        count = 0
        for out, _ in st._stream(iter([clip]), None):
            count += len(out)
            del out
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert count == 64
    assert peak < chunk_bytes, (peak, chunk_bytes, clip.nbytes)


def test_batch_windows_below_configured_refused():
    """A ``batch_windows`` below the configured one is refused before any
    chunk runs; one above it runs, its flush chunk padded to the
    configured width."""
    st = _port()
    clip = _clip(frames=11)
    with pytest.raises(ValueError, match="below the configured"):
        st.stabilize_frames(clip, batch_windows=2)
    wide = st.stabilize_frames(clip, batch_windows=6)
    np.testing.assert_array_equal(wide[0], st.stabilize_frames(clip)[0])


def test_failed_stream_stops_the_results_worker(monkeypatch):
    """A chunk that fails mid-clip raises from ``stabilize_frames`` and
    leaves no results worker thread running."""
    import threading

    st = _port()
    calls = []
    step = pipeline.Stabilizer._carried_step

    def failing(self, *args):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("planted failure")
        return step(self, *args)

    monkeypatch.setattr(pipeline.Stabilizer, "_carried_step", failing)
    with pytest.raises(RuntimeError, match="planted failure"):
        st.stabilize_frames(_clip(frames=11))
    assert not [t for t in threading.enumerate() if t.name.startswith("pwst-results")]


def test_results_worker_under_fast_thread_switching():
    """With the interpreter switching threads every microsecond, the
    results' worker thread still fills every row of a 40-chunk clip with
    its own chunk: bitwise equal to the chunk-by-chunk algorithm."""
    st = _port(batch_windows=1)
    clip = _clip(frames=40, h=24, w=32)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out, flows = st.stabilize_frames(clip)
    finally:
        sys.setswitchinterval(interval)
    want_out, want_flows = _chunk_by_chunk(st, clip)
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_array_equal(flows, want_flows)
