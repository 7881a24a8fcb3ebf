"""The port's user-facing surface against the JAX package's on the CPU:
warp-field archives, video I/O (OpenCV and the native runtime),
``Stabilizer.stabilize_video``, the exported chunk step and its two
operators, the quality metrics, the eval hook and the TensorBoard
writer.

Tolerances: where both sides run the same numpy/OpenCV code (archives,
decode, metrics on one clip, event files) the results are equal.  Where
the generator runs, they are the pipeline tests' (warp fields MSE <=
1e-3 and atol 5e-4, uint8 frames +-1 code: the JAX CPU warp is f32 then
``from_unit``, the port's the packed uint8 blend).  Videos that carry
frames to compare are written losslessly (FFV1)."""

import glob
import struct
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pwstablenet_tpu import export as jax_export
from pwstablenet_tpu import pipeline as jax_pipeline
from pwstablenet_tpu.config import ModelConfig as JaxModelConfig
from pwstablenet_tpu.config import PipelineConfig as JaxPipelineConfig
from pwstablenet_tpu.data import video_io as jax_video_io
from pwstablenet_tpu.data import warp_fields as jax_warp_fields
from pwstablenet_tpu.eval import hooks as jax_hooks
from pwstablenet_tpu.eval import metrics as jax_metrics
from pwstablenet_tpu.models import CascadedGenerator as JaxGenerator
from pwstablenet_tpu.utils import tb_writer as jax_tb

from pwstablenet_tpu_torch import export, pipeline
from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig, TrainConfig
from pwstablenet_tpu_torch.data import native_io, video_io, warp_fields
from pwstablenet_tpu_torch.data.synthetic import synthetic_pair_clip
from pwstablenet_tpu_torch.eval import hooks, metrics
from pwstablenet_tpu_torch.interop.from_jax import jax_params_to_state_dict
from pwstablenet_tpu_torch.kernels import grid_sample as K
from pwstablenet_tpu_torch.models.generator import CascadedGenerator
from pwstablenet_tpu_torch.utils import tb_writer

# the TINY config of tests/test_torch_port_train.py
TINY = dict(
    temporal_window=3, num_levels=4, base_features=8, max_features=16,
    model_resolution=(32, 32), num_stages=2, disc_num_layers=2,
    feat_channels=(8, 16), compute_dtype="float32",
)


def _random_params(jcfg, seed=3):
    """JAX generator params with every conv kernel redrawn (std 0.05), so
    that the warps are real."""
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


def _pair(batch_windows=4, **pipe):
    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    params = _random_params(jcfg)
    ref = jax_pipeline.Stabilizer(
        jcfg, JaxPipelineConfig(batch_windows=batch_windows, **pipe), params=params
    )
    port = pipeline.Stabilizer(
        cfg, PipelineConfig(batch_windows=batch_windows, **pipe),
        state_dict=jax_params_to_state_dict(params, cfg), device="cpu",
    )
    return ref, port


def _clip(frames=11, h=48, w=64, seed=0):
    """A smooth uint8 clip (a coarse random pattern, upsampled)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (frames, 6, 8, 3)).astype(np.float32)
    up = torch.nn.functional.interpolate(
        torch.from_numpy(coarse).permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
        align_corners=False,
    ).permute(0, 2, 3, 1).numpy()
    return np.clip(up, 0, 255).round().astype(np.uint8)


def _write_lossless(path, frames, fps=30.0):
    video_io.write_video(path, frames, fps, codec="FFV1")
    return path


def _assert_frames_close(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype == np.uint8
    assert np.abs(out.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def _assert_flows_close(flows, ref):
    assert flows.shape == ref.shape and flows.dtype == ref.dtype
    assert np.abs(ref).max() > 1e-2  # a real warp
    assert float(np.mean((flows - ref) ** 2)) <= 1e-3
    np.testing.assert_allclose(flows, ref, atol=5e-4)


# ---------------------------------------------------------------------
# warp-field archives
# ---------------------------------------------------------------------

_WRITERS = {"jax": jax_warp_fields, "port": warp_fields}


@pytest.mark.parametrize("reader", ["jax", "port"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_warp_field_archives_cross_read(tmp_path, writer, reader):
    """Either package's chunked archive reads back bitwise in either."""
    rng = np.random.default_rng(1)
    chunks = [rng.standard_normal((n, 8, 8, 2)).astype(np.float32) for n in (4, 4, 3)]
    path = str(tmp_path / "wf.npz")
    with _WRITERS[writer].WarpFieldWriter(path) as w:
        for c in chunks:
            w.write(c)
    assert w.frames == 11
    got = _WRITERS[reader].load_warp_fields(path)
    np.testing.assert_array_equal(got, np.concatenate(chunks))
    with zipfile.ZipFile(path) as z:
        assert z.namelist() == ["arr_00000.npy", "arr_00001.npy", "arr_00002.npy"]
        assert all(i.compress_type == zipfile.ZIP_STORED for i in z.infolist())


def test_warp_field_members_bytes_equal_and_legacy_layout(tmp_path):
    rng = np.random.default_rng(2)
    flows = rng.standard_normal((5, 8, 8, 2)).astype(np.float16)
    members = {}
    for name, mod in _WRITERS.items():
        path = str(tmp_path / f"{name}.npz")
        with mod.WarpFieldWriter(path) as w:
            w.write(flows)
        with zipfile.ZipFile(path) as z:
            members[name] = z.read("arr_00000.npy")
    assert members["jax"] == members["port"]
    legacy = str(tmp_path / "legacy.npz")
    np.savez_compressed(legacy, warp_fields=flows)
    np.testing.assert_array_equal(warp_fields.load_warp_fields(legacy), flows)
    empty = str(tmp_path / "empty.npz")
    np.savez(empty, other=flows)
    with pytest.raises(ValueError, match="no warp fields"):
        warp_fields.load_warp_fields(empty)


# ---------------------------------------------------------------------
# video I/O
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def clip_file(tmp_path_factory):
    """An MJPG clip (lossy, as users' files are) and its source frames."""
    path = str(tmp_path_factory.mktemp("vio") / "clip.avi")
    _, unstable = synthetic_pair_clip(13, 48, 64, seed=5)
    jax_video_io.write_video(path, unstable, 30.0, "MJPG")
    return path, unstable


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_read_and_iter_video_match_reference(clip_file, dtype):
    path, _ = clip_file
    ref, ref_fps = jax_video_io.read_video(path, dtype=dtype)
    got, fps = video_io.read_video(path, dtype=dtype)
    assert fps == ref_fps and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        video_io.read_video(path, max_frames=4, dtype=dtype)[0],
        jax_video_io.read_video(path, max_frames=4, dtype=dtype)[0],
    )
    chunks = list(video_io.iter_video(path, 5, dtype=dtype))
    ref_chunks = list(jax_video_io.iter_video(path, 5, dtype=dtype))
    assert [c.shape[0] for c in chunks] == [5, 5, 3]
    for a, b in zip(chunks, ref_chunks, strict=True):
        np.testing.assert_array_equal(a, b)
    assert video_io.probe_video(path) == (ref_fps, 48, 64)


@pytest.mark.parametrize("frames_dtype", [np.uint8, np.float32])
def test_write_video_matches_reference(tmp_path, frames_dtype):
    frames = _clip(frames=4)
    if frames_dtype == np.float32:
        frames = frames.astype(np.float32) / 127.5 - 1.0
    a, b = str(tmp_path / "port.avi"), str(tmp_path / "jax.avi")
    video_io.write_video(a, frames, 25.0, codec="FFV1")
    jax_video_io.write_video(b, frames, 25.0, codec="FFV1")
    got, fps = video_io.read_video(a, dtype=np.uint8)
    ref, _ = jax_video_io.read_video(b, dtype=np.uint8)
    assert fps == 25.0
    np.testing.assert_array_equal(got, ref)
    stream = str(tmp_path / "stream.avi")
    w = video_io.VideoWriterStream(stream, 25.0, frames.shape[1:3], codec="FFV1")
    w.write(frames[:3])
    w.write(frames[3:])
    w.close()
    np.testing.assert_array_equal(video_io.read_video(stream, dtype=np.uint8)[0], ref)


def test_native_decoder_matches_opencv_path(clip_file):
    path, _ = clip_file
    assert native_io.available(), "the native runtime builds on this host"
    ref, fps = video_io.read_video(path, dtype=np.uint8)
    dec = native_io.NativeDecoder(path, chunk_frames=4)
    assert (dec.height, dec.width, dec.fps) == (48, 64, fps)
    chunks = list(dec)
    dec.close()
    assert [c.shape[0] for c in chunks] == [4, 4, 4, 1]
    np.testing.assert_array_equal(np.concatenate(chunks), ref)


def test_native_encode_decode_round_trip(tmp_path):
    clip = _clip(frames=6)
    out = str(tmp_path / "rt.avi")
    enc = native_io.NativeEncoder(out, 30.0, clip.shape[1:3], "FFV1")
    enc.write(clip[:4])
    floats = clip[4:].astype(np.float32) / 127.5 - 1.0
    enc.write(floats)  # float frames are converted on the host, truncating
    with pytest.raises(ValueError, match="shape"):
        enc.write(clip[:, :40])
    enc.close()
    want = np.concatenate([clip[:4], np.clip((floats + 1.0) * 127.5, 0, 255).astype(np.uint8)])
    np.testing.assert_array_equal(video_io.read_video(out, dtype=np.uint8)[0], want)
    dec = native_io.NativeDecoder(out, chunk_frames=8)
    np.testing.assert_array_equal(np.concatenate(list(dec)), want)


def test_missing_video_raises(tmp_path):
    missing = str(tmp_path / "missing.avi")
    with pytest.raises(FileNotFoundError):
        native_io.NativeDecoder(missing)
    with pytest.raises(FileNotFoundError):
        video_io.read_video(missing)
    with pytest.raises(FileNotFoundError):
        video_io.iter_video(missing, 4)
    _, port = _pair()
    with pytest.raises(FileNotFoundError):
        port.stabilize_video(missing, str(tmp_path / "out.avi"))


def test_missing_cv2_raises_on_use(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="OpenCV"):
        video_io.read_video("any.avi")


# ---------------------------------------------------------------------
# stabilize_video
# ---------------------------------------------------------------------


@pytest.mark.parametrize("max_frames", [-1, 7], ids=["all", "max_frames=7"])
def test_stabilize_video_matches_reference(tmp_path, max_frames):
    """Both packages on one file and one set of weights (both through
    their native runtimes): the result dict, the frames and the warp
    fields."""
    ref, port = _pair(output_codec="FFV1")
    src = _write_lossless(str(tmp_path / "in.avi"), _clip())
    outs = {}
    for name, st in (("jax", ref), ("port", port)):
        out, wf = str(tmp_path / f"{name}.avi"), str(tmp_path / f"{name}.npz")
        res = st.stabilize_video(src, out, warp_field_path=wf, max_frames=max_frames)
        assert res == {"frames": 11 if max_frames < 0 else 7, "fps": 30.0,
                       "output": out, "warp_fields": wf}
        outs[name] = (video_io.read_video(out, dtype=np.uint8)[0],
                      warp_fields.load_warp_fields(wf))
    _assert_frames_close(outs["port"][0], outs["jax"][0])
    _assert_flows_close(outs["port"][1], outs["jax"][1])
    # the port's file holds exactly what stabilize_frames gives
    n = outs["port"][0].shape[0]
    frames, flows = port.stabilize_frames(_clip()[:n])
    np.testing.assert_array_equal(outs["port"][0], frames)
    np.testing.assert_array_equal(outs["port"][1], flows)


def test_stabilize_video_border_crop_and_opencv_path(tmp_path, monkeypatch, capsys):
    """With a border crop the encoder takes the cropped size (the
    reference's crop semantics, held against its ``_border_crop``); the
    OpenCV path gives the native path's output; a native decoder that
    fails falls back to OpenCV and says so."""
    ref, port = _pair(output_codec="FFV1", border_crop_frac=0.1)
    clip = _clip()
    src = _write_lossless(str(tmp_path / "in.avi"), clip)
    native_out = str(tmp_path / "native.avi")
    assert port.stabilize_video(src, native_out)["frames"] == 11
    got = video_io.read_video(native_out, dtype=np.uint8)[0]
    assert got.shape == (11, 48 - 2 * 4, 64 - 2 * 6, 3)
    np.testing.assert_array_equal(got, port._border_crop(port.stabilize_frames(clip)[0]))
    _assert_frames_close(got, ref._border_crop(ref.stabilize_frames(clip)[0]))

    monkeypatch.setattr(native_io, "available", lambda: False)
    cv_out = str(tmp_path / "cv.avi")
    assert port.stabilize_video(src, cv_out, max_frames=5)["frames"] == 5
    np.testing.assert_array_equal(  # the clip ends at frame 5: its tail pad differs
        video_io.read_video(cv_out, dtype=np.uint8)[0],
        port._border_crop(port.stabilize_frames(clip[:5])[0]))

    def broken(*args, **kwargs):
        raise OSError("bad native library")

    monkeypatch.setattr(native_io, "available", lambda: True)
    monkeypatch.setattr(native_io, "NativeDecoder", broken)
    fb_out = str(tmp_path / "fallback.avi")
    assert port.stabilize_video(src, fb_out)["frames"] == 11
    assert "falling back to the Python OpenCV path" in capsys.readouterr().err
    np.testing.assert_array_equal(video_io.read_video(fb_out, dtype=np.uint8)[0], got)


def test_stream_to_counts_and_feeds_both_writers():
    _, port = _pair()
    clip = _clip(frames=9)
    frames, flows = port.stabilize_frames(clip)
    out, fl = [], []
    n = port._stream_to(iter([clip[:5], clip[5:]]), SimpleNamespace(write=out.append),
                        SimpleNamespace(write=fl.append))
    assert n == 9
    np.testing.assert_array_equal(np.concatenate(out), frames)
    np.testing.assert_array_equal(np.concatenate(fl), flows)
    chunks = [np.zeros((4, 2, 2, 3), np.uint8), np.ones((4, 2, 2, 3), np.uint8)]
    limited = list(pipeline._limit_frames(iter(chunks), 6))
    assert [c.shape[0] for c in limited] == [4, 2]
    assert len(list(pipeline._limit_frames(iter(chunks), 4))) == 1


# ---------------------------------------------------------------------
# export and the two operators
# ---------------------------------------------------------------------


def _call_targets(program):
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


def test_export_round_trip_equals_chunk_step(tmp_path):
    _, port = _pair()
    program = export.export_chunk_step(port, (48, 64))
    targets = _call_targets(program)
    assert targets.count("pwst.grid_sample_f32.default") == 1  # the inter-stage warp
    assert targets.count("pwst.grid_sample_packed_u8.default") == 1  # the output warp
    # the weights are arguments: no parameter, buffer or constant inside
    assert not program.state_dict and not program.constants
    n_weights = len(port.model.state_dict())
    assert len(program.graph_signature.user_inputs) == n_weights + 1
    path = export.save_chunk_step(str(tmp_path / "step.pt2"), port, frame_hw=(48, 64))
    step = export.ExportedStabilizerStep.load(path)
    frames = torch.from_numpy(_clip(frames=6))
    K.reset_launch_counts()
    got = step(port.model.state_dict(), frames)
    want = port._chunk_step(frames)
    assert torch.equal(got[0], want[0]) and got[0].dtype == torch.uint8
    assert torch.equal(got[1], want[1])
    assert all(v == 0 for v in K.LAUNCHES.values())  # plain versions on the CPU
    # one artifact, other weights
    other = {k: v + 0.01 * torch.randn_like(v) for k, v in port.model.state_dict().items()}
    port.model.load_state_dict(other)
    again = step(other, frames)
    want2 = port._chunk_step(frames)
    assert torch.equal(again[1], want2[1]) and not torch.equal(again[1], got[1])


def test_exported_step_matches_jax_export(tmp_path):
    ref, port = _pair()
    jpath = jax_export.save_chunk_step(str(tmp_path / "jax.stablehlo"), ref, frame_hw=(48, 64))
    ppath = export.save_chunk_step(str(tmp_path / "port.pt2"), port, frame_hw=(48, 64))
    frames = _clip(frames=6)
    js, jf = jax_export.ExportedStabilizerStep.load(jpath)(ref.params, frames)
    ps, pf = export.ExportedStabilizerStep.load(ppath)(
        port.model.state_dict(), torch.from_numpy(frames))
    _assert_frames_close(ps.numpy(), np.asarray(js))
    _assert_flows_close(pf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("op", ["grid_sample_f32", "grid_sample_packed_u8"])
def test_operators_pass_opcheck(op):
    rng = np.random.default_rng(4)
    grid = torch.from_numpy(rng.uniform(-1.2, 1.2, (2, 5, 7, 2)).astype(np.float32))
    if op == "grid_sample_f32":
        image = torch.from_numpy(rng.random((2, 6, 9, 3), np.float32))
        args = (image, grid, False, True)
    else:
        image = torch.from_numpy(rng.integers(0, 256, (2, 6, 9, 3), dtype=np.uint8))
        args = (image, grid, True)
    result = torch.library.opcheck(getattr(torch.ops.pwst, op).default, args)
    assert set(result.values()) == {"SUCCESS"}, result
    out = getattr(torch.ops.pwst, op)(*args)
    assert out.shape == (2, 5, 7, 3) and out.dtype == image.dtype
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = getattr(torch.ops.pwst, op)(*(mode.from_tensor(a) if torch.is_tensor(a) else a
                                             for a in args))
    assert fake.shape == out.shape and fake.dtype == out.dtype


# ---------------------------------------------------------------------
# metrics and the eval hook
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def metric_clips():
    stable, unstable = synthetic_pair_clip(12, 96, 128, seed=3)
    return stable, unstable


_METRIC_CALLS = {
    "interframe_transforms": lambda m, s, u: m.interframe_transforms(u, return_tracked_fraction=True),
    "stability_score": lambda m, s, u: m.stability_score(u),
    "stability_score_empty": lambda m, s, u: m.stability_score(u[:1]),
    "jitter_rms_px": lambda m, s, u: m.jitter_rms_px(u, smooth_frames=5),
    "jitter_rms_px_short": lambda m, s, u: m.jitter_rms_px(u[:3]),
    "cropping_ratio_and_distortion": lambda m, s, u: m.cropping_ratio_and_distortion(u, s),
    "psnr": lambda m, s, u: (m.psnr(s, u), m.psnr(s, s)),
    "ssim": lambda m, s, u: m.ssim(s, u),
    "stability_report": lambda m, s, u: m.stability_report(s, u),
    "fidelity_report": lambda m, s, u: m.fidelity_report(u, s),
}


@pytest.mark.parametrize("name", list(_METRIC_CALLS))
def test_metrics_equal_reference(metric_clips, name):
    stable, unstable = metric_clips
    got = _METRIC_CALLS[name](metrics, stable, unstable)
    ref = _METRIC_CALLS[name](jax_metrics, stable, unstable)
    np.testing.assert_equal(got, ref)
    if name == "stability_score_empty":
        assert got == 1.0  # the reference's value on no transforms
    if name == "jitter_rms_px_short":
        assert np.isnan(got)


def test_eval_hook_matches_reference_and_takes_the_ema(metric_clips):
    stable, unstable = metric_clips
    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    params = _random_params(jcfg, seed=9)
    jhook = jax_hooks.make_clip_eval_hook(jcfg, unstable[:9], stable_clip=stable[:9],
                                          batch_windows=4)
    hook = hooks.make_clip_eval_hook(cfg, unstable[:9], stable_clip=stable[:9],
                                     batch_windows=4)
    assert hook.fingerprint == jhook.fingerprint
    ref = jhook(SimpleNamespace(g_params=params, g_ema=None))
    # the raw generator holds other weights: the hook must take the EMA
    ema = CascadedGenerator(cfg)
    ema.load_state_dict(jax_params_to_state_dict(params, cfg))
    state = SimpleNamespace(
        generator_params=lambda: state.g_ema,
        g=CascadedGenerator(cfg, generator=torch.Generator().manual_seed(1)),
        g_ema=ema,
    )
    got = hook(state)
    assert set(got) == set(ref) == {
        "eval_stability", "eval_stability_unstable", "eval_psnr_vs_stable"}
    assert got["eval_stability_unstable"] == ref["eval_stability_unstable"]
    # +-1 code frames: the scores agree to 1e-3, the PSNR to 0.05 dB
    assert abs(got["eval_stability"] - ref["eval_stability"]) <= 1e-3
    assert abs(got["eval_psnr_vs_stable"] - ref["eval_psnr_vs_stable"]) <= 0.05
    assert got == hook(state)  # one Stabilizer, reloaded: the same numbers


# ---------------------------------------------------------------------
# TensorBoard writer (the JAX package's tests, on the port's copy)
# ---------------------------------------------------------------------


def test_tb_crc32c_known_vectors():
    # RFC 3720 Castagnoli test vectors
    assert tb_writer.crc32c(b"") == 0x0
    assert tb_writer.crc32c(b"123456789") == 0xE3069283
    assert tb_writer.crc32c(bytes(32)) == 0x8A9136AA
    data = b"length-header"
    crc = tb_writer.crc32c(data)
    assert tb_writer.masked_crc32c(data) == (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def test_tb_write_read_and_bytes_equal_reference(tmp_path):
    paths = {}
    for name, mod in (("port", tb_writer), ("jax", jax_tb)):
        w = mod.SummaryWriter(str(tmp_path / name))
        w.add_scalar("loss_g", 0.5, step=1, wall_time=123.0)
        w.add_scalars({"loss_d": 0.25, "fps": 100.0}, step=2, wall_time=124.0)
        w.close()
        paths[name] = w.path
    raw = {k: open(p, "rb").read() for k, p in paths.items()}
    # the first record holds the writer's own clock; the rest are equal
    (length,) = struct.unpack("<Q", raw["port"][:8])
    assert raw["port"][16 + length:] == raw["jax"][16 + length:]
    for reader in (tb_writer, jax_tb):
        events = reader.read_event_file(paths["port"])
        assert events[0]["file_version"] == "brain.Event:2"
        assert events[1] == {"wall_time": 123.0, "step": 1, "scalars": {"loss_g": 0.5}}
        assert {k: v for e in events[2:] for k, v in e["scalars"].items()} == {
            "loss_d": 0.25, "fps": 100.0}


def test_tb_framing_and_corruption(tmp_path):
    w = tb_writer.SummaryWriter(str(tmp_path))
    w.add_scalar("x", 1.0, step=0)
    w.close()
    raw = bytearray(open(w.path, "rb").read())
    (length,) = struct.unpack("<Q", raw[:8])
    assert b"brain.Event:2" in raw[12 : 12 + length]
    assert struct.unpack("<I", raw[8:12])[0] == tb_writer.masked_crc32c(bytes(raw[:8]))
    raw[-6] ^= 0xFF  # flip a payload byte of the last record
    open(w.path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        tb_writer.read_event_file(w.path)


def test_port_train_events_read_by_reference(tmp_path):
    from pwstablenet_tpu_torch.train.loop import synthetic_batch_iterator, train

    cfg = ModelConfig(**TINY)
    logdir = str(tmp_path / "tb")
    tcfg = TrainConfig(batch_size=2, num_epochs=1, steps_per_epoch=10, log_every=2,
                       checkpoint_every=1000, checkpoint_dir=str(tmp_path / "ckpt"),
                       tb_log_dir=logdir)
    batches = synthetic_batch_iterator(cfg, tcfg)
    logged = []
    train(cfg, tcfg, batches, max_steps=2, log_fn=logged.append, device="cpu")
    batches.close()
    (path,) = glob.glob(logdir + "/events.out.tfevents.*")
    events = jax_tb.read_event_file(path)
    assert events == tb_writer.read_event_file(path)
    scalars = [e for e in events if "scalars" in e]
    assert scalars and all(e["step"] == 2 for e in scalars)
    tags = {k: v for e in scalars for k, v in e["scalars"].items()}
    assert {"loss_g", "loss_d", "sec_per_step"} <= set(tags)
    assert tags["loss_g"] == pytest.approx(logged[-1]["loss_g"], rel=1e-6)
