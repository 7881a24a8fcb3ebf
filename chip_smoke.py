#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  - requires a CUDA card (exits non-zero without one); prints
             whether ``ml_dtypes`` (bfloat16 warp fields) and
             ``tensorstore`` (the Orbax checkpoint reader) are installed.
2. build   - builds the CUDA kernels from ``pwstablenet_tpu_torch/csrc``.
3. kernels - each kernel against its plain PyTorch version on the card:
             ``grid_sample_f32`` at (8,256,256,3) and, on a random and on
             the identity grid, at the training path's (16,256,256,3), for
             every padding mode x align_corners, plus a +-300-row vertical
             displacement at 720p, C = 1 and C = 5, W = 853 and a grid
             view 4 bytes off its storage (atol 1e-5);
             ``grid_sample_packed_u8`` at (8,720,1280,3) with smooth
             random flows, border and reflection, both align_corners,
             plus (2,480,853,3), (2,1080,1920,3), image views 1, 2 and 3
             bytes off their storage, a (2,360,640) grid over a 720p
             image, +-300 rows and +-600 columns of displacement and a
             random grid (+-1 code);
             ``grid_sample_grad_f32`` at (16,256,256,3) for every padding
             mode x align_corners on a random and on the identity grid,
             plus the +-300-row case at 720p and, in every padding mode,
             C = 1 and C = 5, W = 853, a (2,360,640) grid and cotangent
             over a 720p image, and grid and cotangent views 4 bytes off
             their storage, each alone and both (atol 2e-4, rtol 1e-4).
4. main    - ``Stabilizer(ModelConfig(), PipelineConfig(batch_windows=8))``
             at full width, seeded random weights with small nonzero
             heads, stabilizes a 24-frame 720p uint8 clip; both forward
             kernels must have been launched.  Then one f32 chunk (TF32
             off) on the card and on the CPU with the same weights:
             flows MSE <= 1e-3 and atol 1e-3, frames +-1 code.
5. train   - ``train()`` with the full default ``ModelConfig()`` and
             ``TrainConfig(batch_size=8)`` (bf16, 256x256) on the port's
             synthetic batches for 5 steps: losses finite, G and D
             changed, the d/dgrid kernel launched 3 times a step and the
             f32 sample kernel launched.
             ``train_deepstab``: the same training from video files on
             disk: ``make-data`` in process writes 2 pairs of 40 MJPG
             frames of 360x640 (read back: the card's OpenCV must write
             and read MJPG), and ``train()`` takes 5 steps from
             ``batch_iterator(DeepStabDataset(...))`` with scale jitter
             (1.0, 1.25) and 4 decode threads, with the same checks;
             seconds and ``sec_per_step`` beside the synthetic phase's,
             the make-data seconds, the loader alone in batches/s at 1, 2
             and 4 decode threads, and the pinned copy of one batch.
             Then one f32 step (TF32 off) at a tiny config on the card
             and on the CPU from one state and batch: metrics rtol 1e-4,
             parameters within 1e-6 on 99.9 %.
             ``train_debug_nans`` (after the train timing):
             ``train()`` with ``debug_nans``, ``log_every`` 5 and
             ``checkpoint_every`` 1 on a float batch whose ``stable`` is
             NaN at step 1: ``FloatingPointError`` at step 1 and no
             checkpoint; then ms a full-width batch-8 step, each synced,
             without and with the per-step check (median of 10 steps
             each, 5 at a time in turns), the check alone after a step
             (median of 7, ending in its own sync), its device busy
             ms under ``torch.profiler`` and its bound (the bytes it
             reads once over 3.35 TB/s), beside the card's name and
             power limit.
6. surface - the user-facing surface (run after the inference timings,
             before training), on the main path's Stabilizer and clip,
             each line with the kernel launches made during it:
             ``surface_stream``: ``Stabilizer._stream_to`` (the loop of
             ``stabilize_video``) on chunks of 8 frames into an in-memory
             writer and a ``WarpFieldWriter`` archive: 24 frames out,
             bitwise equal to ``stabilize_frames``, both forward kernels
             launched, frames/s;
             ``surface_warp_fields``: ``load_warp_fields`` of that archive
             (equal to the flows) and ``apply_warp_fields`` on the clip:
             bitwise equal to the streamed frames, packed kernel launched;
             ``surface_export``: ``export_chunk_step`` at 720p on the
             card, ``torch.export.save``, ``ExportedStabilizerStep.load``,
             one chunk: bitwise equal to ``_chunk_step``, each forward
             kernel launched once by the exported call itself; export,
             save and load seconds; ms per chunk, exported and eager, in
             turns, and the device's busy time over 3 chunks of each;
             and a tiny model's step traced on the CPU, run on the card:
             kernels launched, equal to ``_chunk_step`` there;
             ``surface_cli``: ``cli.main`` in process: ``stabilize
             --synthetic`` (24 720p frames, ``--warp-fields``),
             ``export`` (720p), ``train --synthetic`` (tiny model, 2
             steps, ``--tb-log-dir``, ``--scalar-log``): exit 0, their
             JSON lines, the event file read back, d/dgrid launched 6
             times; ``make-data`` (a tiny tree) and ``train --data-root``
             on it (tiny model, 2 steps, ``--eval-every 2 --eval-clip``
             one of its unstable videos): exit 0, the eval line, d/dgrid
             launched 6 times and the packed kernel by the eval hook;
             ``--eval-every`` without ``--eval-clip``: exit 2;
             ``surface_video``: a 24-frame 720p FFV1 file through
             ``stabilize_video`` (the native decoder where its runtime
             builds and loads, else OpenCV's Python path, as on the
             card's machine, which has ``cv2`` but no OpenCV C++
             headers; the line names which): 24 frames, the file and
             the archive bitwise equal to ``stabilize_frames``.
             ``interop`` (after the surface): the main path's weights
             to the reference's ``.pth`` layout (``torch.save``, ~498 MB)
             and back through ``load_torch_checkpoint``, bit for bit;
             a ``Stabilizer`` from it on the 24-frame 720p clip, bitwise
             equal to the main path's frames and flows, both forward
             kernels launched; ``torch_ref.TorchCascadedGenerator``
             loaded from the ``.pth`` against the port's f32 flows on
             one 256x256 stack (TF32 off; MSE <= 1e-3, max |diff|
             printed); ``stabilize --synthetic --checkpoint x.pth`` at
             720p through the CLI; save and load seconds.  The JAX
             package's Orbax checkpoints need JAX to write: their reader
             is held by the CPU tests (``"orbax": "cpu_tests_only"``).
             ``causal`` (after ``interop``): the live mode,
             ``temporal_center = temporal_window - 1``, with the main
             path's weights: ``stabilize_frames`` of the 24-frame 720p
             clip (both forward kernels launched), one f32 chunk against
             the CPU's (``card_vs_cpu_f32``'s tolerances), ms per chunk
             in turns with the centred chunk, the device time of each,
             and frames/s.
7. timing  - frames/s of ``stabilize_frames`` and ms per chunk (bf16,
             720p), with ``utils.device_time`` of the chunk and of one
             ``grid_sample_f32`` launch at (8,256,256,3); ms per
             full-width train step, steps/s, windows/s and peak memory;
             ``torch.profiler`` passes over one ``stabilize_frames``
             call and over 3 train steps (the device's idle share and
             its time by kernel; the train steps' Chrome trace written
             through ``utils.profiling.trace``, its bytes and events
             printed); each kernel's
             time (``grid_sample_f32`` at both its shapes) beside its
             bound, its plain version's time and one PyTorch call's
             (``F.grid_sample``, ``grid_sampler_2d_backward``; the port
             never calls them), its time on a (1,8,8,3) frame
             (``floor_ms``: launch, ramp and tail) and on its random
             check grid (``random_grid_ms``).
             ``recipe`` (after the train profile):
             ``examples.train_rich_deepstab.run`` at the full model and
             the recipe's hyperparameters, cut to 20 steps on 2 rich
             pairs of 16 frames of 320x448 (log and hook every 10 steps,
             a checkpoint at 20, 16 EVAL frames; the same 32-frame hook
             clip): two finite
             hook readings, ``best_step.json`` holding the larger, the
             ``best`` export in a fresh ``Stabilizer`` scoring it again
             (within 1e-6), ``EVAL[ema]`` and ``EVAL[best]`` finite,
             every kernel launched; seconds and steps/s.
8. parallel - ``parallel/`` (``parallel_nccl_world1``,
             ``parallel_gloo_world2``, then ``parallel`` with the phase's
             seconds): at world size 1 under NCCL in this process, the
             data-parallel train step (bf16, the full model, batch 8, 2
             steps) against ``make_train_step`` from the same state and
             batches (metrics rtol 1e-4, parameters within 1e-6 on 99.9 %),
             ms a step of each in turns and of the gradient sync alone;
             the clip-sharded ``Stabilizer`` at 720p against the main
             path's output (+-1 code, flows 1e-3); ``spatial_sharded_warp``
             of a 2160x3840 uint8 frame, halo 120, against the unsharded
             packed kernel (+-1 code).  Then world size 2 on the one card
             under gloo (NCCL takes one rank per device), two spawned
             processes: an f32 step (TF32 off, 4 windows a rank) against
             the plain step on the whole batch, the f32 clip-sharded
             ``Stabilizer`` against the plain one, and the 4K row-sharded
             warp, uint8 and f32 (atol 5e-5), border and reflection,
             against the unsharded kernels.  Gloo times on one card are
             not speed figures (``gloo_on_one_card``).
9. bench   - the port's benchmark suite (``pwstablenet_tpu_torch.bench``,
             the JAX package's ``bench.py`` at its shapes) through
             ``cli.main(["bench"])`` in process, stdout captured: exit 0,
             exactly one line, the JAX suite's metric, every key of
             ``bench.KEYS_OF_JAX_SUITE`` present and finite, the four
             parity gates inside their limits, a training mesh of 1,
             every MFU in (0, 1] and every kernel launched; the
             wall-clock windows of ``bench.measure_windows`` (240-frame
             720p and 1080p clips, 200 live chunks, train() from a batch
             pool and from a DeepStab tree): every ``bench.WINDOW_KEYS``
             reading finite and > 0, each ``_n`` as
             ``bench.WINDOW_SAMPLES`` asks, q1 <= median <= q3, the live
             p90 at or above q3, each idle share in [0, 1] and each peak
             memory in (0, the card's]; its seconds and the headline
             (every reading under ``detail``).

Then the ``kernels`` line (with the launches of each parallel path at
world size 1: ``launches_dp_train``, ``launches_clip_sharded``,
``launches_spatial``, of the clip from the ``.pth``:
``launches_interop``, of the causal mode's first call:
``launches_causal``, of the recipe phase: ``launches_recipe``, and of
the benchmark suite: ``launches_bench``), the
card's name and power limit from
``nvidia-smi``, and ``{"ok": true, "device": {...}}`` as the last line.
Any failed check raises and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
HOLD_CYCLES = 2_000_000        # ~1 ms of SM clock: time_launches' stream hold
SEED = 0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def smooth_grid(torch, b, h, w, mag, gen, cells=(6, 10)):
    """identity + a coarse random flow upsampled to (h, w)."""
    from pwstablenet_tpu_torch.ops.warp import flow_to_grid, resize_flow

    coarse = (torch.rand(b, *cells, 2, device="cuda", generator=gen) - 0.5) * mag
    return flow_to_grid(resize_flow(coarse, h, w)).contiguous()


def time_launches(torch, fn, reps, flush):
    """Median ms of ``fn()`` over ``reps`` launches, each timed with CUDA
    events after a write of ``flush``.  The flush is larger than the
    50 MB L2, so the inputs come from device memory.  Before it, a spin
    kernel holds the stream for ~1 ms while the host enqueues the flush,
    the events and ``fn``, so the events time the device's work and none
    of the wrapper's host overhead, however slow the host."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profile_device(torch, fn, trace_dir=None):
    """Wall ms of ``fn()`` under ``torch.profiler``, the device's busy ms
    (device-side events only: the aten ops that launch kernels carry the
    same time again, and so do user annotations such as
    ``Optimizer.step#Adam.step`` on the device timeline) and the top
    device rows.  With ``trace_dir``, the profile is
    ``utils.profiling.trace``'s, which writes its Chrome trace there."""
    from torch.profiler import ProfilerActivity, profile

    from pwstablenet_tpu_torch.utils.profiling import trace
    from pwstablenet_tpu_torch.utils.timing import device_rows

    torch.cuda.synchronize()
    ctx = (trace(trace_dir) if trace_dir else
           profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True))
    with ctx as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    annotations = [[ev.key[:90], ev.self_device_time_total / 1e3, ev.count]
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total > 0
                   and getattr(ev, "is_user_annotation", False)]
    busy_ms = sum(ms for _, ms, _ in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if rows else None,
            "top_device_ms": [[k[:90], ms, c] for k, ms, c in rows[:12]],
            "annotations_not_counted_ms": annotations}


def surface(torch, np, st, clip, out, flows, work) -> None:
    """The user-facing surface on the card: the streaming loop behind
    ``stabilize_video`` (``_stream_to``), the warp-field archive and
    ``apply_warp_fields``, the exported chunk step, the CLI and
    ``stabilize_video`` on a video file.  ``st`` is the main path's
    ``Stabilizer``; ``out, flows`` its ``stabilize_frames(clip)``."""
    from types import SimpleNamespace

    from pwstablenet_tpu_torch import export as E
    from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig
    from pwstablenet_tpu_torch.data import native_io, video_io
    from pwstablenet_tpu_torch.data.warp_fields import WarpFieldWriter, load_warp_fields
    from pwstablenet_tpu_torch.kernels import grid_sample as K
    from pwstablenet_tpu_torch.pipeline import Stabilizer, apply_warp_fields

    def launched(fn):
        """(fn(), seconds, launches during it)"""
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0, dict(K.LAUNCHES)

    n_frames = clip.shape[0]
    both = ("grid_sample_f32", "grid_sample_packed_u8")

    # the streaming loop, chunks of 8 decoded frames in, into an
    # in-memory writer and a warp-field archive
    written = []
    wf_path = os.path.join(work, "fields.npz")

    def stream():
        with WarpFieldWriter(wf_path) as fw:
            return st._stream_to((clip[i : i + 8] for i in range(0, n_frames, 8)),
                                 SimpleNamespace(write=written.append), fw)

    count, secs, launches = launched(stream)
    streamed = np.concatenate(written)
    check(count == n_frames and np.array_equal(streamed, out),
          f"_stream_to: {count} frames, equal to stabilize_frames: "
          f"{np.array_equal(streamed, out)}")
    check(all(launches[k] > 0 for k in both), f"_stream_to launches {launches}")
    emit("surface_stream", frames=count, seconds=secs, frames_per_s=count / secs,
         launches=launches, frame_size=list(clip.shape[1:3]),
         batch_windows=st.pipeline_cfg.batch_windows, bitwise_equal_to_stabilize_frames=True)

    # the archive, re-applied to the same frames
    loaded = load_warp_fields(wf_path)
    check(np.array_equal(loaded, flows), "archive equals stabilize_frames' warp fields")
    redo, secs, launches = launched(lambda: apply_warp_fields(clip, loaded, st.model_cfg))
    check(np.array_equal(redo, streamed), "apply_warp_fields equals the streamed frames")
    check(launches["grid_sample_packed_u8"] > 0, f"apply_warp_fields launches {launches}")
    emit("surface_warp_fields", frames=int(loaded.shape[0]), fields=list(loaded.shape),
         archive_mb=os.path.getsize(wf_path) / 1e6, apply_seconds=secs, launches=launches,
         bitwise_equal_to_stream=True)

    # the exported chunk step: traced on the card, saved, loaded, run
    T = st.model_cfg.temporal_window
    n = st.pipeline_cfg.batch_windows
    frames_dev = torch.from_numpy(clip[: n + T - 1]).cuda()
    sd = st.model.state_dict()
    step_path = os.path.join(work, "step.pt2")
    t0 = time.perf_counter()
    program = E.export_chunk_step(st, clip.shape[1:3])
    export_s = time.perf_counter() - t0
    torch.export.save(program, step_path)
    save_s = time.perf_counter() - t0 - export_s
    t0 = time.perf_counter()
    step = E.ExportedStabilizerStep.load(step_path)
    load_s = time.perf_counter() - t0
    (e_out, e_flow), _, exp_launches = launched(lambda: step(sd, frames_dev))
    check(all(exp_launches[k] == 1 for k in both),
          f"the exported step's own call launched {exp_launches}")
    g_out, g_flow = st._chunk_step(frames_dev)
    check(torch.equal(e_out, g_out) and torch.equal(e_flow, g_flow),
          "exported step equals _chunk_step")
    ms = {"exported": [], "eager": []}
    for _ in range(6):  # in turns, after the warm calls above
        for name, fn in (("exported", lambda: step(sd, frames_dev)),
                         ("eager", lambda: st._chunk_step(frames_dev))):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms[name].append(a.elapsed_time(b))
    # device busy time of 3 chunks each: the same kernels, or host time
    busy = {}
    for name, fn in (("exported", lambda: step(sd, frames_dev)),
                     ("eager", lambda: st._chunk_step(frames_dev))):
        prof = profile_device(torch, lambda: [fn() for _ in range(3)])
        busy[name] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share")}
    # a program traced on the CPU (tiny model) runs the kernels on the card
    tiny = ModelConfig(temporal_window=3, num_levels=4, base_features=8, max_features=16,
                       model_resolution=(32, 32))
    cpu_st = Stabilizer(tiny, PipelineConfig(batch_windows=4), seed=SEED, device="cpu")
    with torch.no_grad():
        for s in range(tiny.num_stages):
            head = getattr(cpu_st.model, f"stage{s}").head
            head.weight.copy_(torch.randn(head.weight.shape,
                                          generator=torch.Generator().manual_seed(s)) * 1e-2)
    cpu_path = os.path.join(work, "cpu_traced.pt2")
    torch.export.save(E.export_chunk_step(cpu_st, (48, 64)), cpu_path)
    cpu_step = E.ExportedStabilizerStep.load(cpu_path)
    tiny_sd = cpu_st.model.state_dict()
    card_st = Stabilizer(tiny, PipelineConfig(batch_windows=4), state_dict=tiny_sd)
    tiny_frames = torch.from_numpy(clip[:6, :48, :64].copy()).cuda()
    (c_out, c_flow), _, cpu_launches = launched(lambda: cpu_step(tiny_sd, tiny_frames))
    c_ref = card_st._chunk_step(tiny_frames)
    check(all(cpu_launches[k] == 1 for k in both),
          f"the CPU-traced step on the card launched {cpu_launches}")
    check(torch.equal(c_out, c_ref[0]) and torch.equal(c_flow, c_ref[1]),
          "CPU-traced exported step on the card equals _chunk_step there")
    emit("surface_export", frame_size=list(clip.shape[1:3]), windows=n,
         export_seconds=export_s, save_seconds=save_s, load_seconds=load_s,
         artifact_mb=os.path.getsize(step_path) / 1e6,
         exported_chunk_ms=statistics.median(ms["exported"]),
         eager_chunk_ms=statistics.median(ms["eager"]), chunk_ms_each=ms,
         profile_3_chunks=busy,
         launches_in_exported_call=exp_launches, bitwise_equal_to_chunk_step=True,
         cpu_traced_tiny={"launches": cpu_launches, "bitwise_equal": True})

    # the command line, in process
    import contextlib
    import glob
    import io

    from pwstablenet_tpu_torch.cli.main import main as cli
    from pwstablenet_tpu_torch.utils.tb_writer import read_event_file

    def run_cli(argv):
        buf = io.StringIO()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        torch.cuda.synchronize()
        lines = buf.getvalue().strip().splitlines()
        check(rc == 0 and lines, f"cli {argv[0]}: rc {rc}, output {lines[-3:]}")
        return (json.loads(lines[-1]), lines, time.perf_counter() - t0, dict(K.LAUNCHES))

    cli_wf = os.path.join(work, "cli_fields.npz")
    line, _, secs, launches = run_cli(
        ["stabilize", "--synthetic", "--frames", "24", "--height", "720", "--width", "1280",
         "--warp-fields", cli_wf])
    check(line["frames"] == 24 and load_warp_fields(cli_wf).shape == (24, 256, 256, 2),
          f"cli stabilize: {line}")
    check(launches["grid_sample_f32"] > 0, f"cli stabilize launches {launches}")
    cli_stab = {"line": line, "seconds": secs, "launches": launches}
    line, _, secs, launches = run_cli(
        ["export", "--output", os.path.join(work, "cli_step.pt2")])
    check(line["frame_hw"] == [720, 1280], f"cli export: {line}")
    cli_export = {"line": line, "seconds": secs}
    tb_dir = os.path.join(work, "tb")
    scalars = os.path.join(work, "scalars.jsonl")
    line, lines, secs, launches = run_cli(
        ["train", "--synthetic", "--steps", "2", "--batch-size", "2", "--log-every", "1",
         "--temporal-window", "3", "--num-levels", "4", "--base-features", "8",
         "--max-features", "16", "--model-height", "32", "--model-width", "32",
         "--disc-layers", "2", "--checkpoint-dir", os.path.join(work, "ckpt"),
         "--tb-log-dir", tb_dir, "--scalar-log", scalars])
    (events_path,) = glob.glob(os.path.join(tb_dir, "events.out.tfevents.*"))
    events = read_event_file(events_path)
    tags = {k for e in events for k in e.get("scalars", {})}
    check({"loss_g", "loss_d"} <= tags and line["step"] == 2, f"cli train: {line}, {tags}")
    with open(scalars) as f:
        check(len(f.readlines()) == 2, "cli train: 2 scalar lines")
    check(launches["grid_sample_grad_f32"] == 6, f"cli train launches {launches}")
    cli_train = {"line": line, "seconds": secs, "launches": launches,
                 "tb_events": len(events), "tb_tags": sorted(tags)}
    # make-data, then train from that tree with the eval hook on one of
    # its unstable videos (a uint8 clip: the packed kernel)
    tree = os.path.join(work, "tree")
    line, _, secs, _ = run_cli(["make-data", "--out", tree, "--pairs", "2", "--frames", "12",
                                "--height", "48", "--width", "64", "--seed", str(SEED)])
    check(line["root"] == tree and len(os.listdir(os.path.join(tree, "unstable"))) == 2,
          f"cli make-data: {line}")
    cli_make = {"line": line, "seconds": secs}
    tiny_model = ["--temporal-window", "3", "--num-levels", "4", "--base-features", "8",
                  "--max-features", "16", "--model-height", "32", "--model-width", "32",
                  "--disc-layers", "2"]
    eval_clip = os.path.join(tree, "unstable", "01.avi")
    line, lines, secs, launches = run_cli(
        ["train", "--data-root", tree, "--steps", "2", "--batch-size", "2", "--log-every", "1",
         "--eval-every", "2", "--eval-clip", eval_clip, *tiny_model,
         "--checkpoint-dir", os.path.join(work, "ckpt_deepstab")])
    logged = [json.loads(ln) for ln in lines if ln.startswith("{")]
    check([m["step"] for m in logged if "loss_g" in m] == [1, 2]
          and [m["step"] for m in logged if "eval_stability" in m] == [2]
          and all(math.isfinite(v) for m in logged if "loss_g" in m for v in m.values()),
          f"cli train --data-root: {logged}")
    check(launches["grid_sample_grad_f32"] == 6 and launches["grid_sample_packed_u8"] > 0,
          f"cli train --data-root launches {launches}")
    cli_deepstab = {"line": line, "eval": [m for m in logged if "eval_stability" in m][0],
                    "seconds": secs, "launches": launches}
    # --eval-every without --eval-clip: the usage error, exit 2
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        try:
            code = cli(["train", "--data-root", tree, "--steps", "1", "--eval-every", "2",
                        *tiny_model])
        except SystemExit as e:
            code = e.code
    check(code == 2 and "needs BOTH --eval-every and --eval-clip" in err.getvalue(),
          f"cli train pairing check: exit {code}, {err.getvalue()[-300:]}")
    emit("surface_cli", stabilize=cli_stab, export=cli_export, train=cli_train,
         make_data=cli_make, train_data_root=cli_deepstab,
         eval_pairing_error={"exit": code, "stderr": err.getvalue().strip()})

    # stabilize_video on a video file: 24 lossless (FFV1) 720p frames
    src = os.path.join(work, "in.avi")
    video_io.write_video(src, clip, 30.0, codec="FFV1")
    # the decoder stabilize_video takes: native where the runtime builds
    # and loads (native_io.available()), else OpenCV's Python path
    try:
        native_io.load()
        native = {"available": True}
    except (OSError, RuntimeError) as e:
        native = {"available": False, "error": str(e)[-400:]}
    check(native_io.available() == native["available"], "native_io.available()")
    vst = Stabilizer(st.model_cfg, PipelineConfig(batch_windows=8, output_codec="FFV1"),
                     state_dict=sd)
    dst, vwf = os.path.join(work, "out.avi"), os.path.join(work, "out_fields.npz")
    res, secs, launches = launched(lambda: vst.stabilize_video(src, dst, warp_field_path=vwf))
    check(res["frames"] == n_frames and res["fps"] == 30.0, f"stabilize_video: {res}")
    decoded, _ = video_io.read_video(dst, dtype=np.uint8)
    check(np.array_equal(decoded, out) and np.array_equal(load_warp_fields(vwf), flows),
          "stabilize_video's file and archive equal stabilize_frames")
    check(all(launches[k] > 0 for k in both), f"stabilize_video launches {launches}")
    emit("surface_video", result=res, seconds=secs, frames_per_s=n_frames / secs,
         launches=launches, decoder="native" if native["available"] else "opencv",
         native_runtime=native, bitwise_equal_to_stabilize_frames=True)


def interop(torch, np, st, clip, out, flows, work) -> dict:
    """Checkpoint interop on the card, at the main path's full-width
    model: its weights to the reference's ``.pth`` layout and back (bit
    for bit), the 24-frame 720p clip stabilized from the ``.pth``
    (bitwise equal to the main path's frames and flows), the reference
    layout's own modules (``torch_ref``, ``F.grid_sample`` between the
    stages) against the port's f32 flows on one 256x256 stack (warp-map
    MSE <= 1e-3), and ``stabilize --checkpoint x.pth`` through the CLI.
    The JAX package's Orbax checkpoints need JAX to write, which this
    machine lacks: the CPU tests hold that reader.  Returns the kernel
    launches of the clip stabilized from the ``.pth``."""
    import contextlib
    import io

    import torch.nn.functional as F

    from pwstablenet_tpu_torch.cli.main import main as cli
    from pwstablenet_tpu_torch.config import PipelineConfig
    from pwstablenet_tpu_torch.interop import load_torch_checkpoint, port_to_torch_state_dict
    from pwstablenet_tpu_torch.interop.torch_ref import TorchCascadedGenerator
    from pwstablenet_tpu_torch.kernels import grid_sample as K
    from pwstablenet_tpu_torch.models.generator import CascadedGenerator
    from pwstablenet_tpu_torch.ops.pixels import to_unit
    from pwstablenet_tpu_torch.pipeline import Stabilizer

    t_phase = time.perf_counter()
    cfg = st.model_cfg
    sd = {k: v.detach().cpu() for k, v in st.model.state_dict().items()}
    pth = os.path.join(work, "ref.pth")
    t0 = time.perf_counter()
    torch.save(port_to_torch_state_dict(sd, cfg), pth)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_torch_checkpoint(pth, cfg)
    load_s = time.perf_counter() - t0
    check(list(loaded) == list(sd) and all(torch.equal(loaded[k], v) for k, v in sd.items()),
          ".pth round trip bit for bit")

    # the main path's clip, from the .pth
    pst = Stabilizer(cfg, PipelineConfig(batch_windows=8), state_dict=loaded)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    p_out, p_flows = pst.stabilize_frames(clip)
    torch.cuda.synchronize()
    stab_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    del pst
    check(np.array_equal(p_out, out) and np.array_equal(p_flows, flows),
          "the clip from the .pth equals the main path's, frames and flows")
    check(launches["grid_sample_f32"] > 0 and launches["grid_sample_packed_u8"] > 0,
          f"interop kernel launches {launches}")

    # the reference layout's modules against the port's f32 flows, on one
    # 256x256 stack of the clip's first frames (TF32 off)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w = cfg.model_resolution
    frames = to_unit(torch.from_numpy(clip[: cfg.temporal_window]).cuda()).permute(0, 3, 1, 2)
    small = F.interpolate(frames, size=(h, w), mode="bilinear", align_corners=False,
                          antialias=True)
    stack = small.reshape(1, -1, h, w)  # frame-major channels
    oracle = TorchCascadedGenerator(cfg).cuda().eval()
    oracle.load_state_dict(torch.load(pth, map_location="cuda", weights_only=True))
    port32 = CascadedGenerator(dataclasses.replace(cfg, compute_dtype="float32"))
    port32.load_state_dict(loaded)
    port32 = port32.cuda().eval()
    with torch.no_grad():
        ref_flows = [f.permute(0, 2, 3, 1) for f in oracle(stack)]
        our_flows = port32(stack.permute(0, 2, 3, 1).contiguous())
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    per_stage = [{"mse": float(((o - r) ** 2).mean()), "max_abs_diff": float((o - r).abs().max()),
                  "flow_abs_max": float(r.abs().max())}
                 for o, r in zip(our_flows, ref_flows)]
    del oracle, port32
    check(all(s_["mse"] <= 1e-3 for s_ in per_stage), f"oracle flows: {per_stage}")

    # the CLI, in process
    buf = io.StringIO()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(["stabilize", "--synthetic", "--frames", "24", "--height", "720",
                  "--width", "1280", "--checkpoint", pth])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = dict(K.LAUNCHES)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rc == 0 and line["frames"] == 24, f"cli stabilize --checkpoint x.pth: {rc} {line}")
    # the synthetic clip is float, so its output warp is the f32 kernel too
    check(cli_launches["grid_sample_f32"] > 0,
          f"cli stabilize --checkpoint x.pth launches {cli_launches}")
    emit("interop", pth_bytes=os.path.getsize(pth), save_seconds=save_s, load_seconds=load_s,
         round_trip_bitwise=True, stabilize_seconds=stab_s, launches=launches,
         bitwise_equal_to_main=True, oracle_f32=per_stage,
         cli={"line": line, "seconds": cli_s, "launches": cli_launches},
         orbax="cpu_tests_only", seconds=time.perf_counter() - t_phase)
    return launches


def train_deepstab(torch, np, cfg, tcfg, before, steps, synthetic) -> None:
    """``train()`` of the full model from video files on disk: a tree
    written by ``make-data`` (2 pairs of 40 MJPG frames of 360x640), read
    by ``DeepStabDataset`` with scale jitter and 4 decode threads.
    ``before`` holds the initial parameters (``train()`` starts from the
    same seed); ``synthetic`` the synthetic ``train`` phase's readings,
    printed beside these.  Also the loader alone, on the host, in
    batches/s at 1, 2 and 4 decode threads, and the pinned copy of one
    batch to the card."""
    import contextlib
    import io

    from pwstablenet_tpu_torch.cli.main import main as cli
    from pwstablenet_tpu_torch.config import DataConfig
    from pwstablenet_tpu_torch.data import video_io
    from pwstablenet_tpu_torch.data.deepstab import DeepStabDataset, batch_iterator
    from pwstablenet_tpu_torch.kernels import grid_sample as K
    from pwstablenet_tpu_torch.train.loop import batch_to_device, train

    with tempfile.TemporaryDirectory() as work:
        tree = os.path.join(work, "tree")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(["make-data", "--out", tree, "--pairs", "2", "--frames", "40",
                      "--height", "360", "--width", "640", "--seed", str(SEED)])
        make_s = time.perf_counter() - t0
        check(rc == 0, f"make-data exit {rc}")
        # the card's OpenCV must write and read MJPG
        for sub in ("stable", "unstable"):
            frames, _ = video_io.read_video(os.path.join(tree, sub, "00.avi"), dtype=np.uint8)
            check(frames.shape == (40, 360, 640, 3) and frames.std() > 1.0,
                  f"MJPG {sub}/00.avi read back as {frames.shape}")
        tree_mb = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(tree) for f in fs) / 1e6
        data_cfg = DataConfig(data_root=tree, resize_scale_range=(1.0, 1.25),
                              num_decode_threads=4)

        # the loader alone: 6 batches after a warm one, at each thread count
        loader, batch = {}, None
        for threads in (1, 2, 4):
            ds = DeepStabDataset(dataclasses.replace(data_cfg, num_decode_threads=threads),
                                 cfg.temporal_window)
            it = batch_iterator(ds, tcfg.batch_size, seed=SEED)
            next(it)
            t0 = time.perf_counter()
            for _ in range(6):
                batch = next(it)
            loader[str(threads)] = 6 / (time.perf_counter() - t0)
            it.close()
        n, (h, w) = tcfg.batch_size, cfg.model_resolution
        check(batch["stacks"].shape == (n, 2, h, w, 3 * cfg.temporal_window)
              and batch["stable"].shape == (n, 2, h, w, 3)
              and batch["stacks"].dtype == batch["stable"].dtype == np.uint8,
              f"loader batch {[(k, v.shape, v.dtype) for k, v in batch.items()]}")
        batch_mb = sum(v.nbytes for v in batch.values()) / 1e6
        h2d_ms = []
        for _ in range(5):  # what train() does with each batch: pin, copy
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch_to_device(batch, torch.device("cuda"))
            torch.cuda.synchronize()
            h2d_ms.append((time.perf_counter() - t0) * 1e3)

        logged = []
        it = batch_iterator(DeepStabDataset(data_cfg, cfg.temporal_window),
                            tcfg.batch_size, seed=SEED)
        with tempfile.TemporaryDirectory() as ckpt_dir:
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                state = train(cfg, dataclasses.replace(tcfg, checkpoint_dir=ckpt_dir), it,
                              max_steps=steps, log_fn=logged.append)
                torch.cuda.synchronize()
            finally:
                it.close()
            secs = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
    check(len(logged) == steps and state.step == steps, f"deepstab steps {state.step}")
    check(all(np.isfinite(v) for m in logged for v in m.values()), f"deepstab metrics {logged}")
    changed = {m: sum(not torch.equal(before[m][n_], p)
                      for n_, p in getattr(state, m).named_parameters())
               for m in ("g", "d")}
    check(changed["d"] == len(before["d"]) and changed["g"] > 0
          and not torch.equal(before["g"]["stage1.head.weight"], state.g.stage1.head.weight),
          f"deepstab parameters changed: {changed}")
    check(launches["grid_sample_grad_f32"] == 3 * steps and launches["grid_sample_f32"] > 0,
          f"deepstab kernel launches {launches}")
    emit("train_deepstab", steps=steps, seconds=secs,
         sec_per_step=[m["sec_per_step"] for m in logged], synthetic=synthetic,
         launches=launches, tensors_changed=changed, batch_size=tcfg.batch_size,
         make_data_seconds=make_s, make_data_line=json.loads(buf.getvalue().splitlines()[-1]),
         tree_mb=tree_mb, loader_batches_per_s_by_threads=loader, batch_mb=batch_mb,
         pinned_h2d_ms=statistics.median(h2d_ms), pinned_h2d_ms_each=h2d_ms,
         resize_scale_range=list(data_cfg.resize_scale_range),
         decode_threads=data_cfg.num_decode_threads, first=logged[0], last=logged[-1])


def train_debug_nans(torch, np, cfg, tcfg, step_fn, dev_batch, state) -> None:
    """``debug_nans`` on the card: ``train()`` of the full model on a
    float batch whose ``stable`` is NaN at step 1, then finite ones, with
    ``log_every`` 5 and ``checkpoint_every`` 1, must raise
    ``FloatingPointError`` at step 1 and leave no checkpoint.  Then ms a
    step (batch 8, each step synced) without and with the per-step check,
    5 steps at a time in turns, median of 10 each; the check alone after
    a step; its device busy time, and its bound: the bytes it reads once
    over the card's memory rate."""
    from pwstablenet_tpu_torch.data.synthetic import make_train_batch
    from pwstablenet_tpu_torch.train import checkpoint as ckpt
    from pwstablenet_tpu_torch.train import loop

    h, w = cfg.model_resolution
    batches = [make_train_batch(tcfg.batch_size, h, w, cfg.temporal_window,
                                seed=SEED + 20 + i, dtype=np.float32) for i in range(3)]
    batches[0]["stable"][:] = np.nan
    raised = None
    with tempfile.TemporaryDirectory() as work:
        ckpt_dir = os.path.join(work, "ckpt")
        ncfg = dataclasses.replace(tcfg, log_every=5, checkpoint_every=1, debug_nans=True,
                                   checkpoint_dir=ckpt_dir)
        t0 = time.perf_counter()
        try:
            loop.train(cfg, ncfg, iter(batches), max_steps=3, log_fn=lambda m: None)
        except FloatingPointError as e:
            raised = str(e)
        raise_s = time.perf_counter() - t0
        left = sorted(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else []
        latest = ckpt.latest_step(ckpt_dir)
    check(raised is not None and raised.startswith("non-finite metrics at step 1 "),
          f"debug_nans on the card: {raised!r}")
    check(left == [] and latest is None, f"debug_nans left checkpoints: {left}")

    def steps(checked):
        ms = []
        for i in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step_fn(state, dev_batch)
            if checked:
                loop._check_finite(state, m, i + 1)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return ms

    steps(True)  # warm the check's kernels
    runs = {"off": [], "on": []}
    for flag in ("off", "on", "on", "off"):
        runs[flag] += steps(flag == "on")
    off, on = statistics.median(runs["off"]), statistics.median(runs["on"])
    # the check alone after a step: it ends in its own sync
    m = step_fn(state, dev_batch)
    alone = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loop._check_finite(state, m, 0)
        alone.append((time.perf_counter() - t) * 1e3)
    prof = profile_device(torch, lambda: loop._check_finite(state, m, 0))
    # what the check must read once: every tensor it reduces
    checked = list(m.values()) + list(state.g.parameters()) + list(state.d.parameters())
    checked += [t for o in (state.g_opt, state.d_opt) for s in o.state.values()
                for k, t in s.items() if k.startswith("exp_avg")]
    if state.g_ema is not None:
        checked += list(state.g_ema.parameters())
    check_bytes = sum(t.numel() * t.element_size() for t in checked)
    emit("train_debug_nans", raised=raised[:120], raise_seconds=raise_s, checkpoints_left=left,
         batch_size=tcfg.batch_size, step_ms_off=off, step_ms_on=on, step_ms_diff=on - off,
         step_ms_off_each=runs["off"], step_ms_on_each=runs["on"],
         check_alone_ms=statistics.median(alone), check_alone_ms_each=alone,
         check_device_busy_ms=prof["device_busy_ms"], check_top_device_ms=prof["top_device_ms"],
         check_bytes=check_bytes, check_bound_ms=check_bytes / HBM_BYTES_PER_S * 1e3,
         card=nvidia_smi())


def adam_step_bound(t, b1=0.5, b2=0.999):
    """The most that Adam's update ``t`` can move one element, in units
    of the learning rate (``tests/test_torch_port_train.py``)."""
    w1 = [b1 ** (t - 1 - k) * (1 - b1) / (1 - b1**t) for k in range(t)]
    w2 = [b2 ** (t - 1 - k) * (1 - b2) / (1 - b2**t) for k in range(t)]
    return math.sqrt(sum(a * a / b for a, b in zip(w1, w2)))


def compare_states(torch, a, b, lr, steps):
    """|a - b| over G's and D's parameters: the max, and the share of
    elements within 1e-6 among those not fed into a norm (whose
    gradients are rounding noise); checked against the train
    tolerances of the card-vs-CPU phase."""
    from pwstablenet_tpu_torch.train.state import feeds_a_norm

    diffs, free = [], []
    for m in ("g", "d"):
        ref = dict(getattr(b, m).named_parameters())
        for n, p in getattr(a, m).named_parameters():
            d = (p.detach() - ref[n].detach()).abs().flatten().cpu()
            diffs.append(d)
            if not feeds_a_norm(n, ref):
                free.append(d)
    diff = float(torch.cat(diffs).max())
    share = float((torch.cat(free) <= 1e-6).double().mean())
    bound = 2 * lr * sum(adam_step_bound(t) for t in range(1, steps + 1)) * (1 + 1e-3)
    check(diff <= bound and share >= 0.999,
          f"data-parallel vs plain params: max {diff} (bound {bound}), share {share}")
    return {"param_max_abs_diff": diff, "param_share_within_1em6": share}


def metrics_rel(ma, mb):
    return {k: abs(float(ma[k]) - float(v)) / max(abs(float(v)), 1e-12) for k, v in mb.items()}


def compare_metrics(ma, mb):
    """Each metric's relative difference (rtol 1e-4)."""
    rel = metrics_rel(ma, mb)
    check(set(ma) == set(mb) and max(rel.values()) <= 1e-4,
          f"data-parallel vs plain metrics: {rel}")
    return rel


def compare_grads(torch, a, b):
    """|grad_a - grad_b| / |grad_b| over each of G's and D's gradients,
    as one vector each (rtol 1e-4)."""
    rel = {}
    for m in ("g", "d"):
        ga = torch.cat([p.grad.flatten() for p in getattr(a, m).parameters()])
        gb = torch.cat([p.grad.flatten() for p in getattr(b, m).parameters()])
        rel[m] = float((ga - gb).norm() / gb.norm())
    check(max(rel.values()) <= 1e-4, f"data-parallel vs plain gradients: {rel}")
    return rel


def spatial_inputs(torch, h=2160, w=3840):
    """One 4K uint8 frame and a smooth flow within the 120-row halo, made
    on the host from the seed (so every process makes the same)."""
    import torch.nn.functional as F

    from pwstablenet_tpu_torch.ops.warp import resize_flow

    gen = torch.Generator().manual_seed(SEED + 30)
    coarse = torch.rand(1, 3, 24, 40, generator=gen) * 255
    img = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    img = img.round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    # +-0.1 normalized = +-108 rows
    lf = (torch.rand(1, 6, 10, 2, generator=gen) - 0.5) * 0.2
    return img.cuda(), resize_flow(lf.cuda(), h, w).contiguous()


def spatial_case(torch, K, img, flow, mesh, mode):
    """This rank's band of ``spatial_sharded_warp`` against the same rows
    of the unsharded kernel: (max abs diff, launches of the sharded
    call)."""
    from pwstablenet_tpu_torch.ops.warp import flow_to_grid
    from pwstablenet_tpu_torch.parallel import spatial_sharded_warp

    ref = (K.grid_sample_packed_u8 if img.dtype == torch.uint8 else K.grid_sample_f32)(
        img, flow_to_grid(flow).contiguous(), mode)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    band = spatial_sharded_warp(img, flow, mesh, halo=120, padding_mode=mode)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    hs = img.shape[1] // mesh.size
    rows = ref[:, mesh.rank * hs : (mesh.rank + 1) * hs]
    check(band.shape == rows.shape and band.dtype == rows.dtype, f"band {band.shape}")
    return (band.float() - rows.float()).abs().max().item(), launches


def parallel_rank(rank: int, world: int, work: str) -> None:
    """One of the two gloo ranks on the one card (a spawned process):
    an f32 data-parallel step (rank 0 also holds it against the plain
    step on the whole batch), the clip-sharded Stabilizer at 720p (each
    rank against the plain one) and the row-sharded warp of a 4K frame
    (each rank's band against the unsharded kernel), uint8 and f32,
    border and reflection.  Writes ``rank<R>.json`` in ``work``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig, TrainConfig
    from pwstablenet_tpu_torch.data.synthetic import make_train_batch
    from pwstablenet_tpu_torch.kernels import grid_sample as K
    from pwstablenet_tpu_torch.parallel import (
        data_parallel_step, make_mesh, maybe_initialize_distributed, replicate_tree,
        shard_batch,
    )
    from pwstablenet_tpu_torch.pipeline import Stabilizer
    from pwstablenet_tpu_torch.train.loop import batch_to_device
    from pwstablenet_tpu_torch.train.state import create_train_state
    from pwstablenet_tpu_torch.train.step import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_initialize_distributed(f"file://{os.path.join(work, 'rendezvous')}",
                                 world_size=world, rank=rank, backend="gloo", timeout=600)
    mesh = make_mesh()
    cuda = torch.device("cuda")
    res = {"rank": rank, "mesh_size": mesh.size, "backend": "gloo",
           "gloo_on_one_card": True}

    # ---- the data-parallel train step, f32, batch 8 (4 a rank), from
    # the initial state (zero warp heads: G's gradient reaches the heads
    # alone).  D's learning rate is 0: Adam's first update moves each
    # parameter by +-lr in the sign of its gradient, so D's elements
    # whose gradient is within rounding of 0 land 2 lr apart between two
    # orders of the same sums, and G's loss and gradient against the
    # updated D move with them (grad_norm_g read up to 8.8e-5 apart on
    # the card with D's update on; with heads redrawn at 1e-3, 1.1e-4 to
    # 4.3e-4, and with D's update off 1.3 % of G's elements 2 lr apart).
    # D's gradient, its sync and its norm are still held.
    cfg = ModelConfig(compute_dtype="float32")
    tcfg = TrainConfig(batch_size=8, seed=SEED, lr_d=0.0)
    state = replicate_tree(create_train_state(cfg, tcfg, cuda), mesh)
    step = data_parallel_step(make_train_step(cfg, tcfg), mesh)
    batches = [make_train_batch(8, 256, 256, cfg.temporal_window, seed=SEED + 20 + i)
               for i in range(2)]
    step_ms, launches = [], None
    for i, batch in enumerate(batches):
        local = batch_to_device(shard_batch(batch, mesh), cuda)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        m = step(state, local)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = dict(K.LAUNCHES)
            if rank == 0:  # against the plain step on the whole batch
                ref = create_train_state(cfg, tcfg, cuda)
                m_ref = make_train_step(cfg, tcfg)(ref, batch_to_device(batch, cuda))
                rel = compare_metrics(m, m_ref)
                grads = compare_grads(torch, state, ref)
                # the card's own spread: the plain step once more
                again = create_train_state(cfg, tcfg, cuda)
                m_again = make_train_step(cfg, tcfg)(again, batch_to_device(batch, cuda))
                res["train_vs_plain"] = {"metrics_max_rel_diff": max(rel.values()),
                                         "metrics_rel": rel,
                                         "plain_vs_plain_metrics_rel": metrics_rel(m_again, m_ref),
                                         "grad_rel_diff": grads,
                                         **compare_states(torch, state, ref, tcfg.lr_g, 1)}
                del ref, m_ref, again, m_again
    check(launches["grid_sample_grad_f32"] == 3 and launches["grid_sample_f32"] > 0,
          f"rank {rank} data-parallel step launches {launches}")
    res["train"] = {"launches": launches, "step_ms_gloo": step_ms,
                    "loss_g": float(m["loss_g"])}
    del state, step

    # ---- clip-sharded Stabilizer, f32, 24 720p frames
    gen = torch.Generator().manual_seed(SEED + 5)
    coarse = torch.rand(24, 3, 12, 20, generator=gen) * 255
    clip = F.interpolate(coarse, size=(720, 1280), mode="bilinear", align_corners=False)
    clip = clip.round().to(torch.uint8).permute(0, 2, 3, 1).contiguous().numpy()
    plain = Stabilizer(cfg, PipelineConfig(batch_windows=8), seed=SEED)
    hgen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for s in range(cfg.num_stages):
            head = getattr(plain.model, f"stage{s}").head
            head.weight.copy_(torch.randn(head.weight.shape, generator=hgen) * 1e-3)
    sharded = Stabilizer(cfg, PipelineConfig(batch_windows=8),
                         state_dict=plain.model.state_dict(), mesh=mesh)
    ref_out, ref_flows = plain.stabilize_frames(clip)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out, flows = sharded.stabilize_frames(clip)
    secs = time.perf_counter() - t0
    stab_launches = dict(K.LAUNCHES)
    code = int(np.abs(out.astype(np.int32) - ref_out.astype(np.int32)).max())
    fdiff = float(np.abs(flows - ref_flows).max())
    check(out.shape == clip.shape and code <= 1 and fdiff <= 1e-3,
          f"rank {rank} clip-sharded vs plain: {code} codes, flows {fdiff}")
    check(stab_launches["grid_sample_f32"] > 0 and stab_launches["grid_sample_packed_u8"] > 0,
          f"rank {rank} clip-sharded launches {stab_launches}")
    res["stabilizer"] = {"frame_max_code_diff": code, "flow_max_abs_diff": fdiff,
                         "flow_abs_max": float(np.abs(ref_flows).max()),
                         "launches": stab_launches, "seconds_gloo": secs}
    del plain, sharded

    # ---- row-sharded warp of a 4K frame
    img, flow = spatial_inputs(torch)
    res["spatial"] = {}
    for dtype in ("uint8", "float32"):
        im = img if dtype == "uint8" else img.float() / 255.0
        for mode in ("border", "reflection"):
            err, sp_launches = spatial_case(torch, K, im, flow, mesh, mode)
            check(err <= (1 if dtype == "uint8" else 5e-5),
                  f"rank {rank} spatial {dtype}/{mode}: {err}")
            res["spatial"][f"{dtype}/{mode}"] = {"max_abs_err": err, "launches": sp_launches}
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def parallel(torch, np, cfg, sd, clip, out, flows) -> dict:
    """``parallel/`` on the card.  (a) World size 1 under NCCL, in this
    process: the data-parallel train step against ``make_train_step``
    (bf16, the full model, batch 8, 2 steps) and its ms against the plain
    step's in turns, the gradient sync alone, the clip-sharded
    ``Stabilizer`` at 720p against the main path's output, and the
    row-sharded warp of a 4K uint8 frame (halo 120) against the unsharded
    packed kernel.  (b) World size 2 on the one card under gloo (NCCL
    takes one rank per device), two spawned processes
    (``parallel_rank``).  Returns the launches of (a)'s three paths."""
    import multiprocessing
    import socket

    import torch.distributed as dist

    from pwstablenet_tpu_torch.config import PipelineConfig, TrainConfig
    from pwstablenet_tpu_torch.data.synthetic import make_train_batch
    from pwstablenet_tpu_torch.kernels import grid_sample as K
    from pwstablenet_tpu_torch.parallel import (
        GradSync, data_parallel_step, make_mesh, maybe_initialize_distributed,
        process_info, replicate_tree, shard_batch,
    )
    from pwstablenet_tpu_torch.pipeline import Stabilizer
    from pwstablenet_tpu_torch.train.loop import batch_to_device
    from pwstablenet_tpu_torch.train.state import create_train_state
    from pwstablenet_tpu_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    check(maybe_initialize_distributed(f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                                       backend="nccl", timeout=300), "NCCL init")
    mesh = make_mesh()
    cuda = torch.device("cuda")
    tcfg = TrainConfig(batch_size=8, seed=SEED)
    plain_state = create_train_state(cfg, tcfg, cuda)
    dp_state = replicate_tree(create_train_state(cfg, tcfg, cuda), mesh)
    plain_step = make_train_step(cfg, tcfg)
    dp_step = data_parallel_step(plain_step, mesh)
    batches = [batch_to_device(shard_batch(make_train_batch(
        8, 256, 256, cfg.temporal_window, seed=SEED + 10 + i), mesh), cuda) for i in range(2)]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    dp_metrics = [dp_step(dp_state, b) for b in batches]
    torch.cuda.synchronize()
    dp_launches = dict(K.LAUNCHES)
    plain_metrics = [plain_step(plain_state, b) for b in batches]
    check(dp_launches["grid_sample_grad_f32"] == 3 * len(batches)
          and dp_launches["grid_sample_f32"] > 0, f"data-parallel step launches {dp_launches}")
    rel = max(max(compare_metrics(a, b).values()) for a, b in zip(dp_metrics, plain_metrics))
    params = compare_states(torch, dp_state, plain_state, tcfg.lr_g, len(batches))
    # ms a step in turns, plain and data-parallel, and the sync alone
    ms = {"plain": [], "dp": []}
    for r in range(6):
        order = (("plain", plain_step, plain_state), ("dp", dp_step, dp_state))
        for name, fn, st_ in (order if r % 2 == 0 else order[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(st_, batches[0])
            b.record()
            b.synchronize()
            ms[name].append(a.elapsed_time(b))
    sync = GradSync(mesh)
    sync_ms = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sync(dp_state.g)
        sync(dp_state.d)
        b.record()
        b.synchronize()
        sync_ms.append(a.elapsed_time(b))
    grad_bytes = {m: sum(p.numel() * p.element_size() for p in getattr(dp_state, m).parameters())
                  for m in ("g", "d")}
    del plain_state, dp_state, batches, dp_metrics, plain_metrics

    # the clip-sharded Stabilizer at 720p against the main path's output
    st = Stabilizer(cfg, PipelineConfig(batch_windows=8), state_dict=sd, mesh=mesh)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    s_out, s_flows = st.stabilize_frames(clip)
    stab_s = time.perf_counter() - t0
    stab_launches = dict(K.LAUNCHES)
    code = int(np.abs(s_out.astype(np.int32) - out.astype(np.int32)).max())
    fdiff = float(np.abs(s_flows - flows).max())
    check(code <= 1 and fdiff <= 1e-3, f"clip-sharded vs plain: {code} codes, flows {fdiff}")
    check(stab_launches["grid_sample_f32"] > 0 and stab_launches["grid_sample_packed_u8"] > 0,
          f"clip-sharded launches {stab_launches}")
    del st

    # the row-sharded warp of one 4K uint8 frame
    img, flow = spatial_inputs(torch)
    sp_err, sp_launches = spatial_case(torch, K, img, flow, mesh, "border")
    check(sp_err <= 1, f"row-sharded warp vs unsharded kernel: {sp_err} codes")
    check(sp_launches["grid_sample_packed_u8"] == 1, f"row-sharded launches {sp_launches}")
    emit("parallel_nccl_world1", process_info=process_info(), backend=dist.get_backend(),
         train={"launches": dp_launches, "metrics_max_rel_diff": rel, **params,
                "dp_step_ms": statistics.median(ms["dp"]),
                "plain_step_ms": statistics.median(ms["plain"]), "step_ms_each": ms,
                "grad_sync_ms": statistics.median(sync_ms), "grad_sync_ms_each": sync_ms,
                "grad_bytes": grad_bytes, "compute_dtype": cfg.compute_dtype,
                "batch_size": tcfg.batch_size},
         stabilizer={"launches": stab_launches, "seconds": stab_s,
                     "frame_max_code_diff": code, "flow_max_abs_diff": fdiff,
                     "frames": list(s_out.shape)},
         spatial={"launches": sp_launches, "max_code_diff": sp_err, "frame": list(img.shape),
                  "halo": 120})
    dist.destroy_process_group()
    del img, flow

    # (b) two gloo ranks on the one card; the kernels are built already
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        procs = [ctx.Process(target=parallel_rank, args=(r, 2, work)) for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 420
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        check(codes == [0, 0], f"gloo ranks exited {codes}")
        ranks = []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    check("train_vs_plain" in ranks[0], "rank 0 compared the data-parallel step")
    emit("parallel_gloo_world2", seconds=time.perf_counter() - t0, ranks=ranks)
    emit("parallel", seconds=time.perf_counter() - t_phase)
    return {"dp_train": dp_launches, "clip_sharded": stab_launches, "spatial": sp_launches}


def bench_phase(torch) -> dict:
    """The benchmark suite through ``cli.main(["bench"])`` in process, its
    stdout captured: exit 0, one line, the JAX suite's metric, every key
    of ``bench.KEYS_OF_JAX_SUITE`` present and finite, the gates inside
    their limits, a training mesh of 1, every MFU in (0, 1], every
    kernel launched, and the wall-clock windows held as the module's
    docstring says.  Returns the launches."""
    import contextlib
    import io

    from pwstablenet_tpu_torch import bench
    from pwstablenet_tpu_torch.cli.main import main as cli
    from pwstablenet_tpu_torch.kernels import grid_sample as K

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    buf = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(["bench"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 1, f"bench: rc {rc}, stdout {lines[-3:]}")
    head = json.loads(lines[0])
    detail = head.get("detail", {})
    check(head.get("metric") == bench.METRIC and head.get("value", 0) > 0,
          f"bench headline {head}")
    bad = [k for k in bench.KEYS_OF_JAX_SUITE.values()
           if not isinstance(detail.get(k), (int, float)) or not math.isfinite(detail[k])]
    check(not bad, f"bench keys missing or not finite: {bad}")
    mse = max(detail[k] for k in ("f32_kernel_vs_plain_mse", "grad_kernel_vs_plain_mse",
                                  "f32_kernel_offlane_vs_plain_mse"))
    check(mse <= bench.MSE_GATE and detail["packed_kernel_max_code_diff"] <= bench.CODE_GATE,
          f"bench gates: MSE {mse}, codes {detail['packed_kernel_max_code_diff']}")
    check(detail["train_mesh_devices"] == 1, f"bench mesh {detail['train_mesh_devices']}")
    mfu = {k: detail[k] for k in ("mfu_720p", "mfu_generator", "train_mfu")}
    check(all(0 < v <= 1 for v in mfu.values()), f"bench MFU {mfu}")
    check(all(n > 0 for n in launches.values()), f"bench launches {launches}")
    # the wall-clock windows: every reading finite and > 0 with its count,
    # its quartiles around it, an idle share in [0, 1] and a peak memory
    # within the card's
    bad = [k for k in bench.WINDOW_KEYS
           if not isinstance(detail.get(k), (int, float)) or not math.isfinite(detail[k])
           or detail[k] <= 0]
    check(not bad, f"bench windows missing, not finite or not > 0: {bad}")
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    for key, n in bench.WINDOW_SAMPLES.items():
        check(detail[f"{key}_n"] == n, f"bench {key}: {detail[f'{key}_n']} samples, not {n}")
        check(detail[f"{key}_q1"] <= detail[key] <= detail[f"{key}_q3"],
              f"bench {key}: quartiles {detail[f'{key}_q1']}, {detail[f'{key}_q3']} "
              f"around {detail[key]}")
        idle, peak = detail.get(f"{key}_idle_share"), detail.get(f"{key}_peak_mem_gb")
        check(isinstance(idle, (int, float)) and 0 <= idle <= 1, f"bench {key} idle share {idle}")
        check(isinstance(peak, (int, float)) and 0 < peak <= total_gb,
              f"bench {key} peak memory {peak} GB of {total_gb:.1f}")
    p90 = detail.get("live_720p_chunk1_ms_p90")
    check(isinstance(p90, (int, float)) and p90 >= detail["live_720p_chunk1_ms_q3"],
          f"bench live p90 {p90}")
    emit("bench", seconds=secs, headline=head, launches=launches)
    return launches


def chunk_vs_cpu_f32(torch, np, cfg, sd, clip, n=2) -> dict:
    """One f32 chunk of ``n`` windows of ``clip`` (TF32 off) through
    ``Stabilizer(cfg)`` with weights ``sd`` on the card and on the CPU:
    flows MSE and max |diff| <= 1e-3, frames +-1 code (checked)."""
    from pwstablenet_tpu_torch.config import PipelineConfig
    from pwstablenet_tpu_torch.pipeline import Stabilizer

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    chunk = clip[: n + cfg.temporal_window - 1]
    gpu = Stabilizer(cfg32, PipelineConfig(batch_windows=n), state_dict=sd)
    cpu = Stabilizer(cfg32, PipelineConfig(batch_windows=n), state_dict=sd, device="cpu")
    g_out, g_flow = (t.cpu().numpy() for t in gpu._chunk_step(torch.from_numpy(chunk).cuda()))
    t0 = time.perf_counter()
    c_out, c_flow = (t.numpy() for t in cpu._chunk_step(torch.from_numpy(chunk)))
    cpu_s = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    mse = float(np.mean((g_flow - c_flow) ** 2))
    fdiff = float(np.abs(g_flow - c_flow).max())
    code = int(np.abs(g_out.astype(np.int32) - c_out.astype(np.int32)).max())
    check(mse <= 1e-3 and fdiff <= 1e-3, f"card vs CPU flows: mse {mse}, max {fdiff}")
    check(code <= 1, f"card vs CPU frames: {code} codes")
    return {"windows": n, "flow_mse": mse, "flow_max_abs_diff": fdiff,
            "flow_abs_max": float(np.abs(c_flow).max()), "frame_max_code_diff": code,
            "cpu_seconds": cpu_s}


def causal(torch, np, st, sd, clip) -> dict:
    """The causal (live) mode, ``temporal_center = temporal_window - 1``
    (no future frame in a window), with the weights ``sd`` of the main
    path's ``Stabilizer`` ``st``: ``stabilize_frames`` of the 24-frame
    720p clip (both forward kernels launched), one f32 chunk against the
    CPU's, ms per chunk (CUDA events, median of 10 warm chunks: the live
    mode's latency floor) in turns with ``st``'s centred chunk, the
    device time of each (``utils.device_time``) and frames/s (median of
    3 warm calls).  Returns the kernel launches of the first call."""
    from pwstablenet_tpu_torch.config import PipelineConfig
    from pwstablenet_tpu_torch.kernels import grid_sample as K
    from pwstablenet_tpu_torch.pipeline import Stabilizer
    from pwstablenet_tpu_torch.utils import device_time

    t_phase = time.perf_counter()
    cfg = st.model_cfg
    ccfg = dataclasses.replace(cfg, temporal_center=cfg.temporal_window - 1)
    causal_st = Stabilizer(ccfg, PipelineConfig(batch_windows=8), state_dict=sd)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out, flows = causal_st.stabilize_frames(clip)
    launches = dict(K.LAUNCHES)
    check(out.shape == clip.shape and out.dtype == np.uint8
          and flows.shape == (len(clip), *cfg.model_resolution, 2)
          and bool(np.isfinite(flows).all()), f"causal frames {out.shape}, flows {flows.shape}")
    check(launches["grid_sample_f32"] > 0 and launches["grid_sample_packed_u8"] > 0
          and launches["grid_sample_grad_f32"] == 0, f"causal kernel launches {launches}")
    parity = chunk_vs_cpu_f32(torch, np, ccfg, sd, clip)
    frames_dev = torch.from_numpy(clip[: 8 + cfg.temporal_window - 1]).cuda()
    chunk_ms = {"causal": [], "centred": []}
    for i in range(13):
        for key, stab in (("causal", causal_st), ("centred", st)):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            stab._chunk_step(frames_dev)
            b.record()
            b.synchronize()
            if i >= 3:
                chunk_ms[key].append(a.elapsed_time(b))
    run_ms = []
    for i in range(4):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        causal_st.stabilize_frames(clip)
        b.record()
        b.synchronize()
        if i >= 1:
            run_ms.append(a.elapsed_time(b))
    stab_ms = statistics.median(run_ms)
    emit("causal", temporal_center=ccfg.temporal_center, frames=list(out.shape),
         launches=launches, card_vs_cpu_f32=parity,
         chunk_ms=statistics.median(chunk_ms["causal"]), chunk_ms_each=chunk_ms["causal"],
         centred_chunk_ms_in_turns=statistics.median(chunk_ms["centred"]),
         chunk_device_time_ms=device_time(causal_st._chunk_step, (frames_dev,)) * 1e3,
         centred_chunk_device_time_ms=device_time(st._chunk_step, (frames_dev,)) * 1e3,
         chunk_windows=8,
         stabilize_frames_ms=stab_ms, frames_per_s=len(clip) / (stab_ms / 1e3),
         compute_dtype=ccfg.compute_dtype, seconds=time.perf_counter() - t_phase,
         nvidia_smi=nvidia_smi())
    return launches


# the recipe phase's cuts of train_rich_deepstab's settings (1000 steps,
# 12 pairs of 80 frames, log every 50, hook every 250, checkpoint every
# 500, a 48-frame EVAL clip): width, the hook clip and the
# hyperparameters stay as they are.  16 frames a pair (the loader needs
# 9 at temporal_window 7) and 16 EVAL frames, because the host renders
# a rich 320x448 frame in about a second and the clips render beside
# the tree: the 32-frame hook clip is then the longest
RECIPE_STEPS, RECIPE_PAIRS = 20, 2
RECIPE_CUTS = dict(frames=16, size=(320, 448), log_every=10, eval_every=10,
                   checkpoint_every=20, eval_frames=16)
# the hook and a fresh Stabilizer run the same weights on the same clip
# and card, so the best export scores the recorded value again exactly
# unless cuDNN picks another algorithm for the second Stabilizer
BEST_RELOAD_TOL = 1e-6


def recipe(torch, np) -> dict:
    """``examples.train_rich_deepstab.run`` on the card at the full model
    and the recipe's hyperparameters, cut to ``RECIPE_STEPS`` steps on
    ``RECIPE_PAIRS`` pairs (``RECIPE_CUTS``); the same hook clip (32
    rich frames of 320x448).  Checks: two finite hook readings,
    ``best_step.json`` holding the larger, the ``best`` export in a fresh
    ``Stabilizer`` scoring it again, ``EVAL[ema]`` and ``EVAL[best]``
    finite, every kernel launched.  Returns the kernel launches."""
    from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig
    from pwstablenet_tpu_torch.eval import stability_score
    from pwstablenet_tpu_torch.examples import train_rich_deepstab
    from pwstablenet_tpu_torch.kernels import grid_sample as K
    from pwstablenet_tpu_torch.pipeline import Stabilizer
    from pwstablenet_tpu_torch.train import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as work:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_rich_deepstab.run(steps=RECIPE_STEPS, pairs=RECIPE_PAIRS, work_dir=work,
                                      **RECIPE_CUTS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        sec_per_step = statistics.median(m["sec_per_step"] for m in res["log"])
        hooks = [h["eval_stability"] for h in res["hooks"]]
        check(len(hooks) == 2 and all(np.isfinite(v) for h in res["hooks"] for v in h.values()),
              f"recipe hook readings {res['hooks']}")
        best = res["best"]
        check(best["value"] == max(hooks)
              and best["step"] == res["hooks"][hooks.index(max(hooks))]["step"],
              f"recipe best {best} of {res['hooks']}")
        st = Stabilizer(ModelConfig(), PipelineConfig(batch_windows=8),
                        state_dict=ckpt.load_generator_state_dict(res["checkpoint_dir"],
                                                                  step="best"))
        out, _ = st.stabilize_frames(res["hook_clip"])
        again = stability_score(out.astype(np.float32) / 127.5 - 1.0)
    reload_diff = abs(again - best["value"])
    check(reload_diff <= BEST_RELOAD_TOL,
          f"best export rescored {again} against {best['value']} ({reload_diff})")
    check(all(np.isfinite(v) for rep in res["evals"].values() for v in rep.values()),
          f"recipe evals {res['evals']}")
    check(all(n > 0 for n in launches.values()), f"recipe kernel launches {launches}")
    emit("recipe", steps=RECIPE_STEPS, pairs=RECIPE_PAIRS, cuts=RECIPE_CUTS,
         seconds=seconds, seconds_by_part=res["seconds"],
         sec_per_step=[m["sec_per_step"] for m in res["log"]],
         sec_per_step_median=sec_per_step, steps_per_s=1.0 / sec_per_step,
         hooks=res["hooks"], best=best, best_reload=again, best_reload_diff=reload_diff,
         best_reload_tol=BEST_RELOAD_TOL, evals=res["evals"],
         gt_stable_ceiling=res["gt_stable_ceiling"], launches=launches,
         nvidia_smi=nvidia_smi())
    return launches


def main() -> int:
    import numpy as np
    import torch

    # ---- 1. device --------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig
    from pwstablenet_tpu_torch.kernels import _build
    from pwstablenet_tpu_torch.kernels import grid_sample as K
    from pwstablenet_tpu_torch.pipeline import Stabilizer

    smi = nvidia_smi()
    try:  # bfloat16 warp fields need it (PipelineConfig.warp_field_dtype)
        import ml_dtypes
        ml_dtypes_version = ml_dtypes.__version__
    except ImportError:
        ml_dtypes_version = None
    try:  # the Orbax checkpoint reader needs it (interop.from_orbax)
        import importlib.metadata

        import tensorstore  # noqa: F401
        tensorstore_version = importlib.metadata.version("tensorstore")
    except ImportError:
        tensorstore_version = None
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, ml_dtypes=ml_dtypes_version,
         tensorstore=tensorstore_version)

    # ---- 2. build ---------------------------------------------------
    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    ptxas = [ln.split("ptxas info    : ")[-1] for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=info["seconds"],
         library=info["path"].split("pwstablenet_tpu_torch/")[-1], ptxas=ptxas)

    # ---- 3. kernels against their plain versions --------------------
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    img = torch.rand(8, 256, 256, 3, device="cuda", generator=gen)
    grid = torch.rand(8, 256, 256, 2, device="cuda", generator=gen) * 2.4 - 1.2
    # the training path's shapes: 2 x batch 8 windows at 256x256
    gimg = torch.rand(16, 256, 256, 3, device="cuda", generator=gen)
    gcot = torch.randn(16, 256, 256, 3, device="cuda", generator=gen)
    ggrid = torch.rand(16, 256, 256, 2, device="cuda", generator=gen) * 2.4 - 1.2
    from pwstablenet_tpu_torch.ops.warp import identity_grid

    ident = identity_grid(256, 256, device="cuda")[None].expand(16, -1, -1, -1).contiguous()
    f32_cases = {}
    for mode in ("border", "zeros", "reflection"):
        for ac in (True, False):
            for key, im, gr in ((f"{mode}/ac={ac}", img, grid),
                                (f"{mode}/ac={ac}/train", gimg, ggrid),
                                (f"{mode}/ac={ac}/train/identity", gimg, ident)):
                out = K.grid_sample_f32(im, gr, mode, ac)
                ref = K.grid_sample_f32_plain(im, gr, mode, ac)
                f32_cases[key] = (out - ref).abs().max().item()
    # the bench phase's causal chunk1 and chunk4 inter-stage warps
    for n in (1, 4):
        out = K.grid_sample_f32(img[:n], grid[:n])
        ref = K.grid_sample_f32_plain(img[:n], grid[:n])
        f32_cases[f"({n},256,256)"] = (out - ref).abs().max().item()
    tall = torch.rand(2, 720, 1280, 3, device="cuda", generator=gen)
    tgrid = smooth_grid(torch, 2, 720, 1280, 0.1, gen)
    rows = 300.0 / (0.5 * (720 - 1))          # 300 rows, normalized
    sign = torch.where(torch.arange(1280, device="cuda") % 2 == 0, 1.0, -1.0)
    tgrid[..., 1] += rows * sign
    for mode in ("border", "zeros"):
        out = K.grid_sample_f32(tall, tgrid, mode)
        ref = K.grid_sample_f32_plain(tall, tgrid, mode)
        f32_cases[f"{mode}/+-300rows"] = (out - ref).abs().max().item()
    # the redesigned kernel's hazards: other channel counts (the generic
    # path), an odd row width (tap pairs and rows at both 8-byte
    # alignments), and a grid view 4 bytes off its storage's start
    # (scalar grid loads)
    def offset_4B(t):
        """a copy of f32 ``t`` in a view 4 bytes into its storage"""
        view = torch.empty(t.numel() + 1, device="cuda")[1:].view(t.shape)
        return view.copy_(t)

    odd_grid = torch.rand(2, 480, 853, 2, device="cuda", generator=gen) * 2.4 - 1.2
    offset_grid = offset_4B(grid)
    for mode in ("border", "zeros", "reflection"):
        for key, im, gr in (
                (f"{mode}/C=1", torch.rand(2, 256, 256, 1, device="cuda", generator=gen), grid[:2]),
                (f"{mode}/C=5", torch.rand(2, 256, 256, 5, device="cuda", generator=gen), grid[:2]),
                (f"{mode}/W=853", torch.rand(2, 480, 853, 3, device="cuda", generator=gen), odd_grid),
                (f"{mode}/grid_offset_4B", img, offset_grid)):
            out = K.grid_sample_f32(im, gr, mode)
            ref = K.grid_sample_f32_plain(im, gr, mode)
            f32_cases[key] = (out - ref).abs().max().item()
    torch.cuda.synchronize()
    f32_err = max(f32_cases.values())
    emit("kernel_f32", max_abs_err=f32_err, cases=f32_cases, atol=1e-5)
    check(f32_err <= 1e-5, f"grid_sample_f32 vs plain: {f32_cases}")

    u8 = torch.randint(0, 256, (8, 720, 1280, 3), dtype=torch.uint8,
                       device="cuda", generator=gen)
    ugrid = smooth_grid(torch, 8, 720, 1280, 0.2, gen)
    u8_cases = {}

    def u8_case(key, im, gr, mode="border", ac=True):
        out = K.grid_sample_packed_u8(im, gr, mode, ac)
        ref = K.grid_sample_packed_u8_plain(im, gr, mode, ac)
        d = (out.int() - ref.int()).abs()
        u8_cases[key] = {"max_code_diff": d.max().item(),
                         "share_differing": (d > 0).double().mean().item()}

    for mode in ("border", "reflection"):
        u8_case(mode, u8, ugrid, mode)
        u8_case(f"{mode}/ac=False", u8, ugrid, mode, False)
    # the grouped design's hazards: an odd row width (short head and tail
    # groups), 1080p, image views at odd byte offsets (word taps from
    # unaligned frames), an output size unlike the image's, large and
    # rough displacements
    u8_case("(2,480,853)", torch.randint(0, 256, (2, 480, 853, 3), dtype=torch.uint8,
                                         device="cuda", generator=gen),
            smooth_grid(torch, 2, 480, 853, 0.2, gen))
    u8_case("(2,1080,1920)", torch.randint(0, 256, (2, 1080, 1920, 3), dtype=torch.uint8,
                                           device="cuda", generator=gen),
            smooth_grid(torch, 2, 1080, 1920, 0.2, gen))
    # the recipe phase's frames (320x448): a hook or EVAL chunk of 8
    # windows and a short tail of 2
    for n in (8, 2):
        u8_case(f"({n},320,448)", torch.randint(0, 256, (n, 320, 448, 3), dtype=torch.uint8,
                                                device="cuda", generator=gen),
                smooth_grid(torch, n, 320, 448, 0.2, gen))
    # the bench phase's 30-frame 480x832 clip: chunks of 8 windows, the
    # last one padded to 8 by repeating its final frame
    clip = torch.randint(0, 256, (8, 480, 832, 3), dtype=torch.uint8,
                         device="cuda", generator=gen)
    cgrid = smooth_grid(torch, 8, 480, 832, 0.2, gen)
    u8_case("(8,480,832)", clip, cgrid)
    u8_case("(8,480,832)/tail", torch.cat([clip[:6], clip[5:6].expand(2, -1, -1, -1)]),
            torch.cat([cgrid[:6], cgrid[5:6].expand(2, -1, -1, -1)]))
    del clip, cgrid
    # the bench phase's 4K chunk of 16 windows: the kernel on the whole
    # chunk, its plain version a few frames at a time (its int64 taps at
    # 16 x 2160 x 3840 would take tens of GB)
    uhd = torch.randint(0, 256, (16, 2160, 3840, 3), dtype=torch.uint8,
                        device="cuda", generator=gen)
    uhd_grid = smooth_grid(torch, 16, 2160, 3840, 0.2, gen)
    out = K.grid_sample_packed_u8(uhd, uhd_grid)
    d = torch.cat([(out[i:i + 4].int() - K.grid_sample_packed_u8_plain(
        uhd[i:i + 4], uhd_grid[i:i + 4]).int()).abs() for i in range(0, 16, 4)])
    u8_cases["(16,2160,3840)"] = {"max_code_diff": d.max().item(),
                                  "share_differing": (d > 0).double().mean().item()}
    del uhd, uhd_grid, out, d
    torch.cuda.empty_cache()
    for k in (1, 2, 3):
        view = torch.empty(u8[:2].numel() + k, dtype=torch.uint8, device="cuda")[k:]
        view = view.view(u8[:2].shape)
        view.copy_(u8[:2])
        u8_case(f"image_offset_{k}B", view, ugrid[:2])
    u8_case("grid(2,360,640)/image(2,720,1280)", u8[:2], smooth_grid(torch, 2, 360, 640, 0.2, gen))
    far = smooth_grid(torch, 2, 720, 1280, 0.1, gen)
    far[..., 1] += (300.0 / (0.5 * (720 - 1))) * torch.where(
        torch.arange(1280, device="cuda") % 2 == 0, 1.0, -1.0)
    far[..., 0] += (600.0 / (0.5 * (1280 - 1))) * torch.where(
        torch.arange(720, device="cuda") % 2 == 0, 1.0, -1.0)[:, None]
    u8_case("+-300rows+-600cols", u8[:2], far)
    # a random, non-smooth grid over the whole frame (also timed below)
    urand = torch.rand(8, 720, 1280, 2, device="cuda", generator=gen) * 2.4 - 1.2
    u8_case("random", u8, urand)
    torch.cuda.synchronize()
    u8_err = max(c["max_code_diff"] for c in u8_cases.values())
    emit("kernel_packed_u8", max_abs_err=u8_err, cases=u8_cases, atol=1)
    check(u8_err <= 1, f"grid_sample_packed_u8 vs plain: {u8_cases}")

    grad_cases = {}

    def grad_case(key, im, gr, ct, mode, ac=True):
        out = K.grid_sample_grad_f32(im, gr, ct, mode, ac)
        ref = K.grid_sample_grad_f32_plain(im, gr, ct, mode, ac)
        excess = ((out - ref).abs() - 1e-4 * ref.abs()).max().item()
        grad_cases[key] = {"max_abs_err": (out - ref).abs().max().item(),
                           "max_excess_over_rtol": excess,
                           "ref_abs_max": ref.abs().max().item()}

    for mode in ("border", "zeros", "reflection"):
        for ac in (True, False):
            grad_case(f"{mode}/ac={ac}", gimg, ggrid, gcot, mode, ac)
            grad_case(f"{mode}/ac={ac}/identity", gimg, ident, gcot, mode, ac)
    tcot = torch.randn(2, 720, 1280, 3, device="cuda", generator=gen)
    for mode in ("border", "zeros"):
        grad_case(f"{mode}/+-300rows", tall, tgrid, tcot, mode)
    # the redesigned kernel's hazards: other channel counts (the generic
    # path), an odd row width (tap pairs and cotangents at both 8-byte
    # alignments), an output size unlike the image's, and grid and
    # cotangent views 4 bytes off their storage's start (scalar grid
    # loads, the cotangent's float before its float2)
    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    half_grid = smooth_grid(torch, 2, 360, 640, 0.2, gen)
    offset_cot = offset_4B(gcot[:8])
    for mode in ("border", "zeros", "reflection"):
        for c in (1, 5):
            grad_case(f"{mode}/C={c}", torch.rand(2, 256, 256, c, device="cuda", generator=gen),
                      ggrid[:2], randn(2, 256, 256, c), mode)
        grad_case(f"{mode}/W=853", torch.rand(2, 480, 853, 3, device="cuda", generator=gen),
                  odd_grid, randn(2, 480, 853, 3), mode)
        grad_case(f"{mode}/grid(2,360,640)/image(2,720,1280)", tall, half_grid,
                  randn(2, 360, 640, 3), mode)
        grad_case(f"{mode}/grid_offset_4B", img, offset_grid, gcot[:8], mode)
        grad_case(f"{mode}/cot_offset_4B", img, grid, offset_cot, mode)
        grad_case(f"{mode}/grid+cot_offset_4B", img, offset_grid, offset_cot, mode)
    torch.cuda.synchronize()
    grad_err = max(c["max_abs_err"] for c in grad_cases.values())
    emit("kernel_grad", max_abs_err=grad_err, cases=grad_cases, atol=2e-4, rtol=1e-4)
    check(all(c["max_excess_over_rtol"] <= 2e-4 for c in grad_cases.values()),
          f"grid_sample_grad_f32 vs plain: {grad_cases}")

    # ---- 4. main path ----------------------------------------------
    cfg = ModelConfig()
    st = Stabilizer(cfg, PipelineConfig(batch_windows=8), seed=SEED)
    hgen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        # the heads are zero-initialised (identity warp); small nonzero
        # heads make the warps real
        for s in range(cfg.num_stages):
            head = getattr(st.model, f"stage{s}").head
            head.weight.copy_(torch.randn(head.weight.shape, generator=hgen) * 1e-3)
    n_frames, fh, fw = 24, 720, 1280
    coarse = torch.rand(n_frames, 3, 12, 20, device="cuda", generator=gen) * 255
    clip = F.interpolate(coarse, size=(fh, fw), mode="bicubic", align_corners=False)
    clip = clip.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    clip = clip.contiguous().cpu().numpy()

    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out, flows = st.stabilize_frames(clip)
    main_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    check(out.shape == clip.shape and out.dtype == np.uint8, f"frames {out.shape} {out.dtype}")
    check(flows.shape == (n_frames, 256, 256, 2) and flows.dtype == np.float32,
          f"flows {flows.shape} {flows.dtype}")
    check(bool(np.isfinite(flows).all()), "flows finite")
    flow_max = float(np.abs(flows).max())
    check(flow_max > 1e-4, f"flows nonzero ({flow_max})")
    changed = float((out != clip).mean())
    check(changed > 0.01, f"warp changed the frames ({changed})")
    # the inference path runs the two forward kernels, not the gradient
    check(launches["grid_sample_f32"] > 0 and launches["grid_sample_packed_u8"] > 0
          and launches["grid_sample_grad_f32"] == 0, f"kernel launches {launches}")
    emit("main", frames=list(out.shape), flows=list(flows.shape), seconds=main_s,
         launches=launches, flow_abs_max=flow_max, share_pixels_changed=changed)

    # one f32 chunk on the card and on the CPU, same weights, TF32 off
    sd = {k: v.cpu() for k, v in st.model.state_dict().items()}
    emit("card_vs_cpu_f32", **chunk_vs_cpu_f32(torch, np, cfg, sd, clip))

    # ---- 5. inference timings --------------------------------------
    frames_dev = torch.from_numpy(clip[: 8 + cfg.temporal_window - 1]).cuda()
    chunk_ms = []
    for i in range(13):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st._chunk_step(frames_dev)
        b.record()
        b.synchronize()
        if i >= 3:
            chunk_ms.append(a.elapsed_time(b))
    run_ms = []
    for i in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st.stabilize_frames(clip)
        b.record()
        b.synchronize()
        if i >= 1:
            run_ms.append(a.elapsed_time(b))
    stab_ms = statistics.median(run_ms)
    # utils.timing.device_time: the device-side events of 10 traced calls
    # (no L2 flush between them), beside the CUDA-event times
    from pwstablenet_tpu_torch.utils import device_time

    dgen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    d_img = torch.rand(8, 256, 256, 3, device="cuda", generator=dgen)
    d_grid = smooth_grid(torch, 8, 256, 256, 0.2, dgen)
    emit("timing", chunk_ms=statistics.median(chunk_ms), chunk_windows=8,
         stabilize_frames_ms=stab_ms, frames=n_frames,
         frames_per_s=n_frames / (stab_ms / 1e3), compute_dtype=cfg.compute_dtype,
         frame_size=[fh, fw],
         chunk_device_time_ms=device_time(st._chunk_step, (frames_dev,)) * 1e3,
         grid_sample_f32_device_time_ms=device_time(K.grid_sample_f32, (d_img, d_grid)) * 1e3,
         grid_sample_f32_device_time_shape=list(d_img.shape))
    del d_img, d_grid

    # device busy share of stabilize_frames, and device time by kernel
    emit("profile", **profile_device(torch, lambda: st.stabilize_frames(clip)))

    # ---- the user-facing surface -------------------------------------
    with tempfile.TemporaryDirectory() as work:
        surface(torch, np, st, clip, out, flows, work)
    # ---- checkpoint interop ------------------------------------------
    with tempfile.TemporaryDirectory() as work:
        interop_launches = interop(torch, np, st, clip, out, flows, work)
    # ---- the causal (live) mode --------------------------------------
    causal_launches = causal(torch, np, st, sd, clip)
    del st

    # ---- 6. training path --------------------------------------------
    from pwstablenet_tpu_torch.config import TrainConfig
    from pwstablenet_tpu_torch.data.synthetic import make_train_batch
    from pwstablenet_tpu_torch.train.loop import (
        batch_to_device, synthetic_batch_iterator, train,
    )
    from pwstablenet_tpu_torch.train.state import create_train_state, feeds_a_norm
    from pwstablenet_tpu_torch.train.step import make_train_step

    train_steps = 5
    tcfg = TrainConfig(batch_size=8, log_every=1, seed=SEED)
    init = create_train_state(cfg, tcfg, "cuda")
    before = {m: {n: p.detach().clone() for n, p in getattr(init, m).named_parameters()}
              for m in ("g", "d")}
    del init
    logged = []
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = dataclasses.replace(tcfg, checkpoint_dir=ckpt_dir)
        batches = synthetic_batch_iterator(cfg, tcfg, seed=SEED)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        tstate = train(cfg, tcfg, batches, max_steps=train_steps, log_fn=logged.append)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = dict(K.LAUNCHES)
        batches.close()  # stop the batch-making thread
    check(len(logged) == train_steps and tstate.step == train_steps, f"steps {tstate.step}")
    check(all(np.isfinite(v) for m in logged for v in m.values()), f"metrics {logged}")
    changed = {m: sum(not torch.equal(before[m][n], p)
                      for n, p in getattr(tstate, m).named_parameters())
               for m in ("g", "d")}
    check(changed["d"] == len(before["d"]) and changed["g"] > 0
          and not torch.equal(before["g"]["stage1.head.weight"], tstate.g.stage1.head.weight),
          f"parameters changed: {changed}")
    check(train_launches["grid_sample_grad_f32"] == 3 * train_steps
          and train_launches["grid_sample_f32"] > 0
          and train_launches["grid_sample_packed_u8"] == 0,
          f"train kernel launches {train_launches}")
    emit("train", steps=train_steps, seconds=train_s, launches=train_launches,
         tensors_changed=changed, n_tensors={"g": len(dict(tstate.g.named_parameters())),
                                             "d": len(dict(tstate.d.named_parameters()))},
         batch_size=tcfg.batch_size, compute_dtype=cfg.compute_dtype,
         first=logged[0], last=logged[-1])
    train_deepstab(torch, np, cfg, tcfg, before, train_steps,
                   {"seconds": train_s, "sec_per_step": [m["sec_per_step"] for m in logged]})
    del before

    # one f32 step (TF32 off) at a tiny config on the card and on the
    # CPU, from one state and batch
    tiny = ModelConfig(temporal_window=3, num_levels=4, base_features=8, max_features=16,
                       model_resolution=(32, 32), num_stages=2, disc_num_layers=2,
                       feat_channels=(8, 16), compute_dtype="float32")
    ttcfg = TrainConfig(batch_size=2, num_epochs=1, steps_per_epoch=10)
    tiny_batch = make_train_batch(2, 32, 32, tiny.temporal_window, seed=3)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pair = {}
    for dev in ("cpu", "cuda"):
        st_ = create_train_state(tiny, ttcfg, dev)
        hgen = torch.Generator().manual_seed(SEED + 2)
        with torch.no_grad():  # nonzero heads: grids off the identity
            for s_ in range(tiny.num_stages):
                head = getattr(st_.g, f"stage{s_}").head
                head.weight.copy_(torch.randn(head.weight.shape, generator=hgen) * 1e-2)
        m_ = make_train_step(tiny, ttcfg)(st_, batch_to_device(tiny_batch, torch.device(dev)))
        pair[dev] = (st_, {k: float(v) for k, v in m_.items()})
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    rel = {k: abs(pair["cuda"][1][k] - v) / max(abs(v), 1e-12) for k, v in pair["cpu"][1].items()}
    diffs, free = [], []
    for m in ("g", "d"):
        c_sd = dict(getattr(pair["cpu"][0], m).named_parameters())
        for n, p in getattr(pair["cuda"][0], m).named_parameters():
            d_ = (p.detach().cpu() - c_sd[n].detach()).abs().flatten()
            diffs.append(d_)
            if not feeds_a_norm(n, c_sd):
                free.append(d_)
    pdiff = torch.cat(diffs)
    share = float((torch.cat(free) <= 1e-6).double().mean())
    emit("card_vs_cpu_train_f32", metrics_max_rel_diff=max(rel.values()), metrics_rel=rel,
         param_max_abs_diff=float(pdiff.max()), param_share_within_1em6=share)
    check(max(rel.values()) <= 1e-4, f"card vs CPU train metrics: {rel}")
    check(float(pdiff.max()) <= 2 * ttcfg.lr_g * (1 + 1e-3) and share >= 0.999,
          f"card vs CPU train params: max {float(pdiff.max())}, share {share}")
    del pair

    # ---- 7. training timings ----------------------------------------
    # ms per full-width train step on one device batch
    step_fn = make_train_step(cfg, tcfg)
    dev_batch = batch_to_device(
        make_train_batch(tcfg.batch_size, 256, 256, cfg.temporal_window, seed=SEED + 7),
        torch.device("cuda"))
    for _ in range(2):
        step_fn(tstate, dev_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step_fn(tstate, dev_batch)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms)
    windows = 2 * tcfg.batch_size
    emit("train_timing", step_ms=med, step_ms_each=step_ms, steps_per_s=1e3 / med,
         windows_per_step=windows, windows_per_s=windows * 1e3 / med,
         peak_memory_gb=peak / 1e9, compute_dtype=cfg.compute_dtype,
         model_resolution=list(cfg.model_resolution))
    train_debug_nans(torch, np, cfg, tcfg, step_fn, dev_batch, tstate)
    with tempfile.TemporaryDirectory() as trace_dir:
        prof = profile_device(torch, lambda: [step_fn(tstate, dev_batch) for _ in range(3)],
                              trace_dir=trace_dir)
        (trace_file,) = os.listdir(trace_dir)
        trace_path = os.path.join(trace_dir, trace_file)
        with open(trace_path) as f:
            trace_events = len(json.load(f)["traceEvents"])
        emit("train_profile", steps=3, **prof, trace_file_bytes=os.path.getsize(trace_path),
             trace_events=trace_events)
    del tstate, step_fn, dev_batch
    # ---- the rich training recipe, cut -------------------------------
    recipe_launches = recipe(torch, np)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    # the inter-stage warp's data: identity plus a smooth flow
    sgrid = smooth_grid(torch, 8, 256, 256, 0.2, gen)
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    # the loss warps' data: identity plus a smooth flow, at (16,256,256,3)
    sgrid16 = smooth_grid(torch, 16, 256, 256, 0.2, gen)
    gimg_nchw = gimg.permute(0, 3, 1, 2).contiguous()
    gcot_nchw = gcot.permute(0, 3, 1, 2).contiguous()
    # floor_ms: each kernel on a (1,8,8,3) frame, the fixed cost of a
    # launch, its ramp and its tail; random_grid_ms: each kernel on its
    # random check grid, the price of gathers that do not coalesce
    fimg = torch.rand(1, 8, 8, 3, device="cuda", generator=gen)
    fu8 = torch.randint(0, 256, (1, 8, 8, 3), dtype=torch.uint8, device="cuda", generator=gen)
    fgrid = smooth_grid(torch, 1, 8, 8, 0.2, gen)
    k1 = {
        "floor_ms": time_launches(torch, lambda: K.grid_sample_f32(fimg, fgrid), 50, flush),
        "random_grid_ms": time_launches(torch, lambda: K.grid_sample_f32(img, grid), 50, flush),
        "ms": time_launches(torch, lambda: K.grid_sample_f32(img, sgrid), 50, flush),
        "plain_ms": time_launches(torch, lambda: K.grid_sample_f32_plain(img, sgrid), 10, flush),
        "library_ms": time_launches(torch, lambda: F.grid_sample(
            img_nchw, sgrid, "bilinear", "border", True), 50, flush),
        # the training path's launches run at (16,256,256,3)
        "train_ms": time_launches(torch, lambda: K.grid_sample_f32(gimg, sgrid16), 50, flush),
        "train_plain_ms": time_launches(
            torch, lambda: K.grid_sample_f32_plain(gimg, sgrid16), 10, flush),
        "train_library_ms": time_launches(torch, lambda: F.grid_sample(
            gimg_nchw, sgrid16, "bilinear", "border", True), 50, flush),
    }
    k2 = {
        "floor_ms": time_launches(torch, lambda: K.grid_sample_packed_u8(fu8, fgrid), 50, flush),
        "random_grid_ms": time_launches(
            torch, lambda: K.grid_sample_packed_u8(u8, urand), 50, flush),
        "ms": time_launches(torch, lambda: K.grid_sample_packed_u8(u8, ugrid), 50, flush),
        "plain_ms": time_launches(torch, lambda: K.grid_sample_packed_u8_plain(u8, ugrid), 5, flush),
        "library_ms": None,
    }
    fcot = torch.randn(1, 8, 8, 3, device="cuda", generator=gen)
    k3 = {
        "floor_ms": time_launches(
            torch, lambda: K.grid_sample_grad_f32(fimg, fgrid, fcot), 50, flush),
        "random_grid_ms": time_launches(
            torch, lambda: K.grid_sample_grad_f32(gimg, ggrid, gcot), 50, flush),
        "ms": time_launches(torch, lambda: K.grid_sample_grad_f32(gimg, sgrid16, gcot), 50, flush),
        "plain_ms": time_launches(
            torch, lambda: K.grid_sample_grad_f32_plain(gimg, sgrid16, gcot), 5, flush),
        # a yardstick only: its tie semantics differ, and the port never calls it
        "library_ms": time_launches(torch, lambda: torch.ops.aten.grid_sampler_2d_backward(
            gcot_nchw, gimg_nchw, sgrid16, 0, 1, True, [False, True]), 50, flush),
    }

    def bound(nbytes, nflops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nflops / F32_FLOPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    px1 = img.shape[0] * img.shape[1] * img.shape[2]
    # per pixel: read grid (8 B) and 4 taps of C f32, write C f32; ~20
    # flops of coordinates and weights plus 7 per channel
    b1, by1 = bound(px1 * (8 + 3 * 4 + 3 * 4), px1 * (20 + 7 * 3))
    px1t = gimg.shape[0] * gimg.shape[1] * gimg.shape[2]
    b1t, _ = bound(px1t * (8 + 3 * 4 + 3 * 4), px1t * (20 + 7 * 3))
    px2 = u8.shape[0] * u8.shape[1] * u8.shape[2]
    b2, by2 = bound(px2 * (8 + 3 + 3), px2 * (20 + 9 * 3))
    px3 = gimg.shape[0] * gimg.shape[1] * gimg.shape[2]
    # per pixel: read grid (8 B), 4 taps and the cotangent of C f32,
    # write 2 f32; ~25 flops of coordinates and scales plus 14 per channel
    b3, by3 = bound(px3 * (8 + 3 * 4 + 3 * 4 + 8), px3 * (25 + 14 * 3))
    # ---- 8. parallel/ ------------------------------------------------
    par = parallel(torch, np, cfg, sd, clip, out, flows)
    # ---- 9. the benchmark suite --------------------------------------
    del flush
    bench_launches = bench_phase(torch)

    kernels = [
        {"name": "grid_sample_f32", "route": "cuda",
         "source": "pwstablenet_tpu_torch/csrc/grid_sample.cu",
         "replaces": "pwstablenet_tpu/kernels/grid_sample_pallas.py:614 (grid_sample_pallas)",
         "launches": launches["grid_sample_f32"],
         "launches_train": train_launches["grid_sample_f32"],
         **{f"launches_{path}": n["grid_sample_f32"] for path, n in par.items()},
         "launches_interop": interop_launches["grid_sample_f32"],
         "launches_causal": causal_launches["grid_sample_f32"],
         "launches_recipe": recipe_launches["grid_sample_f32"],
         "launches_bench": bench_launches["grid_sample_f32"],
         "max_abs_err": f32_err,
         "ms": k1["ms"], "kernel_ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": b1, "bound_by": by1, "library_ms": k1["library_ms"],
         "floor_ms": k1["floor_ms"], "random_grid_ms": k1["random_grid_ms"],
         "shape": list(img.shape),
         "train_shape": list(gimg.shape), "train_ms": k1["train_ms"],
         "train_plain_ms": k1["train_plain_ms"], "train_bound_ms": b1t,
         "train_library_ms": k1["train_library_ms"]},
        {"name": "grid_sample_packed_u8", "route": "cuda",
         "source": "pwstablenet_tpu_torch/csrc/grid_sample.cu",
         "replaces": "pwstablenet_tpu/kernels/grid_sample_pallas.py:714 (grid_sample_pallas_packed)",
         "launches": launches["grid_sample_packed_u8"],
         **{f"launches_{path}": n["grid_sample_packed_u8"] for path, n in par.items()},
         "launches_interop": interop_launches["grid_sample_packed_u8"],
         "launches_causal": causal_launches["grid_sample_packed_u8"],
         "launches_recipe": recipe_launches["grid_sample_packed_u8"],
         "launches_bench": bench_launches["grid_sample_packed_u8"],
         "max_abs_err": u8_err,
         "ms": k2["ms"], "kernel_ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": b2, "bound_by": by2, "library_ms": k2["library_ms"],
         "floor_ms": k2["floor_ms"], "random_grid_ms": k2["random_grid_ms"],
         "shape": list(u8.shape)},
        {"name": "grid_sample_grad_f32", "route": "cuda",
         "source": "pwstablenet_tpu_torch/csrc/grid_sample.cu",
         "replaces": "pwstablenet_tpu/kernels/grid_sample_pallas.py:805 (grid_sample_grad_pallas)",
         "launches": train_launches["grid_sample_grad_f32"],
         "launches_per_train_step": train_launches["grid_sample_grad_f32"] / train_steps,
         **{f"launches_{path}": n["grid_sample_grad_f32"] for path, n in par.items()},
         "launches_recipe": recipe_launches["grid_sample_grad_f32"],
         "launches_bench": bench_launches["grid_sample_grad_f32"],
         "max_abs_err": grad_err,
         "ms": k3["ms"], "kernel_ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": b3, "bound_by": by3, "library_ms": k3["library_ms"],
         "floor_ms": k3["floor_ms"], "random_grid_ms": k3["random_grid_ms"],
         "shape": list(gimg.shape)},
    ]
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
