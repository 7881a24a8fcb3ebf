"""The benchmark suite on the card: the JAX package's ``bench.py``
(``BASELINE.json`` configs 2-5) measured through the port's own calls.

    python -m pwstablenet_tpu_torch.bench
    python -m pwstablenet_tpu_torch.cli bench

Prints ONE JSON line to stdout::

    {"metric": "720p stabilized frames/sec/chip", "value": N,
     "unit": "frames/sec/chip", "vs_baseline": N/200, "detail": {...}}

``value`` is the 720p device path at 16 windows a chunk; ``vs_baseline``
divides it by 200 frames/s, the target that ``BASELINE.json`` sets (not
a reading); ``detail`` holds every reading, rounded to 4 places, under
the keys of ``KEYS_OF_JAX_SUITE`` and then of ``WINDOW_KEYS``.
Everything else goes to stderr.  The suite runs on the card only:
without CUDA it returns 1 and prints no headline.  It takes no flags.

First the parity gates: each CUDA kernel of ``kernels.grid_sample``
against its plain version on the card (MSE <= 1e-6; the packed uint8
kernel within 1 code).  If one fails, the suite prints the error line
(``value`` 0.0, ``"error": "kernel parity failure"``) and returns 1.
Then ``measure`` runs the configurations, at the JAX suite's shapes,
and ``measure_windows`` times the port's four user paths end to end:
wall-clock windows that end on the host or in a synchronize, many of
them, each reading a median with its quartiles and sample count.

Where the readings differ from the JAX suite's:

- ``device_time`` (``utils.timing``) sums every device event of the
  traced calls, since an eager call is many kernels; the JAX one takes
  the largest compiled module's total on the device track.  An 8- and
  a 16-window chunk therefore read differently on the two backends.
- Flops come from ``torch.utils.flop_counter.FlopCounterMode`` over one
  call, outside the timed region.  It counts convolutions and matrix
  products only; XLA's cost model also counts elementwise work, so the
  two MFUs are different readings.  Neither counter sees the grid-sample
  kernels, so both add their analytic tap flops (``_warp_flops``) once:
  the output warp of a chunk, and the loss warps of a train step with
  their backward.  The generator's inter-stage warp is left out, as in
  the JAX suite (under 0.1 % of a chunk's count).
- MFU divides by this card's bf16 dense peak (``BF16_DENSE_PEAK_FLOPS``,
  keyed on ``torch.cuda.get_device_name()``); on a card the table lacks
  the suite says so and writes no ``mfu_*`` or ``train_mfu`` key.
- With no process group the training mesh has world size 1, and
  ``data_parallel_step`` returns the plain step; a data-parallel batch
  stays on the host until ``train.loop.batch_to_device`` copies it.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig, TrainConfig
from pwstablenet_tpu_torch.utils.timing import device_time

METRIC = "720p stabilized frames/sec/chip"
UNIT = "frames/sec/chip"
BASELINE_TARGET_FPS = 200.0  # BASELINE.json's target, not a reading

# bf16 dense (no sparsity) tensor-core peak, from NVIDIA's data sheet
BF16_DENSE_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,  # H100 SXM
}

MSE_GATE = 1e-6
CODE_GATE = 1

# each key the JAX suite writes -> the key this suite writes for it; the
# JAX keys name the Pallas kernel and XLA's oracle, these the CUDA
# kernel and its plain version
KEYS_OF_JAX_SUITE = {
    "pallas_vs_oracle_mse": "f32_kernel_vs_plain_mse",
    "pallas_grad_vs_autodiff_mse": "grad_kernel_vs_plain_mse",
    "pallas_padded_vs_oracle_mse": "f32_kernel_offlane_vs_plain_mse",
    "pallas_packed_max_code_diff": "packed_kernel_max_code_diff",
    **{k: k for k in (
        "fps_720p_device_n8", "fps_720p_device",
        "mfu_720p", "gflops_per_chunk_720p", "mfu_generator",
        "fps_480p_wall", "fps_480p_file_wall",
        "chunk480_h2d_ms", "chunk480_compute_ms", "chunk480_d2h_ms",
        "fps_1080p_device", "fps_4k_device",
        "causal_720p_ms_per_frame_chunk1", "causal_720p_ms_per_frame_chunk4",
        "train_step_ms", "train_step_dp_ms", "train_mesh_devices",
        "train_mfu", "train_gflops_per_step",
        "train_step_dp_default_ms",
        "train_loop_wall_ms", "train_loop_wall_devdata_ms",
    )},
}

# each windowed reading of ``measure_windows`` -> its sample count at the
# suite's sizes
WINDOW_SAMPLES = {
    "wall_fps_720p_clip": 7,
    "wall_fps_1080p_clip": 7,
    "live_720p_chunk1_ms": 200,
    "train_steps_per_s_pool": 7,
    "train_steps_per_s_deepstab": 7,
}
# the keys ``measure_windows`` always writes: each reading's median, its
# quartiles and its sample count, and the seconds of making the DeepStab
# tree.  Beside them it writes ``<reading>_p90`` where n >= 100, and on a
# card ``<reading>_idle_share`` and ``<reading>_peak_mem_gb``.
WINDOW_KEYS = tuple(f"{k}{s}" for k in WINDOW_SAMPLES for s in ("", "_q1", "_q3", "_n")) + (
    "deepstab_make_data_s",)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _warp_flops(frames: int, h: int, w: int, c: int = 3,
                backward: bool = False) -> float:
    """Analytic flops of a grid-sample kernel over ``frames`` outputs of
    ``h x w``: ~15 flops of coordinates and weights a pixel, plus a
    4-tap bilinear blend (4 mul + 3 add) a channel; the d/dgrid kernel
    does the tap math again and accumulates 2-channel gradients, counted
    as twice the forward on top of it."""
    f = float(frames) * h * w * (15 + 7 * c)
    return f * 3.0 if backward else f


def _counted_flops(fn: Callable, *args) -> float:
    """Flops of one ``fn(*args)`` as ``FlopCounterMode`` counts them:
    convolutions and matrix products, forward and any backward the call
    runs.  The grid-sample kernels count zero."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _frames(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """``n`` random uint8 RGB frames (drawn as uint8: a 4K chunk drawn as
    int64 would be a 4.4 GB temporary)."""
    return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _peak_flops(device: torch.device) -> Optional[float]:
    """This card's bf16 dense peak, None off the card or for a card the
    table lacks (then no MFU is written)."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    peak = BF16_DENSE_PEAK_FLOPS.get(name)
    if peak is None:
        log(f"no bf16 peak known for {name!r}: no MFU is written")
    return peak


def _card() -> Optional[torch.device]:
    """The card the suite measures; None without CUDA."""
    if not torch.cuda.is_available():
        return None
    device = torch.device("cuda")
    log(f"device: {torch.cuda.get_device_name(device)}, "
        f"{torch.cuda.device_count()} visible")
    return device


# ---------------------------------------------------------------------
# parity gates
# ---------------------------------------------------------------------


def parity_gates(device: torch.device, rng: np.random.Generator,
                 results: Dict[str, float]) -> bool:
    """Each CUDA kernel against its plain version on ``device``, at the
    JAX suite's gate shapes; writes the four gate keys and returns
    whether every gate held."""
    from pwstablenet_tpu_torch.kernels import grid_sample as K
    from pwstablenet_tpu_torch.ops.warp import flow_to_grid, resize_flow

    def tensor(a):
        return torch.from_numpy(a).to(device)

    def smooth_grid(b, h, w):
        lf = (rng.random((b, 8, 8, 2), np.float32) - 0.5) * 0.15
        return flow_to_grid(resize_flow(tensor(lf), h, w))

    def mse(a, b):
        return float(torch.mean((a - b) ** 2))

    img = tensor(rng.random((2, 64, 256, 3), np.float32))
    grid = smooth_grid(2, 64, 256)
    f32 = mse(K.grid_sample_f32(img, grid), K.grid_sample_f32_plain(img, grid))
    results["f32_kernel_vs_plain_mse"] = f32
    log(f"f32 kernel vs plain MSE: {f32:.3e} (gate: <={MSE_GATE:g})")

    cot = tensor(rng.standard_normal(img.shape).astype(np.float32))
    grad = mse(K.grid_sample_grad_f32(img, grid, cot),
               K.grid_sample_grad_f32_plain(img, grid, cot))
    results["grad_kernel_vs_plain_mse"] = grad
    log(f"d/dgrid kernel vs plain MSE: {grad:.3e} (gate: <={MSE_GATE:g})")

    # an off-lane width, as the JAX suite's 832-style padded wrapper
    imgp = tensor(rng.random((1, 64, 208, 3), np.float32))
    gridp = smooth_grid(1, 64, 208)
    offlane = mse(K.grid_sample_f32(imgp, gridp), K.grid_sample_f32_plain(imgp, gridp))
    results["f32_kernel_offlane_vs_plain_mse"] = offlane
    log(f"f32 kernel at width 208 vs plain MSE: {offlane:.3e} (gate: <={MSE_GATE:g})")

    img8 = tensor(rng.integers(0, 256, (2, 64, 256, 3), dtype=np.uint8))
    out8 = K.grid_sample_packed_u8(img8, grid).to(torch.int16)
    ref8 = K.grid_sample_packed_u8_plain(img8, grid).to(torch.int16)
    codes = int((out8 - ref8).abs().max())
    results["packed_kernel_max_code_diff"] = codes
    log(f"packed uint8 kernel vs plain: max code diff {codes} (gate: <={CODE_GATE})")
    return max(f32, grad, offlane) <= MSE_GATE and codes <= CODE_GATE


# ---------------------------------------------------------------------
# the configurations
# ---------------------------------------------------------------------


def measure(
    device: torch.device,
    rng: np.random.Generator,
    model_cfg: Optional[ModelConfig] = None,
    hd: Tuple[int, int] = (720, 1280),
    sd: Tuple[int, int] = (480, 832),
    fhd: Tuple[int, int] = (1080, 1920),
    uhd: Tuple[int, int] = (2160, 3840),
    loop_steps: int = 15,
) -> Tuple[float, Dict[str, float]]:
    """Configs 2-5 of the JAX suite on ``device``: returns the headline
    (720p frames/s at 16 windows a chunk) and every reading, unrounded.
    ``hd``, ``sd``, ``fhd`` and ``uhd`` are the 720p, 480p (the 30-frame
    clip), 1080p and 4K frame sizes; the training batches are at the
    model's resolution.  The ``gflops_*`` keys are always written, the
    MFU keys only on a card in ``BF16_DENSE_PEAK_FLOPS``."""
    from pwstablenet_tpu_torch.data import video_io
    from pwstablenet_tpu_torch.data.synthetic import make_train_batch
    from pwstablenet_tpu_torch.parallel.mesh import (
        data_parallel_step, make_mesh_for_batch, replicate_tree, shard_batch,
    )
    from pwstablenet_tpu_torch.pipeline import Stabilizer
    from pwstablenet_tpu_torch.train.loop import batch_to_device
    from pwstablenet_tpu_torch.train.state import create_train_state
    from pwstablenet_tpu_torch.train.step import make_train_step

    model_cfg = model_cfg or ModelConfig()
    peak = _peak_flops(device)
    results: Dict[str, float] = {}
    T = model_cfg.temporal_window
    mh, mw = model_cfg.model_resolution

    def on_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    # ---- config 3: the 720p device path ----
    n = 8
    stab = Stabilizer(model_cfg, PipelineConfig(batch_windows=n), device=device)
    weights = stab.model.state_dict()
    frames_720 = on_device(_frames(rng, n + T - 1, *hd))
    dt = device_time(stab._chunk_step, (frames_720,), iters=10)
    results["fps_720p_device_n8"] = n / dt
    log(f"config 3 ({hd[0]}p device path): {dt * 1e3:.2f} ms/chunk{n} "
        f"= {n / dt:.0f} frames/s")

    # throughput: 16 windows a chunk, on the same weights
    n16 = 16
    stab16 = Stabilizer(model_cfg, PipelineConfig(batch_windows=n16),
                        state_dict=weights, device=device)
    frames_720_16 = on_device(_frames(rng, n16 + T - 1, *hd))
    dt16 = device_time(stab16._chunk_step, (frames_720_16,), iters=8)
    fps_720 = n16 / dt16
    results["fps_720p_device"] = fps_720
    log(f"config 3 ({hd[0]}p, 16-window chunks): {dt16 * 1e3:.2f} ms/chunk16 "
        f"= {fps_720:.0f} frames/s")
    del frames_720_16

    # flops of one chunk: the counted convolutions plus the output warp
    wf = _warp_flops(n, *hd)
    flops = _counted_flops(stab._chunk_step, frames_720) + wf
    results["gflops_per_chunk_720p"] = flops / 1e9
    if peak:
        results["mfu_720p"] = flops / dt / peak
        log(f"config 3 MFU: {100 * flops / dt / peak:.1f}% of the bf16 dense "
            f"peak ({flops / 1e9:.1f} GFLOP/chunk{n}: counted convolutions + "
            f"{wf / 1e9:.2f} GFLOP of analytic warp taps)")
    del frames_720

    # the generator alone
    xg = on_device(rng.standard_normal((n, mh, mw, model_cfg.stack_channels))
                   .astype(np.float32))

    @torch.inference_mode()
    def generator(x):
        return stab.model(x)

    dtg = device_time(generator, (xg,), iters=10)
    gflops = _counted_flops(generator, xg)
    if peak:
        results["mfu_generator"] = gflops / dtg / peak
        log(f"generator forward (b{n} {mh}x{mw}): {dtg * 1e3:.2f} ms, "
            f"{gflops / 1e9:.1f} GFLOP, MFU {100 * gflops / dtg / peak:.1f}%")
    del xg

    # ---- config 2: a 30-frame 480p clip, host arrays in and out ----
    clip = _frames(rng, 30, *sd)
    out, flows = stab.stabilize_frames(clip)  # warm
    if out.shape != clip.shape or out.dtype != np.uint8 or flows.shape[0] != len(clip):
        raise RuntimeError(f"stabilize_frames returned {out.shape} {out.dtype}, "
                           f"flows {flows.shape}")
    t0 = time.perf_counter()
    stab.stabilize_frames(clip)
    wall = time.perf_counter() - t0
    results["fps_480p_wall"] = len(clip) / wall
    log(f"config 2 ({len(clip)}-frame {sd[0]}p clip, wall incl. host): "
        f"{wall:.3f} s = {len(clip) / wall:.1f} frames/s")

    # file to file, decode and encode included
    with tempfile.TemporaryDirectory(prefix="pwstable_bench_") as td:
        inp, outp = os.path.join(td, "in.avi"), os.path.join(td, "out.avi")
        video_io.write_video(inp, clip, 30.0)
        t0 = time.perf_counter()
        r = stab.stabilize_video(inp, outp)
        wall_file = time.perf_counter() - t0
    results["fps_480p_file_wall"] = r["frames"] / wall_file
    log(f"config 2 (file to file, decode + encode): {wall_file:.3f} s "
        f"= {r['frames'] / wall_file:.1f} frames/s")

    # one chunk's phases, serially (the stream overlaps them)
    chunk = clip[: n + T - 1]
    _sync(device)
    t0 = time.perf_counter()
    dev_chunk = torch.from_numpy(chunk).to(device)  # pageable
    _sync(device)
    h2d = time.perf_counter() - t0
    comp = device_time(stab._chunk_step, (dev_chunk,), iters=5)
    s_dev, f_dev = stab._chunk_step(dev_chunk)
    _sync(device)
    t0 = time.perf_counter()
    s_dev.cpu().numpy(), f_dev.cpu().numpy()
    d2h = time.perf_counter() - t0
    results["chunk480_h2d_ms"] = h2d * 1e3
    results["chunk480_compute_ms"] = comp * 1e3
    results["chunk480_d2h_ms"] = d2h * 1e3
    log(f"config 2 chunk{n} phases (serial): H2D {h2d * 1e3:.2f} ms, device "
        f"{comp * 1e3:.2f} ms, D2H {d2h * 1e3:.2f} ms")
    del stab, dev_chunk, s_dev, f_dev

    # ---- config 5, inference half: 1080p and 4K at 16 windows ----
    for key, (h, w) in (("fps_1080p_device", fhd), ("fps_4k_device", uhd)):
        frames = on_device(_frames(rng, n16 + T - 1, h, w))
        dtx = device_time(stab16._chunk_step, (frames,),
                          iters=5 if key == "fps_1080p_device" else 3)
        results[key] = n16 / dtx
        log(f"config 5 ({h}x{w} device path): {dtx * 1e3:.2f} ms/chunk{n16} "
            f"= {n16 / dtx:.0f} frames/s")
        del frames
    del stab16
    _sync(device)
    torch.cuda.empty_cache()  # a no-op where CUDA was never initialised

    # ---- the causal (live) mode: device latency a frame ----
    causal_cfg = dataclasses.replace(model_cfg, temporal_center=T - 1)
    for nlat in (1, 4):
        stab_c = Stabilizer(causal_cfg, PipelineConfig(batch_windows=nlat),
                            state_dict=weights, device=device)
        frames_c = on_device(_frames(rng, nlat + T - 1, *hd))
        dtc = device_time(stab_c._chunk_step, (frames_c,), iters=10)
        results[f"causal_720p_ms_per_frame_chunk{nlat}"] = dtc / nlat * 1e3
        log(f"causal mode, {hd[0]}p chunk{nlat}: {dtc * 1e3:.2f} ms/step = "
            f"{dtc / nlat * 1e3:.2f} ms/frame of device time ({nlat / dtc:.0f} frames/s)")
        del stab_c, frames_c

    # ---- configs 4 + 5, training half: the data-parallel step ----
    train_cfg = TrainConfig(batch_size=4)
    mesh = make_mesh_for_batch(train_cfg.batch_size)
    state = replicate_tree(create_train_state(model_cfg, train_cfg, device), mesh)
    dp_step = data_parallel_step(make_train_step(model_cfg, train_cfg), mesh)
    batch = batch_to_device(shard_batch(
        make_train_batch(train_cfg.batch_size, mh, mw, T), mesh), device)
    dts = device_time(lambda b: dp_step(state, b), (batch,), iters=5)
    results["train_step_ms"] = dts * 1e3
    results["train_step_dp_ms"] = dts * 1e3
    results["train_mesh_devices"] = mesh.size
    log(f"config 4/5 (train step, mesh x{mesh.size}, b{train_cfg.batch_size}x2 "
        f"{mh}x{mw} uint8): {dts * 1e3:.1f} ms/step = "
        f"{2 * train_cfg.batch_size / dts / mesh.size:.1f} samples/s (device)")

    # flops of one step, forward and backward, plus the loss warps' taps
    twf = _warp_flops(2 * train_cfg.batch_size * model_cfg.num_stages, mh, mw,
                      backward=True)
    tflops = (_counted_flops(dp_step, state, batch) + twf) / mesh.size
    results["train_gflops_per_step"] = tflops / 1e9
    if peak:
        results["train_mfu"] = tflops / dts / peak
        log(f"config 4/5 train-step MFU: {100 * tflops / dts / peak:.1f}% "
            f"({tflops / 1e9:.0f} GFLOP/step: counted convolutions, forward and "
            f"backward, + {twf / 1e9:.2f} GFLOP of analytic warp taps)")

    # ---- the full default config: dropout, EMA, batch 8 ----
    cfg_d = dataclasses.replace(model_cfg, use_dropout=True)
    tcfg_d = TrainConfig(batch_size=8, ema_decay=0.995, seed=1)
    mesh_d = make_mesh_for_batch(tcfg_d.batch_size)
    state_d = replicate_tree(create_train_state(cfg_d, tcfg_d, device), mesh_d)
    dp_step_d = data_parallel_step(make_train_step(cfg_d, tcfg_d), mesh_d)
    batch_d = batch_to_device(shard_batch(
        make_train_batch(tcfg_d.batch_size, mh, mw, T, seed=9), mesh_d), device)
    dtd = device_time(lambda b: dp_step_d(state_d, b), (batch_d,), iters=5)
    if state_d.g_ema is None:
        raise RuntimeError("the default config's state tracks no EMA")
    results["train_step_dp_default_ms"] = dtd * 1e3
    log(f"config 4/5 (default config: dropout + EMA, b{tcfg_d.batch_size}, mesh "
        f"x{mesh_d.size}): {dtd * 1e3:.1f} ms/step = "
        f"{2 * tcfg_d.batch_size / dtd / mesh_d.size:.1f} samples/s")
    del state_d, dp_step_d, batch_d

    # the loop's wall time a step: pre-made host batches, each copied to
    # the card in the loop (making them is the loader's work, not timed)
    host_batches = [make_train_batch(train_cfg.batch_size, mh, mw, T, seed=i + 1)
                    for i in range(4)]
    _sync(device)
    t0 = time.perf_counter()
    for i in range(loop_steps):
        b = batch_to_device(shard_batch(host_batches[i % len(host_batches)], mesh), device)
        dp_step(state, b)
    _sync(device)
    loop_wall = (time.perf_counter() - t0) / loop_steps
    results["train_loop_wall_ms"] = loop_wall * 1e3
    log(f"config 5 train loop wall (host batches copied in the loop): "
        f"{loop_wall * 1e3:.1f} ms/step ({loop_wall / dts:.2f}x device time)")

    # the loop alone, on a batch already on the card
    t0 = time.perf_counter()
    for _ in range(loop_steps):
        dp_step(state, batch)
    _sync(device)
    loop_dev = (time.perf_counter() - t0) / loop_steps
    results["train_loop_wall_devdata_ms"] = loop_dev * 1e3
    log(f"config 5 train loop wall (batch on the card): {loop_dev * 1e3:.1f} "
        f"ms/step ({loop_dev / dts:.2f}x device time)")
    return fps_720, results


# ---------------------------------------------------------------------
# wall-clock windows over the user paths
# ---------------------------------------------------------------------


def _summary(samples: Sequence[float]) -> Dict[str, float]:
    """Median, quartiles (numpy's linear interpolation) and count of
    ``samples``; the 90th percentile too where at least ten samples lie
    beyond it (n >= 100)."""
    a = np.asarray(samples, np.float64)
    q1, median, q3 = np.percentile(a, [25, 50, 75])
    out = {"median": float(median), "q1": float(q1), "q3": float(q3), "n": len(a)}
    if len(a) >= 100:
        out["p90"] = float(np.percentile(a, 90))
    return out


def _union_seconds(spans: Iterable[Tuple[float, float]]) -> float:
    """Seconds covered by the union of ``(start_us, end_us)`` intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy / 1e6


class _TracedWindow:
    """One window under ``torch.profiler`` on the card, from ``start()``
    to ``stop()``, each at a synchronize: ``idle_share`` is 1 - the union
    of the device's kernel, copy and set intervals / the window's wall
    time.  Tracing costs the host time, so the timed windows run without
    it and this one is taken after them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.idle_share: Optional[float] = None
        self.top: List[Tuple[str, float, int]] = []

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        from pwstablenet_tpu_torch.utils.timing import device_rows

        torch.cuda.synchronize(self.device)
        self.wall = time.perf_counter() - self.t0
        self.prof.stop()
        self.busy = _union_seconds(
            (ev.time_range.start, ev.time_range.end) for ev in self.prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False))
        if self.busy == 0.0:
            raise RuntimeError("the traced window holds no device event")
        self.idle_share = 1.0 - self.busy / self.wall
        self.top = device_rows(self.prof)[:8]

    def run(self, fn: Callable[[], object]) -> None:
        self.start()
        fn()
        self.stop()


def measure_windows(
    device: torch.device,
    rng: np.random.Generator,
    model_cfg: Optional[ModelConfig] = None,
    hd: Tuple[int, int] = (720, 1280),
    fhd: Tuple[int, int] = (1080, 1920),
    clip_frames: int = 240,
    clip_calls: int = WINDOW_SAMPLES["wall_fps_720p_clip"],
    live_warm: int = 10,
    live_chunks: int = WINDOW_SAMPLES["live_720p_chunk1_ms"],
    train_logs: int = WINDOW_SAMPLES["train_steps_per_s_pool"],
    log_every: int = 10,
    tree: Tuple[int, int, int, int] = (4, 60, 360, 640),
) -> Dict[str, float]:
    """The port's four user paths timed end to end on ``device``, each
    sample a wall-clock window that ends on the host or in a
    synchronize; returns the ``WINDOW_KEYS`` readings, unrounded.

    - ``wall_fps_720p_clip``, ``wall_fps_1080p_clip``: frames/s of one
      ``Stabilizer.stabilize_frames`` call (8 windows a chunk) on a
      ``clip_frames``-frame uint8 clip at ``hd`` / ``fhd`` on the host,
      host arrays out; one warm call, then ``clip_calls``.
    - ``live_720p_chunk1_ms``: the causal mode (``temporal_center =
      T-1``) at one window a chunk: ms of ``_dispatch_chunk(frames[i:i+T])
      .result()`` (pinned H2D, the chunk step, D2H of one frame and its
      flow) over successive frames of the 720p clip, serially;
      ``live_warm`` chunks, then ``live_chunks``.
    - ``train_steps_per_s_pool``: ``train.loop.train`` fed by a cycle
      over 8 pre-made ``make_train_batch`` host batches (made
      untimed); each sample is 1 / ``sec_per_step`` of one log (``log_every``
      steps ending in the metrics' sync), the first log (warm-up)
      dropped, ``train_logs`` kept.
    - ``train_steps_per_s_deepstab``: the same, fed by
      ``data.deepstab.batch_iterator`` at the default ``DataConfig`` on a
      ``write_synthetic_deepstab`` tree of ``tree`` = (pairs, frames,
      height, width); the seconds of making it are
      ``deepstab_make_data_s``.

    The readings use ``model_cfg`` (the default ``ModelConfig()``: full
    width, bf16, seeded weights) and inputs drawn from ``rng``.  On a
    card, beside each reading: ``_peak_mem_gb`` (the peak allocated
    over its timed windows) and ``_idle_share`` from one more window,
    traced after the timed ones (one clip call, 10 chunks, or one log
    of steps)."""
    from pwstablenet_tpu_torch.config import DataConfig
    from pwstablenet_tpu_torch.data.deepstab import (
        DeepStabDataset, batch_iterator, write_synthetic_deepstab,
    )
    from pwstablenet_tpu_torch.data.synthetic import make_train_batch
    from pwstablenet_tpu_torch.pipeline import Stabilizer
    from pwstablenet_tpu_torch.train.loop import train

    model_cfg = model_cfg or ModelConfig()
    card = device.type == "cuda"
    T = model_cfg.temporal_window
    results: Dict[str, float] = {}

    def reset_peak() -> None:
        if card:
            torch.cuda.reset_peak_memory_stats(device)

    def peak_gb() -> Optional[float]:
        return torch.cuda.max_memory_allocated(device) / 1e9 if card else None

    def record(key: str, samples: Sequence[float], unit: str, peak: Optional[float],
               traced: Optional[_TracedWindow]) -> None:
        s = _summary(samples)
        results[key] = s["median"]
        for q in ("q1", "q3", "n", "p90"):
            if q in s:
                results[f"{key}_{q}"] = s[q]
        msg = (f"{key}: median {s['median']:.4f} {unit} (q1 {s['q1']:.4f}, "
               f"q3 {s['q3']:.4f}, n {s['n']}")
        msg += f", p90 {s['p90']:.4f})" if "p90" in s else ")"
        if card:
            results[f"{key}_peak_mem_gb"] = peak
            results[f"{key}_idle_share"] = traced.idle_share
            msg += (f"; peak {peak:.3f} GB; traced window: device busy "
                    f"{traced.busy * 1e3:.2f} of {traced.wall * 1e3:.2f} ms, idle "
                    f"{100 * traced.idle_share:.1f}%, top device rows "
                    f"{[(k[:60], round(ms, 3), c) for k, ms, c in traced.top]}")
        log(msg)

    def traced(fn: Callable[[], object]) -> Optional[_TracedWindow]:
        if not card:
            return None
        window = _TracedWindow(device)
        window.run(fn)
        return window

    # ---- offline stabilization: a clip in host memory, host arrays out ----
    stab = Stabilizer(model_cfg, PipelineConfig(), device=device)
    clip_hd = None
    for key, (h, w) in (("wall_fps_720p_clip", hd), ("wall_fps_1080p_clip", fhd)):
        clip = _frames(rng, clip_frames, h, w)
        out, flows = stab.stabilize_frames(clip)  # warm
        if out.shape != clip.shape or out.dtype != np.uint8 or flows.shape[0] != len(clip):
            raise RuntimeError(f"stabilize_frames returned {out.shape} {out.dtype}, "
                               f"flows {flows.shape}")
        del out, flows
        reset_peak()
        fps = []
        for _ in range(clip_calls):
            t0 = time.perf_counter()
            stab.stabilize_frames(clip)
            fps.append(len(clip) / (time.perf_counter() - t0))
        record(key, fps, "frames/s", peak_gb(), traced(lambda: stab.stabilize_frames(clip)))
        if clip_hd is None:
            clip_hd = clip
        del clip

    # ---- the live mode: one causal window a chunk, serially ----
    causal_cfg = dataclasses.replace(model_cfg, temporal_center=T - 1)
    live = Stabilizer(causal_cfg, PipelineConfig(batch_windows=1),
                      state_dict=stab.model.state_dict(), device=device)
    del stab
    starts = len(clip_hd) - T + 1

    def live_chunk(i: int):
        s = i % starts
        return live._dispatch_chunk(clip_hd[s : s + T]).result()

    for i in range(live_warm):
        live_chunk(i)
    reset_peak()
    ms = []
    for i in range(live_warm, live_warm + live_chunks):
        t0 = time.perf_counter()
        live_chunk(i)
        ms.append((time.perf_counter() - t0) * 1e3)
    after = live_warm + live_chunks
    record("live_720p_chunk1_ms", ms, "ms", peak_gb(),
           traced(lambda: [live_chunk(after + i) for i in range(10)]))
    del live, clip_hd
    _sync(device)
    torch.cuda.empty_cache()  # a no-op where CUDA was never initialised

    # ---- training: train() from a batch pool in memory, then from disk ----
    mh, mw = model_cfg.model_resolution

    def train_windows(key: str, batches: Iterable[dict]) -> None:
        logs: List[dict] = []
        window = _TracedWindow(device) if card else None
        peak: List[float] = []

        def collect(m: dict) -> None:
            logs.append(m)
            if len(logs) == train_logs + 1:
                peak.append(peak_gb())
                if window is not None:
                    window.start()
            elif window is not None and len(logs) == train_logs + 2:
                window.stop()

        with tempfile.TemporaryDirectory(prefix="pwstable_bench_") as ckpt_dir:
            tcfg = TrainConfig(log_every=log_every, checkpoint_dir=ckpt_dir)
            reset_peak()
            # the warm-up log, the timed ones and, on a card, the traced one
            train(model_cfg, tcfg, batches, log_fn=collect, device=device,
                  max_steps=(train_logs + 1 + int(card)) * log_every)
        record(key, [1.0 / m["sec_per_step"] for m in logs[1 : train_logs + 1]],
               "steps/s", peak[0], window)

    batch_size = TrainConfig().batch_size
    host_batches = [make_train_batch(batch_size, mh, mw, T, seed=int(rng.integers(1 << 31)),
                                     temporal_center=model_cfg.temporal_center)
                    for _ in range(8)]
    train_windows("train_steps_per_s_pool", itertools.cycle(host_batches))
    del host_batches

    pairs, frames, h, w = tree
    with tempfile.TemporaryDirectory(prefix="pwstable_bench_") as root:
        t0 = time.perf_counter()
        write_synthetic_deepstab(root, num_pairs=pairs, frames=frames, height=h, width=w,
                                 seed=int(rng.integers(1 << 31)))
        results["deepstab_make_data_s"] = time.perf_counter() - t0
        log(f"deepstab tree ({pairs} pairs of {frames} frames of {h}x{w}): "
            f"{results['deepstab_make_data_s']:.2f} s to make (not timed)")
        data = DeepStabDataset(DataConfig(data_root=root, crop_size=(mh, mw)), T,
                               model_cfg.temporal_center)
        it = batch_iterator(data, batch_size)
        try:
            train_windows("train_steps_per_s_deepstab", it)
        finally:
            it.close()
    return results


def main() -> int:
    device = _card()
    if device is None:
        log("bench: no CUDA device; the suite runs on the card only")
        return 1
    rng = np.random.default_rng(0)
    results: Dict[str, float] = {}
    if not parity_gates(device, rng, results):
        log("PARITY FAILURE: refusing to report performance")
        print(json.dumps({
            "metric": METRIC, "value": 0.0, "unit": UNIT,
            "vs_baseline": 0.0, "error": "kernel parity failure",
        }), flush=True)
        return 1
    fps_720, readings = measure(device, rng)
    results.update(readings)
    results.update(measure_windows(device, rng))
    print(json.dumps({
        "metric": METRIC,
        "value": round(fps_720, 1),
        "unit": UNIT,
        "vs_baseline": round(fps_720 / BASELINE_TARGET_FPS, 3),
        "detail": {k: round(v, 4) for k, v in results.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
