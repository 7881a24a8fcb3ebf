#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  - requires a CUDA card (exits non-zero without one).
2. build   - builds the CUDA kernels from ``pwstablenet_tpu_torch/csrc``.
3. kernels - each kernel against its plain PyTorch version on the card:
             ``grid_sample_f32`` at (8,256,256,3) for every padding mode x
             align_corners, plus a +-300-row vertical displacement at
             720p (atol 1e-5); ``grid_sample_packed_u8`` at (8,720,1280,3)
             with smooth random flows, border and reflection (+-1 code).
4. main    - ``Stabilizer(ModelConfig(), PipelineConfig(batch_windows=8))``
             at full width, seeded random weights with small nonzero
             heads, stabilizes a 24-frame 720p uint8 clip; both kernels
             must have been launched.  Then one f32 chunk (TF32 off) on
             the card and on the CPU with the same weights: flows MSE
             <= 1e-3 and atol 1e-3, frames +-1 code.
5. timing  - frames/s of ``stabilize_frames`` and ms per chunk (bf16,
             720p), each kernel's time beside its bound, its plain
             version's time and ``F.grid_sample``'s (kernel 1 only; the
             port never calls it), and a ``torch.profiler`` pass over
             one ``stabilize_frames`` call: the device's busy and idle
             share and its time by kernel.

Then the ``kernels`` line, the card's name and power limit from
``nvidia-smi``, and ``{"ok": true, "device": {...}}`` as the last line.
Any failed check raises and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
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
    50 MB L2, so the inputs come from device memory, and it keeps the
    card busy for ~80 us while the host enqueues ``fn``, so the events
    time the device's work rather than the wrapper's host overhead."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

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
    f32_cases = {}
    for mode in ("border", "zeros", "reflection"):
        for ac in (True, False):
            out = K.grid_sample_f32(img, grid, mode, ac)
            ref = K.grid_sample_f32_plain(img, grid, mode, ac)
            f32_cases[f"{mode}/ac={ac}"] = (out - ref).abs().max().item()
    tall = torch.rand(2, 720, 1280, 3, device="cuda", generator=gen)
    tgrid = smooth_grid(torch, 2, 720, 1280, 0.1, gen)
    rows = 300.0 / (0.5 * (720 - 1))          # 300 rows, normalized
    sign = torch.where(torch.arange(1280, device="cuda") % 2 == 0, 1.0, -1.0)
    tgrid[..., 1] += rows * sign
    for mode in ("border", "zeros"):
        out = K.grid_sample_f32(tall, tgrid, mode)
        ref = K.grid_sample_f32_plain(tall, tgrid, mode)
        f32_cases[f"{mode}/+-300rows"] = (out - ref).abs().max().item()
    torch.cuda.synchronize()
    f32_err = max(f32_cases.values())
    emit("kernel_f32", max_abs_err=f32_err, cases=f32_cases, atol=1e-5)
    check(f32_err <= 1e-5, f"grid_sample_f32 vs plain: {f32_cases}")

    u8 = torch.randint(0, 256, (8, 720, 1280, 3), dtype=torch.uint8,
                       device="cuda", generator=gen)
    ugrid = smooth_grid(torch, 8, 720, 1280, 0.2, gen)
    u8_cases = {}
    for mode in ("border", "reflection"):
        out = K.grid_sample_packed_u8(u8, ugrid, mode)
        ref = K.grid_sample_packed_u8_plain(u8, ugrid, mode)
        d = (out.int() - ref.int()).abs()
        u8_cases[mode] = {"max_code_diff": d.max().item(),
                          "share_differing": (d > 0).double().mean().item()}
    torch.cuda.synchronize()
    u8_err = max(c["max_code_diff"] for c in u8_cases.values())
    emit("kernel_packed_u8", max_abs_err=u8_err, cases=u8_cases, atol=1)
    check(u8_err <= 1, f"grid_sample_packed_u8 vs plain: {u8_cases}")

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
    check(all(v > 0 for v in launches.values()), f"kernel launches {launches}")
    emit("main", frames=list(out.shape), flows=list(flows.shape), seconds=main_s,
         launches=launches, flow_abs_max=flow_max, share_pixels_changed=changed)

    # one f32 chunk on the card and on the CPU, same weights, TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    sd = {k: v.cpu() for k, v in st.model.state_dict().items()}
    n = 2
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
    emit("card_vs_cpu_f32", windows=n, flow_mse=mse, flow_max_abs_diff=fdiff,
         flow_abs_max=float(np.abs(c_flow).max()), frame_max_code_diff=code,
         cpu_seconds=cpu_s)
    check(mse <= 1e-3 and fdiff <= 1e-3, f"card vs CPU flows: mse {mse}, max {fdiff}")
    check(code <= 1, f"card vs CPU frames: {code} codes")
    del gpu, cpu

    # ---- 5. timings --------------------------------------------------
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
    emit("timing", chunk_ms=statistics.median(chunk_ms), chunk_windows=8,
         stabilize_frames_ms=stab_ms, frames=n_frames,
         frames_per_s=n_frames / (stab_ms / 1e3), compute_dtype=cfg.compute_dtype,
         frame_size=[fh, fw])

    # device busy share of stabilize_frames, and device time by kernel
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        st.stabilize_frames(clip)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): the aten ops that launch
    # them carry the same time again
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.key[:90], ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    emit("profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=(1.0 - busy_ms / wall_ms) if rows else None,
         top_device_ms=[[k, us / 1e3, c] for us, k, c in rows[:12]])

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    # the inter-stage warp's data: identity plus a smooth flow
    sgrid = smooth_grid(torch, 8, 256, 256, 0.2, gen)
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    k1 = {
        "ms": time_launches(torch, lambda: K.grid_sample_f32(img, sgrid), 50, flush),
        "plain_ms": time_launches(torch, lambda: K.grid_sample_f32_plain(img, sgrid), 10, flush),
        "library_ms": time_launches(torch, lambda: F.grid_sample(
            img_nchw, sgrid, "bilinear", "border", True), 50, flush),
    }
    k2 = {
        "ms": time_launches(torch, lambda: K.grid_sample_packed_u8(u8, ugrid), 50, flush),
        "plain_ms": time_launches(torch, lambda: K.grid_sample_packed_u8_plain(u8, ugrid), 5, flush),
        "library_ms": None,
    }

    def bound(nbytes, nflops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nflops / F32_FLOPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    px1 = img.shape[0] * img.shape[1] * img.shape[2]
    # per pixel: read grid (8 B) and 4 taps of C f32, write C f32; ~20
    # flops of coordinates and weights plus 7 per channel
    b1, by1 = bound(px1 * (8 + 3 * 4 + 3 * 4), px1 * (20 + 7 * 3))
    px2 = u8.shape[0] * u8.shape[1] * u8.shape[2]
    b2, by2 = bound(px2 * (8 + 3 + 3), px2 * (20 + 9 * 3))
    kernels = [
        {"name": "grid_sample_f32", "route": "cuda",
         "source": "pwstablenet_tpu_torch/csrc/grid_sample.cu",
         "replaces": "pwstablenet_tpu/kernels/grid_sample_pallas.py:614 (grid_sample_pallas)",
         "launches": launches["grid_sample_f32"], "max_abs_err": f32_err,
         "ms": k1["ms"], "kernel_ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": b1, "bound_by": by1, "library_ms": k1["library_ms"],
         "shape": list(img.shape)},
        {"name": "grid_sample_packed_u8", "route": "cuda",
         "source": "pwstablenet_tpu_torch/csrc/grid_sample.cu",
         "replaces": "pwstablenet_tpu/kernels/grid_sample_pallas.py:714 (grid_sample_pallas_packed)",
         "launches": launches["grid_sample_packed_u8"], "max_abs_err": u8_err,
         "ms": k2["ms"], "kernel_ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": b2, "bound_by": by2, "library_ms": k2["library_ms"],
         "shape": list(u8.shape)},
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
