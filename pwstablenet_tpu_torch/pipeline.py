"""Public inference pipeline: unstable clip in -> stabilized clip + warp
fields out.

- The generator always runs at its fixed ``model_resolution``; warp
  fields are emitted in resolution-independent normalized units and
  applied to the full-resolution frames by the packed uint8 kernel.
- Each frame crosses host->device once, as uint8 through a ring of
  pinned slots, and is downscaled once: the last ``temporal_window - 1``
  frames and their downscales stay on the device between chunks, and
  the temporal window stack is built there (a frame is reused by up to
  ``temporal_window`` windows).
- Chunks stream with a bounded number in flight: chunk i+k is dispatched
  while chunk i's results copy back into pinned host memory (in
  ``stabilize_frames``, a worker thread then copies them into the arrays
  it returns).
- ``stabilize_video`` is the file layer around that stream: native or
  OpenCV decode, incremental encode, warp fields streamed to an archive.
- Clip-sharded (``Stabilizer(mesh=...)``, ``parallel.mesh``): every rank
  streams the same clip; each chunk's temporal windows are split over
  the mesh's ranks and the results all-gathered, so every rank gets the
  whole chunk (and only rank 0 writes files).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without ``device="cpu"`` they raise.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig
from pwstablenet_tpu_torch.data.warp_fields import bfloat16
from pwstablenet_tpu_torch.models.generator import CascadedGenerator
from pwstablenet_tpu_torch.ops.pixels import from_unit, to_unit
from pwstablenet_tpu_torch.ops.warp import warp_image
from pwstablenet_tpu_torch.parallel.mesh import Mesh, all_gather_rows, sync_batch_norm


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; the CPU only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' to run the plain CPU path explicitly"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bfloat16 as an ``ml_dtypes.bfloat16`` view
    of the same bytes (torch's ``.numpy()`` refuses bfloat16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(bfloat16())
    return t.numpy()


class _Pending:
    """A dispatched chunk: the ``valid`` rows of its device results copying
    back into fresh page-locked blocks (the caching host allocator's, which
    recycles them once they are dropped); pad rows are never copied."""

    def __init__(self, stab: torch.Tensor, flow: torch.Tensor, valid: int, src=None):
        stab, flow = stab[:valid], flow[:valid]
        self._src = src  # keep the pinned H2D source alive until done
        self.event = None
        if stab.device.type == "cuda":
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in (stab, flow))
            for h, t in zip(host, (stab, flow)):
                h.copy_(t, non_blocking=True)
            stab, flow = host
            self.event = torch.cuda.Event()
            self.event.record()
        self.stab, self.flow = stab, flow

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return self.stab.numpy(), _to_numpy(self.flow)


class _Into:
    """``stabilize_frames``' results: one plain array pair for the whole
    clip, the caller's once returned.  One worker thread copies each
    chunk's rows in from its page-locked blocks once its D2H has completed,
    while the caller's thread launches the next chunks; at most ``limit``
    chunks wait for it, so the pinned blocks in use stay those of the
    chunks in flight, whatever the clip's length."""

    def __init__(self, frames: int):
        self.frames = frames
        self.pair: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.at = 0
        self.jobs: list = []
        self.worker = ThreadPoolExecutor(1, thread_name_prefix="pwst-results")

    def put(self, pending: _Pending, limit: int) -> None:
        stab, flow = pending.stab.numpy(), _to_numpy(pending.flow)  # not yet filled
        if self.pair is None:
            self.pair = tuple(np.empty((self.frames, *a.shape[1:]), a.dtype)
                              for a in (stab, flow))
        i, self.at = self.at, self.at + len(stab)
        self.jobs.append(self.worker.submit(self._copy, pending, i))
        while len(self.jobs) > limit:
            self.jobs.pop(0).result()

    def _copy(self, pending: _Pending, i: int) -> None:
        for out, a in zip(self.pair, pending.result()):
            # as bytes, which numpy copies with the GIL released
            out[i : i + len(a)].view(np.uint8)[...] = a.view(np.uint8)

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        while self.jobs:
            self.jobs.pop(0).result()
        return self.pair

    def close(self) -> None:
        self.worker.shutdown(cancel_futures=True)


class _Ring:
    """Host slots that carry a stream's new frames to the device, used in
    turn: page-locked on the card, where a slot is written again only once
    the H2D that read it has completed; one plain slot on the CPU, where
    the frames are consumed before ``send`` returns."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        n = slots if device.type == "cuda" else 1
        self.slots: list = [None] * n
        self.events: list = [None] * n
        self.i = 0
        self.filled = 0

    def put(self, frames: np.ndarray, capacity: int) -> None:
        """Append ``frames`` to the current slot (of ``capacity`` frames)."""
        i = self.i
        if self.filled == 0:
            if self.events[i] is not None:
                self.events[i].synchronize()
            if self.slots[i] is None:
                self.slots[i] = torch.empty(
                    (capacity, *frames.shape[1:]), dtype=getattr(torch, frames.dtype.name),
                    pin_memory=self.device.type == "cuda")
        # numpy's copy runs on this thread; torch's wakes the intra-op
        # threads, whose spinning slows the launches and the results' worker
        np.copyto(self.slots[i][self.filled : self.filled + len(frames)].numpy(), frames)
        self.filled += len(frames)

    def send(self) -> torch.Tensor:
        """The current slot's frames on the device; the next slot becomes
        current."""
        i = self.i
        t = self.slots[i][: self.filled].to(self.device, non_blocking=True)
        if self.device.type == "cuda":
            self.events[i] = torch.cuda.Event()
            self.events[i].record()
        self.i, self.filled = (i + 1) % len(self.slots), 0
        return t


class Stabilizer:
    """Video stabilization inference engine.

    ``state_dict`` may come from ``interop.from_jax`` (weights of the
    JAX package) or from another ``Stabilizer``; without one the
    generator is initialised from ``torch.Generator().manual_seed(seed)``
    with an identity-warp head.

    ``mesh`` (``parallel.mesh.Mesh``): clip-sharded inference, each
    chunk's windows split over the mesh's ranks (batch norm over all of
    them); ``batch_windows`` must be divisible by the mesh size.  Every
    rank of the mesh runs the same calls on the same clip."""

    def __init__(
        self,
        model_cfg: Optional[ModelConfig] = None,
        pipeline_cfg: Optional[PipelineConfig] = None,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        device=None,
        mesh: Optional[Mesh] = None,
    ):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg or ModelConfig()
        self.pipeline_cfg = pipeline_cfg or PipelineConfig()
        self.mesh = mesh
        if mesh is not None and self.pipeline_cfg.batch_windows % mesh.size:
            raise ValueError(
                f"batch_windows ({self.pipeline_cfg.batch_windows}) must "
                f"be divisible by the mesh size ({mesh.size})"
            )
        if self.pipeline_cfg.warp_field_dtype == "bfloat16":
            bfloat16()  # without ml_dtypes, refuse here, not at the first chunk
        gen = torch.Generator().manual_seed(seed)
        model = CascadedGenerator(self.model_cfg, generator=gen)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        if mesh is not None:
            sync_batch_norm(self.model, mesh)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _chunk_step(self, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """frames (N+T-1, H, W, 3) on the device -> (stabilized
        (N, H, W, 3) in the input dtype, flows (N, h, w, 2))."""
        return self._chunk(frames)

    def _chunk(
        self, frames: torch.Tensor,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The chunk step's body, with the generator's weights taken from
        ``state_dict`` when given (``export`` traces it so, keeping the
        weights arguments of the exported program).  Under a mesh, rank
        ``r`` of ``size`` takes windows ``[r*k, (r+1)*k)``, ``k = n /
        size``, and so only frames ``[r*k, r*k + k + T - 1)``."""
        frames = self._rank_rows(frames)
        return self._windows(frames, self._downscale(frames), state_dict)

    def _rank_rows(self, frames: torch.Tensor) -> torch.Tensor:
        """The frames of this rank's windows of a chunk (all of them
        without a mesh)."""
        mesh = self.mesh
        if mesh is None:
            return frames
        n = (frames.shape[0] - (self.model_cfg.temporal_window - 1)) // mesh.size
        return frames[mesh.rank * n : mesh.rank * n + n + self.model_cfg.temporal_window - 1]

    def _downscale(self, frames: torch.Tensor) -> torch.Tensor:
        """Frames -> [-1, 1] at model resolution, (N, mh, mw, 3); each
        frame on its own, so a frame's downscale does not depend on the
        others of the batch."""
        # antialiased bilinear downscale (jax.image.resize's default)
        return F.interpolate(
            to_unit(frames).permute(0, 3, 1, 2), size=self.model_cfg.model_resolution,
            mode="bilinear", align_corners=False, antialias=True,
        ).permute(0, 2, 3, 1)

    def _windows(
        self, frames: torch.Tensor, small: torch.Tensor,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The windows of a chunk's frames (raw, N+T-1) and their
        downscales -> (stabilized, flows), all-gathered under a mesh."""
        cfg = self.model_cfg
        T = cfg.temporal_window
        is_int = not frames.dtype.is_floating_point
        n = frames.shape[0] - (T - 1)
        # window j contributes frames [j, j+n)
        stacks = torch.cat([small[j : j + n] for j in range(T)], dim=-1)
        if state_dict is None:
            flow = self.model(stacks)[-1]
        else:
            flow = torch.func.functional_call(self.model, state_dict, (stacks,))[-1]
        # warp the RAW center frames: uint8 takes the packed kernel
        centers = frames[cfg.center_index : cfg.center_index + n]
        stabilized = warp_image(
            centers, flow,
            padding_mode=cfg.padding_mode, align_corners=cfg.align_corners,
        )
        if is_int and stabilized.dtype.is_floating_point:
            stabilized = from_unit(stabilized)
        flow = flow.to(getattr(torch, self.pipeline_cfg.warp_field_dtype))
        mesh = self.mesh
        if mesh is not None:
            stabilized, flow = all_gather_rows(stabilized, mesh), all_gather_rows(flow, mesh)
        return stabilized, flow

    @torch.inference_mode()
    def _take_in(self, new: torch.Tensor, held, lead: int):
        """A stream's new frames (on the device) appended to ``held``, the
        frames of the padded clip already there and their downscales;
        ``held`` None: the clip's first frames, after ``lead`` copies of
        the first.  Each new frame is converted and downscaled once."""
        small = self._downscale(new)
        if held is None:
            return (torch.cat([new[:1].expand(lead, *new.shape[1:]), new]),
                    torch.cat([small[:1].expand(lead, *small.shape[1:]), small]))
        return torch.cat([held[0], new]), torch.cat([held[1], small])

    @torch.inference_mode()
    def _carried_step(self, held, take: int, width: int):
        """The next chunk of a stream from the frames on the device: its
        ``take`` windows, the frames beyond ``held``'s last repeating it,
        padded with copies of the chunk's last frame to ``width`` windows
        (the pad rows are not results)."""
        T = self.model_cfg.temporal_window
        chunk = []
        for t in held:
            g = t[: take + T - 1]
            fill = take + T - 1 - g.shape[0]
            if fill > 0:
                g = torch.cat([g, t[-1:].expand(fill, *t.shape[1:])])
            if width > take:
                g = torch.cat([g, g[-1:].expand(width - take, *g.shape[1:])])
            chunk.append(self._rank_rows(g))
        return self._windows(*chunk)

    # ------------------------------------------------------------------
    def stabilize_frames(
        self, frames: np.ndarray, batch_windows: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Stabilize a clip.

        Args:
          frames: (time, H, W, 3) RGB, uint8 0..255 (the preferred
            transport format) or float32 in [-1, 1].
        Returns:
          (stabilized (time, H, W, 3) in the input dtype, warp fields
          (time, h, w, 2) normalized displacements at model resolution,
          in ``warp_field_dtype``; bfloat16 as ``ml_dtypes.bfloat16``).
        """
        if len(frames) == 0:
            raise ValueError("stabilize_frames: the clip has no frames")
        into = _Into(len(frames))
        try:
            for _ in self._stream(iter([frames]), batch_windows, into):
                pass
            return into.result()
        finally:
            into.close()

    def stabilize_video(
        self,
        input_path: str,
        output_path: str,
        warp_field_path: Optional[str] = None,
        max_frames: int = -1,
    ) -> dict:
        """Video in, video out: decode (a background thread) -> device
        chunks -> stabilized frames -> incremental encode, for videos of
        any length.  Warp fields stream to ``warp_field_path`` chunk by
        chunk (``data.warp_fields``) when given.  Under a mesh every rank
        decodes and runs the clip, and only rank 0 writes the video and
        the warp fields.

        The native C++ decoder and encoder (``data.native_io``) come
        first, then the Python OpenCV path; a missing input raises
        ``FileNotFoundError``, and any other failure of the native
        decoder falls back to the OpenCV path with a notice on stderr."""
        from pwstablenet_tpu_torch.data import native_io, video_io
        from pwstablenet_tpu_torch.data.prefetch import Prefetcher
        from pwstablenet_tpu_torch.data.warp_fields import WarpFieldWriter

        cfg = self.pipeline_cfg
        chunk = max(cfg.batch_windows, 1)
        decoder = None
        if native_io.available():
            try:
                decoder = native_io.NativeDecoder(
                    input_path, chunk_frames=chunk, queue_depth=cfg.prefetch_depth,
                )
            except FileNotFoundError:
                raise  # a missing input is the caller's error, not a fallback
            except Exception as e:
                print(
                    "pwstablenet_tpu_torch: native video decoder failed "
                    f"({type(e).__name__}: {e}); falling back to the Python "
                    "OpenCV path",
                    file=sys.stderr,
                )
        if decoder is not None:
            fps, h, w = decoder.fps, decoder.height, decoder.width
            frames_iter = iter(decoder)
        else:
            fps, h, w = video_io.probe_video(input_path)
            frames_iter = video_io.iter_video(input_path, chunk, dtype=np.uint8)
        if max_frames > 0:
            frames_iter = _limit_frames(frames_iter, max_frames)
        # the encoder takes frames of the border-cropped size
        dy, dx = self._crop_margins(h, w)
        size = (h - 2 * dy, w - 2 * dx)
        prefetch = None
        primary = self.mesh is None or self.mesh.rank == 0
        if not primary:
            writer = _Discard()
        elif decoder is not None:
            writer = native_io.NativeEncoder(output_path, fps, size, cfg.output_codec)
        else:
            writer = video_io.VideoWriterStream(output_path, fps, size, cfg.output_codec)
        if decoder is None:
            # the native decoder has its own decode thread and queue
            frames_iter = prefetch = Prefetcher(frames_iter, cfg.prefetch_depth)
        flow_writer = None
        if cfg.emit_warp_fields and warp_field_path and primary:
            flow_writer = WarpFieldWriter(warp_field_path)
        try:
            count = self._stream_to(frames_iter, writer, flow_writer)
        finally:
            writer.close()
            if flow_writer is not None:
                flow_writer.close()
            if prefetch is not None:
                prefetch.close()
            if decoder is not None:
                decoder.close()
        result = {"frames": count, "fps": fps, "output": output_path}
        if flow_writer is not None:
            result["warp_fields"] = warp_field_path
        return result

    def _stream_to(self, frames_iter: Iterator[np.ndarray], writer,
                   flow_writer=None) -> int:
        """Stream decoded chunks through the device into ``writer`` (any
        object with ``write(frames)``), border-cropped, and their warp
        fields into ``flow_writer`` when given; returns the frame count."""
        count = 0
        for stabilized, flow in self._stream(frames_iter, self.pipeline_cfg.batch_windows):
            stabilized = self._border_crop(stabilized)
            writer.write(stabilized)
            count += stabilized.shape[0]
            if flow_writer is not None:
                flow_writer.write(flow)
        return count

    # ------------------------------------------------------------------
    def _stream(
        self, chunks: Iterator[np.ndarray], batch_windows: Optional[int],
        into: Optional[_Into] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Streaming loop over decoded chunks, each frame staged to the
        device once.

        The clip edges are replicate-padded with ``center_index`` lead
        frames and ``future_frames`` tail frames (none in the causal mode,
        ``temporal_center == T-1``), made on the device from the first and
        last frame.  Source chunks of any size are consumed in place:
        their frames go through the pinned slots of a ``_Ring`` to the
        device, where the last ``T-1`` frames of the padded clip and their
        downscales are kept between chunks (the halo), so each chunk
        sends, converts and downscales only its new frames.  Chunks of
        ``n`` windows go at stride ``n``; the last is padded to
        ``batch_windows`` with copies of its last frame; a
        ``batch_windows`` below the configured one is refused.  At most
        ``prefetch_depth + 1`` chunks are in flight.  Each yielded pair
        stays valid; with ``into``, the results go to it and nothing is
        yielded."""
        cfg = self.model_cfg
        T = cfg.temporal_window
        n = batch_windows or self.pipeline_cfg.batch_windows
        n_target = self.pipeline_cfg.batch_windows
        if n < n_target:
            raise ValueError(f"batch_windows ({n}) is below the configured {n_target}")
        depth = max(self.pipeline_cfg.prefetch_depth, 1) + 1
        ring = _Ring(self.device, depth + 1)
        inflight: list = []
        held = None  # frames of the padded clip on the device, and their downscales

        def drain(limit: int):
            while len(inflight) > limit:
                yield inflight.pop(0).result()

        def dispatch(take: int):
            nonlocal held
            stab, flow = self._carried_step(held, take, max(take, n_target))
            if into is None:
                inflight.append(_Pending(stab, flow, take))
            else:
                into.put(_Pending(stab, flow, take), depth)
            held = tuple(t[take:] for t in held)

        # the first chunk's new frames follow its lead pad, made on the device
        first = n + cfg.future_frames
        need = first
        for chunk in chunks:
            pos = 0
            while pos < len(chunk):
                k = min(need - ring.filled, len(chunk) - pos)
                ring.put(chunk[pos : pos + k], first)
                pos += k
                if ring.filled == need:
                    held = self._take_in(ring.send(), held, cfg.center_index)
                    dispatch(n)
                    yield from drain(depth)
                    need = n
        if ring.filled:
            held = self._take_in(ring.send(), held, cfg.center_index)
        if held is None:
            return
        # flush: the tail pad repeats the last frame; the last chunk is short
        left = held[0].shape[0] + cfg.future_frames - (T - 1)
        while left > 0:
            take = min(n, left)
            dispatch(take)
            yield from drain(depth)
            left -= take
        yield from drain(0)

    def _dispatch_chunk(
        self, frames: np.ndarray, allow_short: bool = False
    ) -> _Pending:
        """Dispatch one chunk of whole windows without waiting for it;
        fewer windows than configured only with ``allow_short``, and then
        unpadded."""
        n = frames.shape[0] - (self.model_cfg.temporal_window - 1)
        if n < self.pipeline_cfg.batch_windows and not allow_short:
            raise ValueError("internal: short chunk without allow_short")
        src = _to_device(frames, self.device)
        stabilized, flow = self._chunk_step(src)
        return _Pending(stabilized, flow, n, src)

    def _crop_margins(self, h: int, w: int) -> Tuple[int, int]:
        frac = max(self.pipeline_cfg.border_crop_frac, 0.0)
        return int(h * frac), int(w * frac)

    def _border_crop(self, frames: np.ndarray) -> np.ndarray:
        _, h, w, _ = frames.shape
        dy, dx = self._crop_margins(h, w)
        if dy == 0 and dx == 0:
            return frames
        return frames[:, dy : h - dy, dx : w - dx]


class _Discard:
    """The writer of a rank that writes nothing."""

    def write(self, frames) -> None:
        pass

    def close(self) -> None:
        pass


def _limit_frames(chunks: Iterator[np.ndarray], limit: int) -> Iterator[np.ndarray]:
    """The first ``limit`` frames of a stream of chunks."""
    seen = 0
    for c in chunks:
        if seen + c.shape[0] >= limit:
            yield c[: limit - seen]
            return
        seen += c.shape[0]
        yield c


def stabilize(
    frames: np.ndarray,
    model_cfg: Optional[ModelConfig] = None,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot API: clip in -> (stabilized clip, warp fields)."""
    return Stabilizer(
        model_cfg, state_dict=state_dict, device=device
    ).stabilize_frames(frames)


@torch.inference_mode()
def apply_warp_fields(
    frames: np.ndarray,
    flows: np.ndarray,
    model_cfg: Optional[ModelConfig] = None,
    batch_frames: int = 8,
    device=None,
) -> np.ndarray:
    """Re-apply exported warp fields to the original frames: the same
    warp as ``stabilize_frames``, so the output is reproduced exactly.

    Args:
      frames: (T, H, W, 3) original clip, uint8 or [-1, 1] float32.
      flows: (T, h, w, 2) normalized displacement fields (any model
        resolution; upsampled to the frame size on the device), float32,
        float16 or ``ml_dtypes.bfloat16``.
      model_cfg: warp semantics source (padding mode, align corners).
      batch_frames: frames per device step.
    Returns:
      stabilized frames, (T, H, W, 3), in the input dtype.
    """
    if frames.shape[0] != flows.shape[0]:
        raise ValueError(
            f"frames ({frames.shape[0]}) and warp fields "
            f"({flows.shape[0]}) must cover the same time steps"
        )
    device = resolve_device(device)
    cfg = model_cfg or ModelConfig()
    n = max(int(batch_frames), 1)
    outs = []
    for i in range(0, frames.shape[0], n):
        f = _to_device(frames[i : i + n], device)
        fl = flows[i : i + n]
        if fl.dtype.name == "bfloat16":  # torch takes no numpy bfloat16
            fl = fl.astype(np.float32)
        fl = _to_device(fl, device).to(torch.float32)
        out = warp_image(
            f, fl, padding_mode=cfg.padding_mode, align_corners=cfg.align_corners
        )
        outs.append(out.cpu().numpy())
    return np.concatenate(outs)
