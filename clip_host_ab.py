#!/usr/bin/env python3
"""Where the host's time goes in ``Stabilizer.stabilize_frames`` on a clip
cell's calls, for one tree in one process on one card.

    python3 clip_host_ab.py [--tree DIR] [--size 720x1280] [--frames 240]
                            [--calls 10] [--keep previous|all]

``--tree`` is the root of the tree to import ``pwstablenet_tpu_torch``
and ``benchmark`` from (default: this file's own), for example the parent
commit unpacked with ``git archive``; run two trees in alternating
processes to compare them.  The clip, weights and config are the clip
cells' (``benchmark.cells``: a clip from seed 0, ``PipelineConfig()``,
heads drawn to ~3 px of flow).  One warm call on the clip's first 240
frames, then ``--calls`` calls, each keeping the previous call's results
alive through the next (``previous``, the cells' pattern) or keeping
every result (``all``).

Prints one JSON line: the calls' wall and CPU seconds, the caching host
allocator's pinned bytes and blocks after them
(``torch.cuda.host_memory_stats``), the process's peak resident memory,
and one more call with the main thread's time split by what it does
(``SPLIT``, each function wrapped with a clock): input copies, the pinned
staging copy and its allocation, the H2D and D2H enqueues, the chunks'
launches, the waits on their events and on the results' worker thread,
and the output copies; ``other_s`` is the rest of the call.  The results'
worker thread (a tree whose ``stabilize_frames`` has one) is timed apart,
in ``worker_copies_s``.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import sys
import threading
import time

from chip_smoke import nvidia_smi

# what the host does inside ``stabilize_frames``: (where the function
# lives, its name) -> {the pipeline function calling it: the share it is
# counted in}; the parent's and this tree's callers; calls from anywhere
# else, or from another thread than the main one, are not counted
SPLIT = {
    ("np", "concatenate"): {"_stream": "input_copies_s", "_dispatch_chunk": "input_copies_s",
                            "stabilize_frames": "output_copies_s"},
    ("np", "repeat"): {"_stream": "input_copies_s", "_dispatch_chunk": "input_copies_s"},
    ("np", "ascontiguousarray"): {"_to_device": "input_copies_s"},
    ("np", "copyto"): {"put": "pinned_staging_s"},
    ("Tensor", "pin_memory"): {"_to_device": "pinned_staging_s"},
    ("torch", "empty"): {"__init__": "pinned_alloc_s", "put": "pinned_alloc_s"},
    ("Tensor", "to"): {"_to_device": "h2d_enqueue_s", "send": "h2d_enqueue_s"},
    ("Tensor", "copy_"): {"__init__": "d2h_enqueue_s"},
    ("Stabilizer", "_chunk_step"): {"_dispatch_chunk": "chunk_launches_s"},
    ("Stabilizer", "_take_in"): {"_stream": "chunk_launches_s"},
    ("Stabilizer", "_carried_step"): {"dispatch": "chunk_launches_s"},
    ("Event", "synchronize"): {"result": "event_waits_s", "put": "event_waits_s"},
    ("Future", "result"): {"put": "worker_waits_s", "result": "worker_waits_s"},
}


def time_host(P) -> dict:
    """Wrap each function of ``SPLIT`` (and ``stabilize_frames``, and the
    results' worker's copy where there is one) of the pipeline module
    ``P`` with a clock; returns the seconds, by share, summed over the
    calls made from then on."""
    import concurrent.futures

    import numpy
    import torch

    spent = {share: 0.0 for by in SPLIT.values() for share in by.values()}
    spent.update(call_s=0.0, worker_copies_s=0.0)
    main = threading.main_thread()

    def timed(fn, by):
        def wrapper(*args, **kwargs):
            caller = sys._getframe(1).f_code
            share = by.get(caller.co_name) if caller.co_filename == P.__file__ else None
            if share is None or threading.current_thread() is not main:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[share] += time.perf_counter() - t0
        return wrapper

    def clocked(fn, share):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[share] += time.perf_counter() - t0
        return wrapper

    class Module:
        """A module with some functions wrapped."""

        def __init__(self, module, names):
            self._module = module
            for name, by in names.items():
                setattr(self, name, timed(getattr(module, name), by))

        def __getattr__(self, name):
            return getattr(self._module, name)

    owners = {"Tensor": torch.Tensor, "Stabilizer": P.Stabilizer, "Event": torch.cuda.Event,
              "Future": concurrent.futures.Future}
    for (where, name), by in SPLIT.items():
        if where in owners and hasattr(owners[where], name):
            setattr(owners[where], name, timed(getattr(owners[where], name), by))
    P.np = Module(numpy, {n: by for (w, n), by in SPLIT.items() if w == "np"})
    P.torch = Module(torch, {n: by for (w, n), by in SPLIT.items() if w == "torch"})
    P.torch.cuda = torch.cuda
    P.Stabilizer.stabilize_frames = clocked(P.Stabilizer.stabilize_frames, "call_s")
    if hasattr(P, "_Into") and hasattr(P._Into, "_copy"):
        P._Into._copy = clocked(P._Into._copy, "worker_copies_s")
    return spent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--size", default="720x1280")
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--keep", choices=("previous", "all"), default="previous")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("clip_host_ab: no CUDA device", file=sys.stderr)
        return 1
    from benchmark import cells
    from pwstablenet_tpu_torch import pipeline as P
    from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig

    h, w = (int(v) for v in args.size.split("x"))
    dev = torch.device("cuda")
    cfg = ModelConfig()
    clip = cells.make_clip(0, args.frames, h, w)
    stab = P.Stabilizer(cfg, PipelineConfig(), seed=0, device=dev)
    cells.draw_heads(stab.model, 0, cfg, cells._probe(cfg, clip, dev), (h, w))
    stab.stabilize_frames(clip[:240])  # warm
    seconds, cpu, kept = [], [], []
    for _ in range(args.calls):
        t0, c0 = time.perf_counter(), time.process_time()
        result = stab.stabilize_frames(clip)
        seconds.append(time.perf_counter() - t0)
        cpu.append(time.process_time() - c0)
        kept = kept + [result] if args.keep == "all" else [result]
    host = torch.cuda.host_memory_stats()
    del kept, result
    spent_by = time_host(P)
    t0, c0 = time.perf_counter(), time.process_time()
    stab.stabilize_frames(clip)
    timed_call = {"wall_s": time.perf_counter() - t0, "cpu_s": time.process_time() - c0,
                  **spent_by}
    timed_call["other_s"] = spent_by["call_s"] - sum(
        v for k, v in spent_by.items() if k not in ("call_s", "worker_copies_s"))
    print(json.dumps({
        "tree": args.tree, "size": [h, w], "frames": len(clip), "keep": args.keep,
        "seconds": seconds, "cpu_s": cpu, "median_s": statistics.median(seconds),
        "frames_per_s": len(clip) * len(seconds) / sum(seconds),
        "pinned_bytes_after_calls": host.get("allocated_bytes.current"),
        "pinned_blocks_after_calls": host.get("allocations.current"),
        "cuda_host_allocs": host.get("num_host_alloc"),
        "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "timed_call": timed_call,
        "nvidia_smi": nvidia_smi(), "device": torch.cuda.get_device_name(0),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
