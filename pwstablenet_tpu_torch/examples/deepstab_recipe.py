"""The recipe that ``train_rich_deepstab`` and ``train_stressed_deepstab``
share, the counterpart of the JAX package's
``examples/train_rich_deepstab.py`` and
``examples/train_stressed_deepstab.py`` (which differ only in pairs,
dropout and the work directory's prefix).

An on-disk DeepStab-shaped dataset of the full scene model
(``write_synthetic_deepstab(rich=True)``) -> the threaded uint8 loader
(4 decode threads, crops at the model's resolution) -> ``train()``
with a generator EMA (0.995), the held-out hook every ``eval_every`` steps and best-step tracking ->
``best: {...}``, then ``EVAL[ema]`` and ``EVAL[best]`` on a fresh clip,
and the ground-truth-stable ceiling.  The printed lines are the JAX
scripts', with the same keys; ``seconds: {...}`` is added.
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from pwstablenet_tpu_torch.config import DataConfig, ModelConfig, PipelineConfig, TrainConfig

# (frames, seed) of the held-out clips, as the JAX recipes draw them
HOOK_CLIP = (32, 999)
EVAL_CLIP = (48, 1234)


def rich_clip(frames: int, size: Tuple[int, int], seed: int):
    """A RICH pair at ``shake_px=7``: (stable, unstable) in [-1, 1], and
    the unstable clip as uint8, the eval hook's and ``EVAL``'s input."""
    from pwstablenet_tpu_torch.data.synthetic import RICH, synthetic_pair_clip

    stable, unstable = synthetic_pair_clip(frames, size[0], size[1], seed=seed,
                                           shake_px=7.0, **RICH)
    u8 = np.clip((unstable + 1) * 127.5, 0, 255).round().astype(np.uint8)
    return stable, unstable, u8


def _rounded(report: dict) -> str:
    return json.dumps({k: round(float(v), 4) for k, v in report.items()})


def run(
    name: str,
    model_cfg: ModelConfig,
    steps: int,
    pairs: int,
    work_dir: Optional[str] = None,
    device=None,
    frames: int = 80,
    size: Tuple[int, int] = (320, 448),
    log_every: int = 50,
    eval_every: int = 250,
    checkpoint_every: int = 500,
    eval_frames: int = EVAL_CLIP[0],
) -> dict:
    """Write ``pairs`` rich pairs of ``frames`` frames at ``size`` under
    ``work_dir`` (default: a new temporary directory named after
    ``name``), train ``steps`` steps on ``device`` (the card unless the
    caller asks for the CPU) and evaluate on ``eval_frames`` frames of
    the fresh clip.

    Returns the logged records (``log``: metrics, ``hooks``: the eval
    hook's), the ``best`` record, the ``EVAL`` reports (``evals``), the
    ground-truth-stable ceiling, wall ``seconds`` by part, the checkpoint
    directory, the pair count and the hook clip (``hook_clip``, uint8)."""
    from pwstablenet_tpu_torch.data.deepstab import (
        DeepStabDataset, batch_iterator, write_synthetic_deepstab,
    )
    from pwstablenet_tpu_torch.eval import stability_report
    from pwstablenet_tpu_torch.eval.hooks import make_clip_eval_hook
    from pwstablenet_tpu_torch.pipeline import Stabilizer
    from pwstablenet_tpu_torch.train import checkpoint as ckpt
    from pwstablenet_tpu_torch.train.loop import train

    t_start = time.perf_counter()
    work = work_dir or tempfile.mkdtemp(prefix=f"pwstable_{name}_")
    root = os.path.join(work, "data")
    ckpt_dir = os.path.join(work, "ckpt")
    seconds = {}

    print(f"writing {pairs}-pair {name} dataset under {root} ...", flush=True)
    with ThreadPoolExecutor(2) as pool:
        # the held-out clips render while the tree is written (numpy
        # releases the interpreter lock)
        clips = [pool.submit(rich_clip, n, size, clip_seed)
                 for n, clip_seed in (HOOK_CLIP, (eval_frames, EVAL_CLIP[1]))]
        t0 = time.perf_counter()
        write_synthetic_deepstab(root, num_pairs=pairs, frames=frames, height=size[0],
                                 width=size[1], seed=5, rich=True)
        seconds["make_data"] = time.perf_counter() - t0
        (stable, _, clip_u8), (stable2, unstable2, u8) = (c.result() for c in clips)
        # what the clips took beyond the tree
        seconds["clips"] = time.perf_counter() - t0 - seconds["make_data"]

    train_cfg = TrainConfig(
        batch_size=8, num_epochs=1, steps_per_epoch=steps, w_feature=1.0,
        log_every=log_every, checkpoint_every=checkpoint_every, checkpoint_dir=ckpt_dir,
        ema_decay=0.995, eval_every=eval_every,
    )
    ds = DeepStabDataset(
        DataConfig(data_root=root, crop_size=model_cfg.model_resolution,
                   num_decode_threads=4),
        model_cfg.temporal_window,
    )
    print(f"dataset: {len(ds.pairs)} pairs", flush=True)

    records = []

    def log(m):
        records.append(m)
        print(json.dumps(m), flush=True)

    batches = batch_iterator(ds, train_cfg.batch_size, seed=0)
    t0 = time.perf_counter()
    try:
        state = train(
            model_cfg, train_cfg, batches, max_steps=steps, log_fn=log,
            eval_fn=make_clip_eval_hook(model_cfg, clip_u8, stable_clip=stable,
                                        batch_windows=8),
            device=device,
        )
    finally:
        batches.close()
    seconds["train"] = time.perf_counter() - t0
    best = ckpt.best_step(ckpt_dir)
    print("best:", json.dumps(best), flush=True)

    t0 = time.perf_counter()
    evals = {}
    for label, state_dict in (
        ("ema", state.generator_params().state_dict()),
        ("best", ckpt.load_generator_state_dict(ckpt_dir, step="best")),
    ):
        stab = Stabilizer(model_cfg, PipelineConfig(batch_windows=8),
                          state_dict=state_dict, device=device)
        out, _ = stab.stabilize_frames(u8)
        evals[label] = stability_report(out.astype(np.float32) / 127.5 - 1.0, unstable2)
        print(f"EVAL[{label}]", _rounded(evals[label]), flush=True)
    ceiling = stability_report(stable2)["stability_score"]
    print("gt-stable ceiling:", round(ceiling, 4), flush=True)
    seconds["evals"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_start

    metrics = [m for m in records if "sec_per_step" in m]
    sec_per_step = statistics.median(m["sec_per_step"] for m in metrics)
    print("seconds:", json.dumps({**seconds, "sec_per_step": sec_per_step,
                                  "steps_per_s": 1.0 / sec_per_step}), flush=True)
    return {
        "checkpoint_dir": ckpt_dir, "pairs": len(ds.pairs),
        "log": metrics, "hooks": [m for m in records if "eval_stability" in m],
        "best": best, "evals": evals, "gt_stable_ceiling": ceiling,
        "seconds": seconds, "hook_clip": clip_u8,
    }
