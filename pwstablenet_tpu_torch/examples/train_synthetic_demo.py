"""End-to-end training demo, the counterpart of the JAX package's
``examples/train_synthetic_demo.py``: train the flagship cascade for 600
steps on a pool of 24 synthetic batches (batch 8, 256x256, moved to the
device once), save the generator under ``checkpoints/demo_params``, then
stabilize a held-out 60-frame 480x832 float clip and report its
stability beside the ground-truth-stable camera's.

    python -m pwstablenet_tpu_torch.examples.train_synthetic_demo [steps]
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from typing import Optional

import numpy as np

from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig, TrainConfig

# the batch pool's size, and the held-out clip: (frames, height, width, seed)
POOL = 24
EVAL_CLIP = (60, 480, 832, 777)


def run(steps: int = 600, work_dir: str = ".", model_cfg: Optional[ModelConfig] = None,
        device=None) -> dict:
    """Train ``steps`` steps on ``device`` (the card unless the caller
    asks for the CPU), cycling over ``POOL`` synthetic batches; save the
    generator under ``<work_dir>/checkpoints/demo_params``; evaluate on
    the held-out clip.  Returns the logged records, the ``EVAL`` report,
    the export's path and wall ``seconds`` by part."""
    from pwstablenet_tpu_torch.data import make_train_batch, synthetic_pair_clip
    from pwstablenet_tpu_torch.eval import stability_report
    from pwstablenet_tpu_torch.pipeline import Stabilizer, resolve_device
    from pwstablenet_tpu_torch.train import checkpoint as ckpt
    from pwstablenet_tpu_torch.train import create_train_state, make_train_step
    from pwstablenet_tpu_torch.train.loop import batch_to_device

    t_start = time.perf_counter()
    device = resolve_device(device)
    model_cfg = model_cfg or ModelConfig()
    train_cfg = TrainConfig(batch_size=8, num_epochs=1, steps_per_epoch=steps, w_feature=1.0)
    state = create_train_state(model_cfg, train_cfg, device)
    step = make_train_step(model_cfg, train_cfg)
    seconds = {}

    print("pre-generating batches...", flush=True)
    t0 = time.perf_counter()
    h, w = model_cfg.model_resolution
    batches = [
        batch_to_device(make_train_batch(8, h, w, model_cfg.temporal_window, seed=i), device)
        for i in range(POOL)
    ]
    seconds["batch_pool"] = time.perf_counter() - t0
    print(f"batch pool ready in {seconds['batch_pool']:.0f}s", flush=True)

    log = []
    t0 = time.perf_counter()
    for i in range(steps):
        metrics = step(state, batches[i % len(batches)])
        if i % 50 == 0 or i == steps - 1:
            m = {k: round(float(v), 4) for k, v in metrics.items()}
            m["step"] = i
            m["elapsed"] = round(time.perf_counter() - t0, 1)
            log.append(m)
            print(json.dumps(m), flush=True)
    seconds["train"] = time.perf_counter() - t0
    del batches

    params = os.path.join(work_dir, "checkpoints", "demo_params")
    shutil.rmtree(params, ignore_errors=True)
    ckpt.save_generator_state_dict(params, state.g.state_dict())
    print("params saved", flush=True)

    # ---- held-out evaluation ----
    t0 = time.perf_counter()
    frames, height, width, seed = EVAL_CLIP
    stable, unstable = synthetic_pair_clip(frames, height, width, seed=seed, shake_px=7.0)
    stab = Stabilizer(model_cfg, PipelineConfig(batch_windows=8),
                      state_dict=state.g.state_dict(), device=device)
    out, flows = stab.stabilize_frames(unstable)
    rep = stability_report(out, unstable)
    rep["gt_stable_score"] = stability_report(stable)["stability_score"]
    # flows are in normalized units: half the width is one unit
    rep["mean_abs_flow_px"] = float(np.abs(flows).mean() * width / 2)
    print("EVAL " + json.dumps({k: round(v, 4) for k, v in rep.items()}), flush=True)
    seconds["eval"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_start
    print("seconds:", json.dumps({**seconds, "steps_per_s": steps / seconds["train"]}),
          flush=True)
    print("DONE", flush=True)
    return {"log": log, "eval": rep, "params": params, "seconds": seconds}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(steps=int(argv[0]) if argv else 600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
