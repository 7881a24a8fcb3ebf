"""Periodic in-training evaluation: a held-out clip is stabilized with the
current inference weights (the EMA copy when tracked) every
``TrainConfig.eval_every`` steps and scored with ``eval.metrics``; the
numbers ride the training log (JSONL, TensorBoard) and drive the loop's
best-step tracking.  The JAX package's ``eval/hooks.py``, on a port
``Stabilizer``.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Optional

import numpy as np

from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig


def make_clip_eval_hook(
    model_cfg: ModelConfig,
    unstable_clip: np.ndarray,
    stable_clip: Optional[np.ndarray] = None,
    batch_windows: int = 8,
) -> Callable[[object], Dict[str, float]]:
    """Build an ``eval_fn`` for ``train.loop.train(eval_fn=...)``.

    Stabilizes ``unstable_clip`` ((T, H, W, 3), uint8 or [-1, 1] f32)
    with the state's inference weights and reports the stability score,
    the raw clip's score, and the PSNR against ``stable_clip`` when that
    ground truth is given.

    One ``Stabilizer`` is made at the first call, on the device of the
    state's generator, and each call loads the weights into it."""
    from pwstablenet_tpu_torch.eval.metrics import psnr, stability_score
    from pwstablenet_tpu_torch.pipeline import Stabilizer

    n = min(batch_windows, max(len(unstable_clip), 1))
    base_stability = stability_score(_to_unit(unstable_clip))
    stabs: Dict[str, Stabilizer] = {}

    def eval_fn(state) -> Dict[str, float]:
        g = state.generator_params()
        device = next(g.parameters()).device
        key = str(device)
        if key not in stabs:
            stabs[key] = Stabilizer(model_cfg, PipelineConfig(batch_windows=n), device=device)
        stab = stabs[key]
        stab.model.load_state_dict(g.state_dict())
        out, _ = stab.stabilize_frames(unstable_clip)
        outf = _to_unit(out)
        metrics = {
            "eval_stability": stability_score(outf),
            "eval_stability_unstable": base_stability,
        }
        if stable_clip is not None:
            metrics["eval_psnr_vs_stable"] = psnr(outf, _to_unit(stable_clip))
        return metrics

    # names the eval configuration, so that best-step tracking does not
    # compare scores of different setups across a resume (the loop keeps
    # it in best_step.json)
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(unstable_clip).tobytes())
    h.update(repr(model_cfg).encode())
    h.update(b"gt" if stable_clip is not None else b"nogt")
    eval_fn.fingerprint = h.hexdigest()[:16]
    return eval_fn


def _to_unit(frames: np.ndarray) -> np.ndarray:
    if np.issubdtype(frames.dtype, np.integer):
        return frames.astype(np.float32) / 127.5 - 1.0
    return frames
