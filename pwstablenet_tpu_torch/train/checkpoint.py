"""Checkpoints of the whole training state, in PyTorch's format.

``<dir>/<step>/state.pt`` holds the generator, discriminator and
feature-extractor weights, both optimizers and schedulers, the EMA copy
(when tracked), the dropout generator's state and the step, so a resume
continues exactly.  A save writes ``<step>.tmp`` and renames it, and
keeps the newest ``keep`` steps.

Best-step tracking (GAN quality is non-monotonic): the loop calls
``save_best`` when the eval hook reports a new best score; the
generator's inference weights (EMA when tracked) go to
``<dir>/best/generator.pt`` and the step and score to
``<dir>/best_step.json``, out of reach of the pruning.

An inference-only export (``save_generator_state_dict``, the CLI's
``train --export-params``) is a directory holding ``generator.pt``;
``load_generator_state_dict`` reads it as well as a training
checkpoint directory.

Reading the JAX package's Orbax checkpoints is not ported yet.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys
from typing import Dict, List, Optional, Union

import torch

from pwstablenet_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"
BEST_FILE = "best_step.json"
BEST_DIR = "best"
GENERATOR_FILE = "generator.pt"


def _numbered_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name) for name in os.listdir(directory)
        if name.isdigit() and os.path.isfile(os.path.join(directory, name, STATE_FILE))
    )


def latest_step(directory: str) -> Optional[int]:
    steps = _numbered_steps(directory)
    return steps[-1] if steps else None


def _payload(state: TrainState) -> Dict:
    return {
        "step": int(state.step),
        "g": state.g.state_dict(),
        "d": state.d.state_dict(),
        "feat": state.feat.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
        "g_sched": state.g_sched.state_dict(),
        "d_sched": state.d_sched.state_dict(),
        "rng": state.rng.get_state(),
        "g_ema": None if state.g_ema is None else state.g_ema.state_dict(),
    }


def save_state(directory: str, state: TrainState, keep: int = 3) -> int:
    """Write ``state`` as step ``state.step``; prune to the newest ``keep``."""
    step = int(state.step)
    final = os.path.join(directory, str(step))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_payload(state), os.path.join(tmp, STATE_FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    for old in _numbered_steps(directory)[: -max(keep, 1)]:
        shutil.rmtree(os.path.join(directory, str(old)))
    return step


def _load(directory: str, step: Optional[int]) -> Dict:
    steps = _numbered_steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint found in {directory!r}")
        step = steps[-1]
    elif step not in steps:
        raise FileNotFoundError(
            f"step {step} not found in {directory!r}; available: {steps}"
        )
    path = os.path.join(directory, str(step), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


def _event(**fields) -> None:
    print(json.dumps(fields), file=sys.stderr)


def restore_state(
    directory: str, state: TrainState, step: Optional[int] = None
) -> TrainState:
    """Load step ``step`` (default: the newest) into ``state`` in place
    and return it.  Resuming with EMA tracking switched on or off
    relative to the checkpoint drops the saved EMA, or starts a new one
    at the restored generator, with a notice on stderr."""
    p = _load(directory, step)
    state.g.load_state_dict(p["g"])
    state.d.load_state_dict(p["d"])
    state.feat.load_state_dict(p["feat"])
    state.g_opt.load_state_dict(p["g_opt"])
    state.d_opt.load_state_dict(p["d_opt"])
    state.g_sched.load_state_dict(p["g_sched"])
    state.d_sched.load_state_dict(p["d_sched"])
    state.rng.set_state(p["rng"])
    state.step = int(p["step"])
    if state.g_ema is not None and p["g_ema"] is not None:
        state.g_ema.load_state_dict(p["g_ema"])
    elif state.g_ema is not None:
        state.g_ema = copy.deepcopy(state.g).requires_grad_(False)
        _event(event="ema_initialized_on_resume",
               reason="this run tracks an EMA but the checkpoint has none; "
                      "starting it at the restored params")
    elif p["g_ema"] is not None:
        _event(event="ema_dropped_on_resume",
               reason="checkpoint tracks an EMA but this run has ema_decay=0")
    return state


def save_best(
    directory: str, state: TrainState, step: int, metric: str, value: float,
    fingerprint: Optional[str] = None,
) -> None:
    """Record a new best eval score: the inference weights (EMA when
    tracked) to ``<directory>/best`` and the record to
    ``best_step.json``.  ``fingerprint`` names the eval configuration,
    so a resume with another eval setup does not compare its scores."""
    save_generator_state_dict(os.path.join(directory, BEST_DIR),
                              state.generator_params().state_dict())
    record = {"step": int(step), "metric": metric, "value": float(value)}
    if fingerprint is not None:
        record["eval_fingerprint"] = fingerprint
    with open(os.path.join(directory, BEST_FILE), "w") as f:
        json.dump(record, f)


def best_step(directory: str) -> Optional[dict]:
    """The recorded best-eval step info ({step, metric, value}), or None."""
    path = os.path.join(directory, BEST_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_generator_state_dict(directory: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Inference-only export: ``<directory>/generator.pt``."""
    os.makedirs(directory, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(directory, GENERATOR_FILE))


def load_generator_state_dict(
    directory: str, prefer_ema: bool = True,
    step: Optional[Union[int, str]] = None,
) -> Dict[str, torch.Tensor]:
    """Generator weights (a ``state_dict``) from a checkpoint directory:
    the EMA copy when tracked and ``prefer_ema``, else the raw weights,
    of ``step`` (default: the newest); ``step="best"`` loads the
    ``save_best`` export.  A directory with no numbered steps and a
    ``generator.pt`` (an inference-only export) gives that export."""
    if step == "best":
        path = os.path.join(directory, BEST_DIR, GENERATOR_FILE)
        if best_step(directory) is None or not os.path.exists(path):
            raise FileNotFoundError(f"no best-step record in {directory!r}")
        return torch.load(path, map_location="cpu", weights_only=True)
    export = os.path.join(directory, GENERATOR_FILE)
    if step is None and not _numbered_steps(directory) and os.path.isfile(export):
        return torch.load(export, map_location="cpu", weights_only=True)
    p = _load(directory, step)
    if prefer_ema and p["g_ema"] is not None:
        return p["g_ema"]
    return p["g"]
