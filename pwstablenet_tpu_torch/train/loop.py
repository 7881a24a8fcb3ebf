"""Host training loop, on one device or data-parallel over the ranks of
a process group (one process per GPU).

The device does the math (``train.step``); the host feeds batches, logs
metrics and saves checkpoints.  Batches cross host->device as uint8
from pinned memory with ``non_blocking`` copies, and batch N+1 is
prepared while the card runs step N: nothing in the loop waits on the
card except the metrics fetch at ``log_every`` (and, under
``debug_nans``, the check after every step).  Supports:

- data-parallel execution over a mesh (``parallel.data_parallel_step``);
- resume from the newest checkpoint (``resume=True``);
- JSONL metrics to stdout, and to ``scalar_log_path`` when set;
- TensorBoard event files in ``tb_log_dir`` when set
  (``utils.tb_writer``, no TensorBoard package needed);
- ``debug_nans``: after every step, before its logs, eval or
  checkpoint, one reduction on the card over the step's metrics, G's and
  D's parameters, their Adam moments and the EMA, and one host sync;
  a non-finite value raises ``FloatingPointError`` naming the step and
  where it is, as ``jax_debug_nans`` stops the JAX package's step that
  makes a NaN (and, on every rank of a data-parallel mesh, since the
  gradients are all-reduced);
- fault injection for resume testing (``fault_inject_step``);
- an optional eval hook with best-step tracking.

Under a process group the mesh is the largest one whose size divides
the batch, capped by ``mesh_cfg.num_devices``: every rank restores,
each mesh rank steps on its rows of every batch, and only rank 0 logs,
evaluates and writes checkpoints.  Ranks the mesh leaves out take no
step: they wait at a barrier for the others and return.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from pwstablenet_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from pwstablenet_tpu_torch.data.prefetch import Prefetcher
from pwstablenet_tpu_torch.parallel.mesh import (
    data_parallel_step,
    make_mesh_for_batch,
    replicate_tree,
    shard_batch,
    sync_batch_norm,
)
from pwstablenet_tpu_torch.pipeline import resolve_device
from pwstablenet_tpu_torch.train import checkpoint as ckpt
from pwstablenet_tpu_torch.train.state import TrainState, create_train_state
from pwstablenet_tpu_torch.train.step import make_train_step
from pwstablenet_tpu_torch.utils.tb_writer import SummaryWriter


class FaultInjected(RuntimeError):
    """Raised by the debug fault-injection flag to test resume."""


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch -> device tensors: pinned memory and ``non_blocking``
    copies on the card (the caching host allocator keeps each pinned
    buffer alive until its copy is done)."""
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def _check_finite(state: TrainState, metrics: Dict[str, torch.Tensor], step: int) -> None:
    """Raise ``FloatingPointError`` if the step's metrics, G's or D's
    parameters, their Adam moments or the EMA hold a non-finite value:
    one ``torch._foreach_norm`` per group, reduced on the device and
    fetched in one sync."""
    groups = {
        "metrics": list(metrics.values()),
        "G's parameters": list(state.g.parameters()),
        "D's parameters": list(state.d.parameters()),
        "G's Adam moments": [t for s in state.g_opt.state.values()
                             for k, t in s.items() if k.startswith("exp_avg")],
        "D's Adam moments": [t for s in state.d_opt.state.values()
                             for k, t in s.items() if k.startswith("exp_avg")],
        "the EMA": list(state.g_ema.parameters()) if state.g_ema is not None else [],
    }
    groups = {k: v for k, v in groups.items() if v}
    norms = torch.stack([torch.stack(torch._foreach_norm(v)).amax() for v in groups.values()])
    bad = [name for name, ok in zip(groups, torch.isfinite(norms).tolist()) if not ok]
    if bad:
        what = "metrics" if bad[0] == "metrics" else "state"
        scalars = {k: float(v) for k, v in metrics.items()}
        raise FloatingPointError(
            f"non-finite {what} at step {step} (non-finite: {', '.join(bad)}): {scalars}"
        )


def train(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    batch_iterator: Iterator[dict],
    mesh_cfg: Optional[MeshConfig] = None,
    resume: bool = False,
    max_steps: Optional[int] = None,
    log_fn: Optional[Callable[[dict], None]] = None,
    eval_fn: Optional[Callable[[TrainState], dict]] = None,
    device=None,
) -> TrainState:
    """Run adversarial training on ``device`` (the card unless the caller
    asks for the CPU); returns the final ``TrainState``."""
    device = resolve_device(device)
    state = create_train_state(model_cfg, train_cfg, device)
    if resume and ckpt.latest_step(train_cfg.checkpoint_dir) is not None:
        state = ckpt.restore_state(train_cfg.checkpoint_dir, state)
        print(json.dumps({"event": "resumed", "step": state.step}), file=sys.stderr)

    mesh = make_mesh_for_batch(train_cfg.batch_size, mesh_cfg)
    if not mesh.member:
        dist.barrier()
        return state
    sync_batch_norm(state.g, mesh)
    sync_batch_norm(state.d, mesh)
    replicate_tree(state, mesh)
    step_fn = data_parallel_step(make_train_step(model_cfg, train_cfg), mesh)
    primary = mesh.rank == 0

    total = (
        max_steps if max_steps is not None
        else train_cfg.num_epochs * train_cfg.steps_per_epoch
    )
    log = log_fn or (lambda m: print(json.dumps(m), flush=True))
    if not primary:
        log, eval_fn = (lambda m: None), None
    closers = []
    if train_cfg.scalar_log_path and primary:
        scalar_file = open(train_cfg.scalar_log_path, "a", buffering=1)
        closers.append(scalar_file.close)
        inner_log = log

        def log(m, _inner=inner_log, _f=scalar_file):
            _f.write(json.dumps(m) + "\n")
            _inner(m)

    if train_cfg.tb_log_dir and primary:
        tb = SummaryWriter(train_cfg.tb_log_dir)
        closers.append(tb.close)
        inner_log2 = log

        def log(m, _inner=inner_log2, _tb=tb):
            _tb.add_scalars({k: v for k, v in m.items() if k != "step"},
                            int(m.get("step", 0)))
            _inner(m)

    try:
        state = _run_loop(state, step_fn, batch_iterator, device, mesh, train_cfg,
                          total, log, eval_fn)
    finally:
        for close in closers:
            close()
    if dist.is_initialized() and mesh.size < dist.get_world_size():
        dist.barrier()  # the ranks the mesh left out wait here
    return state


def _run_loop(state, step_fn, batch_iterator, device, mesh, train_cfg, total, log,
              eval_fn=None):
    primary = mesh.rank == 0
    step = state.step
    t_last = time.perf_counter()
    last_logged = step
    # best-eval tracking, resume-aware, but only when the eval
    # configuration matches
    eval_fp = getattr(eval_fn, "fingerprint", None)
    prev_best = ckpt.best_step(train_cfg.checkpoint_dir)
    if primary and prev_best is not None and prev_best.get("eval_fingerprint") != eval_fp:
        print(json.dumps({
            "event": "best_tracking_reset",
            "reason": "eval configuration changed since the recorded best "
                      "(fingerprint mismatch); starting fresh",
            "previous_best": prev_best,
        }), file=sys.stderr)
        prev_best = None
    best_value = prev_best["value"] if prev_best else float("-inf")
    if step >= total:
        return state
    next_batch = batch_to_device(shard_batch(next(batch_iterator), mesh), device)
    while step < total:
        batch = next_batch
        metrics = step_fn(state, batch)
        step += 1
        if step < total:
            next_batch = batch_to_device(shard_batch(next(batch_iterator), mesh), device)
        if train_cfg.debug_nans:
            _check_finite(state, metrics, step)

        if train_cfg.fault_inject_step == step:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            raise FaultInjected(f"injected fault at step {step}")

        if step % train_cfg.log_every == 0 or step == total:
            scalars = {k: float(v) for k, v in metrics.items()}  # sync
            now = time.perf_counter()
            if train_cfg.debug_nans and not all(
                np.isfinite(v) for v in scalars.values()
            ):
                raise FloatingPointError(
                    f"non-finite metrics at step {step}: {scalars}"
                )
            scalars.update(
                step=step,
                sec_per_step=(now - t_last) / max(step - last_logged, 1),
            )
            t_last, last_logged = now, step
            log(scalars)

        if eval_fn is not None and (
            step == total
            or (train_cfg.eval_every > 0 and step % train_cfg.eval_every == 0)
        ):
            scalars = {k: float(v) for k, v in eval_fn(state).items()}
            scalars["step"] = step
            log(scalars)
            if scalars.get("eval_stability", float("-inf")) > best_value:
                best_value = scalars["eval_stability"]
                ckpt.save_best(train_cfg.checkpoint_dir, state, step,
                               "eval_stability", best_value, fingerprint=eval_fp)
                print(json.dumps({"event": "new_best", "step": step,
                                  "eval_stability": best_value}), file=sys.stderr)

        if primary and (step % train_cfg.checkpoint_every == 0 or step == total):
            ckpt.save_state(train_cfg.checkpoint_dir, state, train_cfg.keep_checkpoints)
    return state


def synthetic_batch_iterator(
    model_cfg: ModelConfig, train_cfg: TrainConfig, seed: int = 0,
    rich: bool = False, **clip_kwargs,
) -> "Prefetcher":
    """Endless synthetic DeepStab-like uint8 batches, made on a
    background thread so host-side generation overlaps device compute;
    ``close()`` the returned ``Prefetcher`` to stop the thread.
    ``rich=True`` enables the full scene model (``data.synthetic.RICH``)."""
    from pwstablenet_tpu_torch.data.synthetic import make_train_batch

    h, w = model_cfg.model_resolution

    def gen():
        i = seed
        while True:
            yield make_train_batch(
                train_cfg.batch_size, h, w, model_cfg.temporal_window,
                seed=i, rich=rich, temporal_center=model_cfg.temporal_center,
                **clip_kwargs,
            )
            i += 1

    return Prefetcher(gen(), depth=2)
