"""The JAX package's Orbax checkpoints, read without JAX or ``orbax``.

The JAX package saves with orbax's ``StandardCheckpointer`` (an
inference export, ``save_params``) and ``CheckpointManager`` (a training
run: ``<dir>/<step>/default``).  Both write an OCDBT key-value store of
zarr arrays, and a ``_METADATA`` JSON file that lists every leaf of the
saved tree by its path of keys.  This module reads that file and each
array through ``tensorstore`` (one extra package, which imports no
JAX), and hands the numpy trees to ``interop.from_jax``:

- ``read_orbax_tree``: any such checkpoint -> nested dicts of numpy
  arrays (``None`` leaves, such as an untracked ``g_ema``, are left out);
- ``load_orbax_generator_state_dict``: the generator's weights as the
  port's ``state_dict``, as the JAX package's ``load_generator_params``
  picks them (an export; a run's newest or named step, its EMA when
  tracked; ``step="best"``);
- ``restore_state_from_orbax``: a JAX training run's step into the
  port's ``TrainState``, to continue it in the port.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from pwstablenet_tpu_torch.config import ModelConfig
from pwstablenet_tpu_torch.interop.from_jax import (
    jax_params_to_state_dict,
    tree_to_state_dict,
)

METADATA_FILE = "_METADATA"
CHECKPOINT_METADATA_FILE = "_CHECKPOINT_METADATA"
ITEM_DIR = "default"  # a CheckpointManager step's one item


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading the JAX package's Orbax checkpoints needs the "
            "'tensorstore' package"
        ) from e
    return tensorstore


def orbax_steps(directory: str) -> List[int]:
    """The numbered steps of a ``CheckpointManager`` directory."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name) for name in os.listdir(directory)
        if name.isdigit() and os.path.isdir(os.path.join(directory, name, ITEM_DIR))
    )


def is_orbax_checkpoint(path: str) -> bool:
    """Whether ``path`` is an orbax save (an export, or one step's item)
    or a ``CheckpointManager`` directory."""
    return os.path.isdir(path) and (
        any(os.path.isfile(os.path.join(path, f))
            for f in (CHECKPOINT_METADATA_FILE, METADATA_FILE))
        or bool(orbax_steps(path))
    )


def read_orbax_tree(path: str, subtrees: Optional[Sequence[str]] = None) -> Dict:
    """One orbax save -> nested dicts of numpy arrays, keyed as the
    saved tree (sequence indices as strings).  ``subtrees``: read only
    the entries under these top-level keys."""
    ts = _tensorstore()
    with open(os.path.join(path, METADATA_FILE)) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path!r} is not an OCDBT checkpoint; only those are read")
    base = {
        "driver": "zarr3" if meta.get("use_zarr3") else "zarr",
        "kvstore": {"driver": "ocdbt", "base": "file://" + os.path.abspath(path)},
    }
    context = ts.Context()
    pending = []
    for entry in meta["tree_metadata"].values():
        if entry["value_metadata"].get("skip_deserialize"):
            continue
        keys = [k["key"] for k in entry["key_metadata"]]
        if subtrees is not None and keys[0] not in subtrees:
            continue
        spec = {**base, "path": ".".join(keys)}
        pending.append((keys, ts.open(spec, open=True, read=True, context=context)))
    reads = [(keys, opened.result().read()) for keys, opened in pending]
    tree: Dict = {}
    for keys, read in reads:
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(read.result())
    return tree


def load_orbax_generator_state_dict(
    path: str, cfg: ModelConfig, prefer_ema: bool = True,
    step: Optional[Union[int, str]] = None,
) -> Dict[str, torch.Tensor]:
    """Generator weights from either kind of the JAX package's
    checkpoint, as the port's ``state_dict``:

    - a ``CheckpointManager`` directory (numbered steps, as its train
      loop writes them): ``step`` (default: the newest); its EMA weights
      when tracked and ``prefer_ema``, else the raw ones;
      ``step="best"`` reads the export that its best-eval tracking
      wrote (``best_step.json`` and ``best/``);
    - a ``save_params`` export: its weights."""
    from pwstablenet_tpu_torch.train.checkpoint import BEST_DIR, best_step

    if step == "best":
        info = best_step(path)
        best_dir = os.path.join(path, BEST_DIR)
        if info is None or not os.path.isdir(best_dir):
            raise FileNotFoundError(
                f"no best-step record in {path!r} (run training with "
                "--eval-every so the loop can track the best eval score)"
            )
        return jax_params_to_state_dict(read_orbax_tree(best_dir), cfg)
    steps = orbax_steps(path)
    if step is None:
        step = steps[-1] if steps else None
    elif step not in steps:
        hint = ""
        info = best_step(path)
        if info is not None:
            hint = (
                f"; 'best' export available (step {info['step']}, "
                f"{info['metric']}={info['value']:.4f})"
            )
        raise FileNotFoundError(
            f"step {step} not found in {path!r} — available: {steps} "
            f"(older steps are pruned by keep_checkpoints){hint}"
        )
    if step is None:
        return jax_params_to_state_dict(read_orbax_tree(path), cfg)
    item = os.path.join(path, str(step), ITEM_DIR)
    if prefer_ema:
        ema = read_orbax_tree(item, subtrees=("g_ema",)).get("g_ema")
        if ema:  # a tracked EMA; an untracked one is a None leaf, not read
            return jax_params_to_state_dict(ema, cfg)
    return jax_params_to_state_dict(
        read_orbax_tree(item, subtrees=("g_params",))["g_params"], cfg)


def _load_adam(module: torch.nn.Module, opt: torch.optim.Adam,
               sched: torch.optim.lr_scheduler.LambdaLR, jopt: Dict) -> None:
    """optax ``adam``'s state, ``(ScaleByAdamState(count, mu, nu),
    ScaleByScheduleState(count))`` -> torch Adam's ``step``, ``exp_avg``
    and ``exp_avg_sq`` for every parameter of ``module``, and the
    scheduler at the schedule's count."""
    adam, schedule = jopt["0"], jopt["1"]
    mu, nu = tree_to_state_dict(adam["mu"]), tree_to_state_dict(adam["nu"])
    count = float(adam["count"])
    names = [n for n, _ in module.named_parameters()]
    sd = opt.state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(count), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
        for i, n in enumerate(names)
    }
    opt.load_state_dict(sd)
    sched.last_epoch = int(schedule["count"])
    lrs = [base * factor(sched.last_epoch)
           for base, factor in zip(sched.base_lrs, sched.lr_lambdas)]
    for group, lr in zip(opt.param_groups, lrs):
        group["lr"] = lr
    sched._last_lr = lrs


def restore_state_from_orbax(directory: str, state, step: Optional[int] = None):
    """Load step ``step`` (default: the newest) of a JAX training run's
    ``CheckpointManager`` directory into the port's ``TrainState``, in
    place, and return it: the three models' weights, both Adam states
    and learning-rate schedules, the EMA (under the port's rules for a
    run that switches EMA tracking on or off) and the step.

    The JAX run's PRNG key has no torch counterpart: the dropout
    generator is seeded from the port run's seed and the restored
    step."""
    from pwstablenet_tpu_torch.train.checkpoint import reconcile_ema

    steps = orbax_steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint found in {directory!r}")
        step = steps[-1]
    elif step not in steps:
        raise FileNotFoundError(
            f"step {step} not found in {directory!r}; available: {steps}"
        )
    tree = read_orbax_tree(os.path.join(directory, str(step), ITEM_DIR))
    state.g.load_state_dict(jax_params_to_state_dict(tree["g_params"], state.g.cfg))
    state.d.load_state_dict(tree_to_state_dict(tree["d_params"]))
    state.feat.load_state_dict(tree_to_state_dict(tree["feat_params"]))
    _load_adam(state.g, state.g_opt, state.g_sched, tree["g_opt"])
    _load_adam(state.d, state.d_opt, state.d_sched, tree["d_opt"])
    state.step = int(tree["step"])
    state.rng.manual_seed((state.rng.initial_seed() + state.step) % 2**63)
    ema = tree.get("g_ema")
    return reconcile_ema(
        state, jax_params_to_state_dict(ema, state.g.cfg) if ema else None)
