"""Why the train-step parity test syncs the whole state between steps
and runs every case through ``Kinks``, and what ``Kinks`` moves (a
diagnostic, not a test; prints JSON lines).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_step_drift.py [carry | gradient_raw]

With ``carry`` or ``gradient_raw`` it prints only those readings (the
default prints ``readings``, then ``gradient_raw``; about 3.5 min in
all).

1. ``readings``: for each case of ``test_train_step_matches_jax``, on
   its batches (3, 4), as the test runs it (through ``Kinks``, JAX's
   branch within 1e-5 of a kink): per step, the share of G's and D's
   free elements (not norm-fed) within 1e-6 of JAX's, their max
   |diff| / lr, and ``moved``, the port's arguments that ``Kinks`` put
   on JAX's branch, by stream (a kind and the module that calls it:
   ``losses.abs``, ``losses.maximum`` and ``losses.relu`` of the
   losses, ``blocks.leaky_relu``, ``blocks.relu`` and ``unet.relu`` of
   G, ``discriminator.leaky_relu``, ``features.relu``), every stream
   the step calls, 0 included.  Most of ``losses.abs``'s are exact
   zeros (a feature difference of two ReLU zeros), where ``torch.abs``
   takes 0 and ``jnp.abs`` +1.
2. ``carry``: for each case, step 1's free elements of G and D off by
   more than 1e-6, each with its name, flat index, |grad| (JAX's first
   Adam moment over 1 - b1) and |diff| / lr; then step 2's share of
   free elements within 1e-6 and max |diff| / lr, once with only the
   norm-fed biases synced after step 1 and once with the whole state
   synced.  Adam's first update is about lr * sign(grad), so an element
   whose gradient is within rounding of 0 may land up to 2 lr apart at
   step 1 on some hosts; left unsynced, such elements carry the two
   sides into step 2 from different states.
3. ``gradient_raw``: the ``gradient`` pixel loss with the raw temporal
   loss, second step (batch 4) from ONE state, both steps recorded
   through ``Kinks``.  ``kinks``: for each stream (the G loss's
   ``abs`` calls named by stage and term, the others by call), the
   port's elements whose backward takes another branch than JAX's,
   counted where the port's argument is exactly 0 (``torch.abs`` takes
   0 there, ``jnp.abs`` +1) and listed off 0 with both arguments, and
   the calls with port arguments within 1e-6 of the kink;
   ``grid_cells_differ``: per warp and axis, the sample coordinates in
   another cell of the sampler than JAX's or on a clamp end.  Then
   ``grad_norm_g`` against JAX's and G's share of free elements within
   1e-6 and max |diff| / lr after the update, for the port's step as
   computed (``as_computed``), with every ``abs`` (and the BCE's
   ``maximum``) on JAX's side (``abs_on_jax_side``), with every kink on
   JAX's side (``all_on_jax_side``) and as the test runs it
   (``as_tested``: JAX's side within 1e-5 of a kink); ``moved`` counts
   the elements each variant put on JAX's side.
"""

import json
import math
import sys

import jax
import jax.numpy as jnp
import torch

from pwstablenet_tpu_torch.interop.from_jax import tree_to_state_dict

from test_torch_port_train import (
    CASES, CPU, SEEDS, TCFG, TINY, _pair, _param_diffs, _run_pair, _sync_from_jax,
    batch_to_device, feeds_a_norm, make_train_batch,
)
from torch_port_kinks import Kinks, _branch


def _off(module, jparams, jopt, lr, b1):
    """Free elements of ``module`` more than 1e-6 from JAX's after step 1."""
    ours = module.state_dict()
    ref = tree_to_state_dict(jax.device_get(jparams))
    mu = tree_to_state_dict(jax.device_get(jopt[0].mu))
    off = []
    for name, a in ours.items():
        if feeds_a_norm(name, ours):
            continue
        d = (a - ref[name]).abs().flatten()
        for i in torch.nonzero(d > 1e-6).flatten().tolist():
            off.append({"name": name, "index": i,
                        "abs_grad": float(mu[name].flatten()[i].abs()) / (1 - b1),
                        "diff_over_lr": float(d[i]) / lr})
    return off


def carry(train_over):
    over = {**TCFG, **train_over}
    lr, b1 = over["lr_g"], 0.5
    out = {"case": train_over}
    for full in (False, True):
        jstep, jstate, step, state = _pair(TINY, over)
        batches = [make_train_batch(2, 32, 32, TINY["temporal_window"], seed=s)
                   for s in SEEDS]
        jstate, _ = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batches[0]))
        step(state, batch_to_device(batches[0], CPU))
        if not full:
            out["step1_off"] = {
                "G": _off(state.g, jstate.g_params, jstate.g_opt, lr, b1),
                "D": _off(state.d, jstate.d_params, jstate.d_opt, lr, b1)}
        _sync_from_jax(state, jstate, full=full)
        jstate, _ = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batches[1]))
        step(state, batch_to_device(batches[1], CPU))
        out["step2_full_sync" if full else "step2_partial_sync"] = {
            what: {"share": float((free <= 1e-6).double().mean()),
                   "max_diff_over_lr": float(free.max()) / lr}
            for what, (_, free) in (("G", _param_diffs(state.g, jstate.g_params)),
                                    ("D", _param_diffs(state.d, jstate.d_params)))}
    return out


# the G loss's abs calls of one stage, in order (gradient pixel loss,
# two feature scales, raw temporal loss, warp smoothness)
ABS_CALLS = ("pixel dy", "pixel dx", "feature 0", "feature 1", "temporal",
             "warp_reg dy", "warp_reg dx")


def _kink_sides(stream, seen, near=1e-6):
    """Over the recorded calls of ``stream``: the port's elements whose
    backward takes another branch than JAX's, exactly at 0 (a count) and
    off it (each, with the two arguments), and the port's arguments
    within ``near`` of the kink but not on it."""
    kind = stream.split(".")[1]
    out = {"calls": len(seen), "elements": 0, "differ_at_zero": 0,
           "differ_off_zero": [], "near": []}
    for i, (x, ref) in enumerate(seen):
        label = f"stage{i // 7} {ABS_CALLS[i % 7]}" if stream == "losses.abs" else i
        differ = _branch(kind, x, 0.2, False) != _branch(kind, ref, 0.2, True)
        off = differ & (x != 0)
        out["elements"] += x.numel()
        out["differ_at_zero"] += int((differ & (x == 0)).sum())
        if off.any():
            out["differ_off_zero"].append({"call": label, "port": x[off].tolist(),
                                           "jax": ref[off].tolist()})
        n = int(((x.abs() < near) & (x != 0)).sum())
        if n:
            out["near"].append({"call": label, "n": n})
    return out


def gradient_raw(seeds=SEEDS):
    """The ``gradient``/``raw`` second step from ONE state, as the JAX
    step and the port's compute it, through ``Kinks``."""
    over = {**TCFG, "pixel_loss_mode": "gradient", "temporal_mode": "raw"}
    b1, b2 = [make_train_batch(2, 32, 32, TINY["temporal_window"], seed=s) for s in seeds]
    lr = over["lr_g"]
    out = {"seeds": list(seeds)}
    recorded = None
    variants = {"as_computed": dict(follow=(), strict=False),
                "abs_on_jax_side": dict(follow=("abs", "maximum"), margin=math.inf,
                                        strict=False),
                "all_on_jax_side": dict(margin=math.inf, strict=False),
                "as_tested": {}}
    for name, kw in variants.items():
        jstep, jstate, step, state = _pair(TINY, over)
        jstate, _ = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, b1))
        step(state, batch_to_device(b1, CPU))
        _sync_from_jax(state, jstate, full=True)
        taps = Kinks(**kw)
        if recorded is None:  # a step not yet traced, traced through the taps
            fresh = _pair(TINY, over)[0]
            with taps.jax():
                recorded = fresh(jstate, jax.tree_util.tree_map(jnp.asarray, b2)), taps.values
        (jstate, jm), taps.values = recorded
        with taps.port():
            m = step(state, batch_to_device(b2, CPU))
        diff, free = _param_diffs(state.g, jstate.g_params)
        out[name] = {"grad_norm_g": float(m["grad_norm_g"]),
                     "jax_grad_norm_g": float(jm["grad_norm_g"]),
                     "rel": abs(float(m["grad_norm_g"]) / float(jm["grad_norm_g"]) - 1),
                     "G_share_within_1e-6": float((free <= 1e-6).double().mean()),
                     "G_free_max_diff_over_lr": float(free.max()) / lr,
                     "G_max_diff_over_lr": float(diff.max()) / lr,
                     "moved": dict(taps.moved)}
        if name == "as_computed":
            out["kinks"] = {s: _kink_sides(s, seen) for s, seen in taps.seen.items()
                            if s != "grid"}
            out["grid_cells_differ"] = taps.seen["grid"]
    return out


if __name__ == "__main__":
    if sys.argv[1:] == ["gradient_raw"]:
        print(json.dumps({"gradient_raw": gradient_raw()}), flush=True)
        sys.exit(0)
    if sys.argv[1:] == ["carry"]:
        for case in CASES:
            print(json.dumps({"carry": carry(case)}), flush=True)
        sys.exit(0)
    for case in CASES:
        print(json.dumps({"readings": _run_pair(case, check=False), "case": case}), flush=True)
    print(json.dumps({"gradient_raw": gradient_raw()}), flush=True)
