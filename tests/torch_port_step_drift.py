"""Why the train-step parity test syncs the whole state between steps,
why its lsgan cases run through ``Kinks``, and why the vanilla GAN
loss's second step is compared on batch 5, not 4 (a diagnostic, not a
test; prints JSON lines).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_step_drift.py [carry | gradient_raw]

With ``carry`` or ``gradient_raw`` it prints only those readings (the
default prints the others, then ``gradient_raw``; about 4 min in all).

1. ``readings``: the parity test's per-step readings (share of G's and
   D's elements within 1e-6 of JAX's, max |diff| / lr) for each GAN loss
   on batches (3, 4), and for vanilla on (3, 5).
2. ``kink``: the vanilla second step on batch 4 from ONE state (the
   port set to JAX's first-step parameters and Adam moments), on the D
   update's own inputs as the port's step makes them.  For each of D's
   leaky-ReLU inputs, the elements whose sign differs between the port
   and JAX, and D's gradient's max difference from ``jax.grad`` relative
   to its largest element: as the port computes it, and with the
   differing elements put on JAX's side of the kink (weights only:
   the norm-fed biases' gradients are rounding noise).
3. ``carry``: for each case of ``test_train_step_matches_jax``, step 1's
   free elements (not norm-fed) of G and D off by more than 1e-6, each
   with its name, flat index, |grad| (JAX's first Adam moment over
   1 - b1) and |diff| / lr; then step 2's share of free elements within
   1e-6 and max |diff| / lr, once with only the norm-fed biases synced
   after step 1 and once with the whole state synced.  Adam's first
   update is about lr * sign(grad), so an element whose gradient is
   within rounding of 0 may land up to 2 lr apart at step 1 on some
   hosts; left unsynced, such elements carry the two sides into step 2
   from different states.
4. ``gradient_raw``: the ``gradient`` pixel loss with the raw temporal
   loss, second step (batch 4) from ONE state, both steps recorded
   through the parity test's ``Kinks``.  ``kinks``: for each kind (the
   G loss's ``abs`` calls, named by stage and term; the ReLU and leaky
   ReLU calls of G, D and the feature extractor, by call), the port's
   elements whose backward takes another branch than JAX's, counted
   where the port's argument is exactly 0 (``torch.abs`` takes 0 there,
   ``jnp.abs`` +1) and listed off 0 with both arguments, and the calls
   with port arguments within 1e-6 of the kink; ``grid_cells_differ``:
   per warp and axis, the sample coordinates in another cell of the
   sampler than JAX's or on a clamp end.  Then ``grad_norm_g`` against
   JAX's and G's share of free elements within 1e-6 and max |diff| / lr
   after the update, for the port's step as computed
   (``as_computed``), with every ``abs`` on JAX's side
   (``abs_on_jax_side``), with every kink on JAX's side
   (``all_on_jax_side``) and as the test runs it (``as_tested``: JAX's
   side within 1e-5 of a kink); ``moved`` counts the elements each
   variant put on JAX's side.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from pwstablenet_tpu.config import ModelConfig as JaxModelConfig
from pwstablenet_tpu.models import PatchDiscriminator as JaxPatchDiscriminator
from pwstablenet_tpu.train import losses as jax_losses

from pwstablenet_tpu_torch.config import ModelConfig
from pwstablenet_tpu_torch.interop.from_jax import tree_to_state_dict
from pwstablenet_tpu_torch.models import discriminator as port_disc
from pwstablenet_tpu_torch.train import losses as port_losses

import sys

from test_torch_port_train import (
    CASES, CPU, KINDS, TCFG, TINY, Kinks, _branch, _pair, _param_diffs, _run_pair,
    _sync_from_jax, batch_to_device, feeds_a_norm, make_train_batch,
)


def kink(gan="vanilla", seeds=(3, 4)):
    over = {**TCFG, "gan_loss": gan}
    jstep, jstate, step, state = _pair(TINY, over)
    batches = [make_train_batch(2, 32, 32, TINY["temporal_window"], seed=s) for s in seeds]
    jstate, _ = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batches[0]))
    step(state, batch_to_device(batches[0], CPU))
    _sync_from_jax(state, jstate, full=True)
    seen = []  # the D update's real and fake pairs come first
    hook = state.d.register_forward_pre_hook(lambda m, a: seen.append(a[0].detach().clone()))
    step(state, batch_to_device(batches[1], CPU))
    hook.remove()
    pairs = seen[:2]

    jd = JaxPatchDiscriminator(JaxModelConfig(**TINY))
    dp = jstate.d_params
    names = ["conv0"] + [f"norm{i}" for i in range(1, TINY["disc_num_layers"] + 1)]
    jax_pos = []  # flax's leaky ReLU keeps x >= 0
    for x in pairs:
        _, inter = jd.apply(dp, jnp.asarray(x.numpy()), capture_intermediates=True)
        for n in names:
            a = np.asarray(inter["intermediates"][n]["__call__"][0])
            jax_pos.append((n, torch.from_numpy(a).permute(0, 3, 1, 2) >= 0, a))

    def jloss(p):
        return jax_losses.gan_loss_d(jd.apply(p, jnp.asarray(pairs[0].numpy())),
                                     jd.apply(p, jnp.asarray(pairs[1].numpy())), gan)

    ref = tree_to_state_dict(jax.device_get(jax.grad(jloss)(dp)))
    d = port_disc.PatchDiscriminator(ModelConfig(**TINY))
    d.load_state_dict(tree_to_state_dict(jax.device_get(dp)))
    leaky = F.leaky_relu
    out = {"gan_loss": gan, "seeds": list(seeds)}
    for follow_jax in (False, True):
        calls, flips = iter(jax_pos), []

        def patched(x, slope):
            name, pos, a = next(calls)
            differ = (x.detach() > 0) != pos
            if differ.any():
                ours = x.detach().permute(0, 2, 3, 1).numpy()
                mask = differ.permute(0, 2, 3, 1).numpy()
                flips.append({"layer": name, "n": int(differ.sum()),
                              "jax": a[mask].tolist(), "port": ours[mask].tolist()})
            return torch.where(pos, x, slope * x) if follow_jax else leaky(x, slope)

        port_disc.F.leaky_relu = patched
        try:
            d.zero_grad()
            port_losses.gan_loss_d(d(pairs[0]), d(pairs[1]), gan).backward()
        finally:
            port_disc.F.leaky_relu = leaky
        rel = max(float((p.grad - ref[n]).abs().max() / ref[n].abs().max())
                  for n, p in d.named_parameters() if n.endswith("weight"))
        key = "on_jax_side" if follow_jax else "as_computed"
        out[key] = {"d_grad_max_rel_diff": rel}
        if not follow_jax:
            out["sign_differs"] = flips
    return out


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
    seeds = over.pop("seeds", (3, 4))
    lr, b1 = over["lr_g"], 0.5
    out = {"case": train_over}
    for full in (False, True):
        jstep, jstate, step, state = _pair(TINY, over)
        batches = [make_train_batch(2, 32, 32, TINY["temporal_window"], seed=s)
                   for s in seeds]
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


def _kink_sides(kind, seen, near=1e-6):
    """Over the recorded calls of ``kind``: the port's elements whose
    backward takes another branch than JAX's, exactly at 0 (a count) and
    off it (each, with the two arguments), and the port's arguments
    within ``near`` of the kink but not on it."""
    out = {"calls": len(seen), "elements": 0, "differ_at_zero": 0,
           "differ_off_zero": [], "near": []}
    for i, (x, ref) in enumerate(seen):
        label = f"stage{i // 7} {ABS_CALLS[i % 7]}" if kind == "abs" else i
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


def gradient_raw(seeds=(3, 4)):
    """The ``gradient``/``raw`` second step from ONE state, as the JAX
    step and the port's compute it, through ``Kinks``."""
    over = {**TCFG, "pixel_loss_mode": "gradient", "temporal_mode": "raw"}
    b1, b2 = [make_train_batch(2, 32, 32, TINY["temporal_window"], seed=s) for s in seeds]
    lr = over["lr_g"]
    out = {"seeds": list(seeds)}
    recorded = None
    variants = {"as_computed": dict(follow=(), strict=False),
                "abs_on_jax_side": dict(follow=("abs",), margin=math.inf, strict=False),
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
                     "moved": taps.moved}
        if name == "as_computed":
            out["kinks"] = {kind: _kink_sides(kind, taps.seen[kind]) for kind in KINDS}
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
    for gan, seeds in (("lsgan", (3, 4)), ("hinge", (3, 4)), ("vanilla", (3, 4)),
                       ("vanilla", (3, 5))):
        print(json.dumps({"readings": _run_pair({"gan_loss": gan, "seeds": seeds},
                                                check=False),
                          "gan_loss": gan, "seeds": list(seeds)}), flush=True)
    print(json.dumps({"kink": kink()}), flush=True)
    print(json.dumps({"gradient_raw": gradient_raw()}), flush=True)
