"""The port's train step vs the JAX train step on the CPU, and the
port's training loop, checkpoints and dropout generator.

Parity: both sides start from the JAX package's ``create_train_state``
parameters, with the zero-initialised warp heads redrawn at std 1e-2 on
both sides (zero heads put every grid exactly on the identity, where
the JAX CPU step's XLA sampler and the TPU kernel that the port follows
split the gradient differently; see tests/test_torch_port_grad.py), and
take two steps on the same batches.  Tolerances: losses, terms and
grad norms rtol 1e-4; parameters <= 1e-6 on >= 99.9 % of the elements,
and everywhere at most twice the most that Adam can move one element:
Adam's first update is about lr*sign(g), so rounding may flip elements
whose gradient is ~0.  One update moves an element by at most
lr * bound(t) (``_adam_step_bound``): 1 at the first step, 1.054 at the
second with b1 = 0.5, b2 = 0.999.  The biases of convs that feed an
instance norm have a gradient that is zero but for rounding (the norm
removes any per-channel constant), so Adam moves them by ~lr in a
direction set by rounding noise in each framework: they are held to the
bound only and left out of the 99.9 % share.  After each step's checks
the port's whole state (parameters, Adam's moments, the EMA) is set to
the JAX step's, so that each compared step starts from one state on
both sides: a free element whose gradient is within rounding of 0 can
also land up to 2 lr apart at step 1, depending on the host's rounding
(0.50 lr on one host), and carried into step 2 such elements left only
0.947 of G's elements within 1e-6 there; from one state the share is
1.0 (``tests/torch_port_step_drift.py carry``).

The tolerance also needs every argument of a kink (``abs`` in the
losses, the vanilla BCE's ``maximum(x, 0)``, a ReLU or leaky-ReLU input,
a sample coordinate of a warp) to lie on the same side of it in both
packages.  An argument within rounding of the kink falls on either side
depending on the host, and moves G's or D's gradient by a whole branch.
With the gradient pixel loss and the raw temporal loss, batch 4 puts one
argument of stage 1's ``abs(dy)`` at +7.45e-8 in the port and -5.96e-8
in JAX on one host: ``grad_norm_g`` then differs by 2.3e-4 relative and
only 0.875 of G's elements lie within 1e-6; with that element on JAX's
side, 2.1e-7 and 1.0 (``tests/torch_port_step_drift.py gradient_raw``).
With the vanilla GAN loss, batch 4 puts one of D's leaky-ReLU inputs at
-5.83e-7 in JAX and +5.84e-7 in the port, so its slope differs (1 vs
0.2).  So every case runs its steps through ``Kinks``
(``tests/torch_port_kinks.py``), on the same batches: the port takes
JAX's branch at every argument within 1e-5 of a kink, and the test
fails before it compares if an argument farther away, or a sample
coordinate, lies on another side than JAX's, or if the port's step
calls a kink's function, or the sampler, another number of times than
JAX's.  ``tests/torch_port_step_drift.py`` prints how many arguments
each case moves to JAX's branch."""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from pwstablenet_tpu.config import ModelConfig as JaxModelConfig
from pwstablenet_tpu.config import TrainConfig as JaxTrainConfig
from pwstablenet_tpu.train import create_train_state as jax_create_train_state
from pwstablenet_tpu.train import losses as jax_losses
from pwstablenet_tpu.train import make_train_step as jax_make_train_step

from pwstablenet_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from pwstablenet_tpu_torch.data.synthetic import make_train_batch
from pwstablenet_tpu_torch.interop.from_jax import (
    jax_params_to_state_dict,
    tree_to_state_dict,
)
from pwstablenet_tpu_torch.models.discriminator import PatchDiscriminator
from pwstablenet_tpu_torch.models.features import FeatureExtractor
from pwstablenet_tpu_torch.models.generator import CascadedGenerator
from pwstablenet_tpu_torch.train import checkpoint as ckpt
from pwstablenet_tpu_torch.train import losses as port_losses
from pwstablenet_tpu_torch.train.loop import (
    FaultInjected,
    batch_to_device,
    synthetic_batch_iterator,
    train,
)
from pwstablenet_tpu_torch.train.state import (
    create_train_state,
    feeds_a_norm,
    make_train_state,
)
from pwstablenet_tpu_torch.train.step import make_train_step

from chip_smoke import frozen_logit_scale
from torch_port_kinks import KINDS, Kinks, _branch

# the TINY config of tests/test_train_step.py
TINY = dict(
    temporal_window=3, num_levels=4, base_features=8, max_features=16,
    model_resolution=(32, 32), num_stages=2, disc_num_layers=2,
    feat_channels=(8, 16), compute_dtype="float32",
)
TCFG = dict(batch_size=2, num_epochs=1, steps_per_epoch=10, lr_g=2e-4, lr_d=2e-4)
CPU = torch.device("cpu")


def _redraw_heads(params, seed, std=1e-2):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        keys = [getattr(k, "key", None) for k in path]
        if "head" in keys:
            return (rng.standard_normal(np.shape(x)) * std).astype(np.float32)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _pair(model_over, train_over):
    """(jax step, jax state, port step, port state) from one init."""
    jcfg, cfg = JaxModelConfig(**model_over), ModelConfig(**model_over)
    jtcfg, tcfg = JaxTrainConfig(**train_over), TrainConfig(**train_over)
    jstate, (gen, disc, feat) = jax_create_train_state(jcfg, jtcfg, jax.random.PRNGKey(0))
    g_params = _redraw_heads(jstate.g_params, seed=7)
    jstate = jstate.replace(
        g_params=jax.tree_util.tree_map(jnp.asarray, g_params),
        g_ema=(jax.tree_util.tree_map(jnp.asarray, g_params)
               if jtcfg.ema_decay > 0 else None),
    )
    g = CascadedGenerator(cfg)
    g.load_state_dict(jax_params_to_state_dict(g_params, cfg))
    d = PatchDiscriminator(cfg)
    d.load_state_dict(tree_to_state_dict(jax.device_get(jstate.d_params)))
    f = FeatureExtractor(cfg)
    f.load_state_dict(tree_to_state_dict(jax.device_get(jstate.feat_params)))
    state = make_train_state(tcfg, g, d, f, torch.Generator().manual_seed(0), CPU)
    jstep = jax.jit(jax_make_train_step(jcfg, jtcfg, gen, disc, feat))
    return jstep, jstate, make_train_step(cfg, tcfg), state


def _adam_step_bound(t, b1=0.5, b2=0.999):
    """max |m_hat| / sqrt(v_hat) over all gradient histories at step t:
    by Cauchy-Schwarz over the weighted gradients."""
    w1 = np.array([b1 ** (t - 1 - k) for k in range(t)]) * (1 - b1) / (1 - b1**t)
    w2 = np.array([b2 ** (t - 1 - k) for k in range(t)]) * (1 - b2) / (1 - b2**t)
    return float(np.sqrt(np.sum(w1**2 / w2)))


def _param_diffs(module, jax_params):
    """|port - JAX| of every element, and of those not norm-fed."""
    ours = module.state_dict()
    ref = tree_to_state_dict(jax.device_get(jax_params))
    assert set(ours) == set(ref)
    diffs, free = [], []
    for name, a in ours.items():
        d = (a - ref[name]).abs().flatten()
        diffs.append(d)
        if not feeds_a_norm(name, ours):
            free.append(d)
    return torch.cat(diffs), torch.cat(free)


def _assert_params_close(module, jax_params, lr, steps, what):
    diff, free = _param_diffs(module, jax_params)
    bound = 2 * lr * sum(_adam_step_bound(t) for t in range(1, steps + 1))
    assert diff.max() <= bound * (1 + 1e-3), f"{what}: max |diff| {diff.max()} > {bound}"
    share = float((free <= 1e-6).double().mean())
    assert share >= 0.999, f"{what}: only {share:.5f} of elements within 1e-6"


@torch.no_grad()
def _sync_from_jax(state, jstate, full=False):
    """Set the port's norm-fed conv biases to the JAX step's values, or
    (``full``) every parameter, Adam's moments and the EMA, so that the
    next step starts from one state on both sides."""
    for module, opt, jparams, jopt in ((state.g, state.g_opt, jstate.g_params, jstate.g_opt),
                                       (state.d, state.d_opt, jstate.d_params, jstate.d_opt)):
        names = module.state_dict().keys()
        ref = tree_to_state_dict(jax.device_get(jparams))
        mu = tree_to_state_dict(jax.device_get(jopt[0].mu))
        nu = tree_to_state_dict(jax.device_get(jopt[0].nu))
        for name, p in module.named_parameters():
            if full or feeds_a_norm(name, names):
                p.copy_(ref[name])
            if full:
                opt.state[p]["exp_avg"].copy_(mu[name])
                opt.state[p]["exp_avg_sq"].copy_(nu[name])
    if full and state.g_ema is not None:
        state.g_ema.load_state_dict(tree_to_state_dict(jax.device_get(jstate.g_ema)))

SEEDS = (3, 4)  # the batches of the two compared steps


def _step_both(taps, jstep, jstate, step, state, batch):
    """The JAX step and the port's on ``batch``, through ``taps`` (trace
    and run ``jstep`` under one ``Kinks``: it records into the one it was
    traced under)."""
    with taps.jax():
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
    with taps.port():
        m = step(state, batch_to_device(batch, CPU))
    taps.assert_all_matched()
    return jstate, jm, m


def _assert_step_close(m, jm, state, jstate, lr, updates, scales=None):
    """The metrics, G, D, the feature extractor and the EMA after a step
    against JAX's, ``updates`` Adam updates into the run.  A metric is
    held within 1e-4 of its value, plus 1e-4 of its scale in ``scales``
    where given: the mean magnitude of the terms that it averages."""
    assert set(m) == set(jm)
    scales = scales or {}
    for k in jm:
        assert m[k].device == CPU and m[k].dim() == 0
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-4 * scales.get(k, 0.0), err_msg=k)
    _assert_params_close(state.g, jstate.g_params, lr, updates, "G")
    _assert_params_close(state.d, jstate.d_params, lr, updates, "D")
    _assert_params_close(state.feat, jstate.feat_params, 0.0, updates, "feat")
    if jstate.g_ema is not None:
        _assert_params_close(state.g_ema, jstate.g_ema, lr, updates, "EMA")


def _run_pair(train_over, check=True, model_over=None, hinge_at_scale=False):
    """Both steps on ``SEEDS``, through ``Kinks``, at ``TINY`` with
    ``model_over``; after each step's
    checks the port's whole state is set to JAX's, so each step starts
    from one state on both sides.  ``hinge_at_scale``: the hinge
    adversarial term is held at the scale of its logits
    (``chip_smoke.frozen_logit_scale``).  Returns, per step, the share of G's
    and D's elements that do not feed a norm within 1e-6, their max
    |diff| / lr, and the arguments ``Kinks`` moved to JAX's branch, by
    stream."""
    over = {**TCFG, **train_over}
    model = {**TINY, **(model_over or {})}
    jstep, jstate, step, state = _pair(model, over)
    taps = Kinks(model.get("align_corners", True), accum=over.get("grad_accum_steps", 1),
                 stages=model["num_stages"], interstage=model.get("interstage", "both"))
    lr = over["lr_g"]
    logits = None
    if hinge_at_scale and over.get("gan_loss") == "hinge":
        logits = frozen_logit_scale(state.d)
    readings = []
    for n, seed in enumerate(SEEDS, start=1):
        batch = make_train_batch(2, 32, 32, model["temporal_window"], seed=seed)
        if logits is not None:
            logits.clear()
        jstate, jm, m = _step_both(taps, jstep, jstate, step, state, batch)
        readings.append({
            **{what: (float((free <= 1e-6).double().mean()), float(free.max()) / lr)
               for what, (_, free) in (("G", _param_diffs(state.g, jstate.g_params)),
                                       ("D", _param_diffs(state.d, jstate.d_params)))},
            "moved": dict(taps.moved)})
        if check:
            assert state.step == int(jstate.step) == n
            scales = {"adv": float(np.mean(logits))} if logits else None
            _assert_step_close(m, jm, state, jstate, lr, n, scales)
        _sync_from_jax(state, jstate, full=True)
    return readings


CASES = [
    {"pixel_loss_mode": p, "temporal_mode": t}
    for p in ("l1", "mean_matched", "gradient") for t in ("raw", "compensated")
] + [{"grad_accum_steps": 2}, {"ema_decay": 0.9}, {"gan_loss": "hinge"},
     {"gan_loss": "vanilla"}]


@pytest.mark.parametrize(
    "train_over", CASES, ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()),
)
def test_train_step_matches_jax(train_over):
    _run_pair(train_over)


@pytest.mark.parametrize("kind", KINDS + ("bce",))
def test_each_package_takes_its_own_branch_at_the_kink(kind):
    """What each side's backward does on and around each kink, as
    ``Kinks`` models it: at exactly 0 ``torch.abs`` takes 0 and
    ``jnp.abs`` +1, torch's leaky ReLU takes its slope and flax's 1,
    torch's ``clamp(x, min=0)`` 1 and ``jnp.maximum(x, 0)`` 0.5; both
    ReLUs take 0.  The BCE with logits pairs the last with ``abs``: at a
    zero logit
    ``jax.grad`` gives -t and torch 1 - t (the true derivative is
    0.5 - t); away from 0 both give ``sigmoid(x) - t``, and ``Kinks``'s
    two branches together give each package's derivative."""
    import flax.linen as nn

    x = np.array([-1e-7, -0.0, 0.0, 1e-7, 2.0], np.float32)
    if kind == "bce":
        xt = torch.from_numpy(x)
        for target in (0.0, 1.0):
            t = xt.clone().requires_grad_(True)
            port_losses._bce_with_logits(t, target).sum().backward()
            theirs = np.asarray(jax.grad(lambda v: jnp.sum(
                jax_losses._bce_with_logits(v, target)))(jnp.asarray(x)))
            assert (float(t.grad[2]), float(theirs[2])) == (1.0 - target, -target)
            off = np.abs(x) > 0
            smooth = torch.sigmoid(xt).numpy() - target
            np.testing.assert_allclose(t.grad.numpy()[off], smooth[off], atol=1e-6)
            np.testing.assert_allclose(theirs[off], smooth[off], atol=1e-6)
            for got, jax_side in ((t.grad.numpy(), False), (theirs, True)):
                model = (_branch("maximum", xt, 0, jax_side) - target
                         - torch.sigmoid(-xt.abs()) * _branch("abs", xt, 0, jax_side))
                np.testing.assert_allclose(got, model.numpy(), atol=1e-7)
        return
    fns = {"abs": (torch.abs, jnp.abs), "relu": (F.relu, nn.relu),
           "leaky_relu": (lambda v: F.leaky_relu(v, 0.2),
                          lambda v: nn.leaky_relu(v, negative_slope=0.2)),
           "maximum": (lambda v: torch.clamp(v, min=0.0), lambda v: jnp.maximum(v, 0.0))}
    port_fn, jax_fn = fns[kind]
    t = torch.from_numpy(x).requires_grad_(True)
    port_fn(t).sum().backward()
    theirs = np.asarray(jax.grad(lambda v: jnp.sum(jax_fn(v)))(jnp.asarray(x)))
    np.testing.assert_array_equal(t.grad.numpy(), _branch(kind, t.detach(), 0.2, False).numpy())
    np.testing.assert_array_equal(theirs, _branch(kind, torch.from_numpy(x), 0.2, True).numpy())
    at_zero = {"abs": (0.0, 1.0), "relu": (0.0, 0.0), "leaky_relu": (0.2, 1.0),
               "maximum": (1.0, 0.5)}[kind]
    assert (float(t.grad[2]), float(theirs[2])) == pytest.approx(at_zero)


def test_kinks_follow_jax_near_the_kink_and_fail_beyond_the_margin():
    """Within the margin the port's backward takes JAX's branch; an
    argument farther away on the other side than JAX's fails the step.
    The BCE's pair near 0 takes JAX's derivative, -t at a zero logit."""
    taps = Kinks()
    taps.grid_calls, taps.jax_grids = (), 0
    taps.values["losses.abs"] = [np.array([-1e-3, 5e-6], np.float32)] * 2
    x = torch.tensor([-1e-3, -5e-6], requires_grad=True)
    with taps.port():
        port_losses.torch.abs(x).sum().backward()
        assert x.grad.tolist() == [-1.0, 1.0] and taps.moved["losses.abs"] == 1
        with pytest.raises(AssertionError, match="take another branch than JAX's"):
            port_losses.torch.abs(torch.tensor([1e-3, 5e-6]))
    assert port_losses.torch is torch
    zero = np.zeros(3, np.float32)
    taps.values.update({"losses.maximum": [zero], "losses.abs": [zero]})
    x = torch.zeros(3, requires_grad=True)
    with taps.port():
        port_losses._bce_with_logits(x, 1.0).sum().backward()
    taps.assert_all_matched()
    assert x.grad.tolist() == [-1.0] * 3
    assert taps.moved == {"losses.maximum": 3, "losses.abs": 3}


def test_kinks_record_each_micro_batch_of_a_scan_and_hold_the_call_counts():
    """A tapped call inside ``lax.scan`` records once per iteration, in
    the order the iterations run, at every run of the jitted function;
    the port calling it fewer or more times than JAX fails."""
    taps = Kinks()
    taps.grid_calls, taps.jax_grids = (), 0

    @jax.jit
    def scanned(xs):
        def micro(total, x):
            return total + jax_losses.pixel_loss(x, jnp.zeros_like(x)), None
        return jax.lax.scan(micro, 0.0, xs)[0]

    xs = np.arange(12, dtype=np.float32).reshape(3, 4) - 5.5
    for run in (xs, -xs):
        with taps.jax():
            scanned(run)
        assert [r.tolist() for r in taps.values["losses.abs"]] == run.tolist()
    for calls, match in ((2, "port .*losses.abs.: 2.*JAX .*losses.abs.: 3"),
                         (4, "calls it more often than JAX's")):
        with pytest.raises(AssertionError, match=match):
            with taps.port():
                for x in np.resize(-xs, (calls, 4)):
                    port_losses.pixel_loss_photometric(torch.from_numpy(x), torch.zeros(4))
            taps.assert_all_matched()
    with taps.port():
        for x in -xs:
            port_losses.pixel_loss_photometric(torch.from_numpy(x), torch.zeros(4))
    taps.assert_all_matched()


def test_step_updates_g_and_d_and_keeps_feat_frozen():
    state = create_train_state(ModelConfig(**TINY), TrainConfig(**TCFG), CPU)
    step = make_train_step(ModelConfig(**TINY), TrainConfig(**TCFG))
    before = {m: {n: p.clone() for n, p in getattr(state, m).named_parameters()}
              for m in ("g", "d", "feat")}
    m = step(state, batch_to_device(make_train_batch(2, 32, 32, 3, seed=1), CPU))
    assert all(torch.isfinite(v) for v in m.values())

    def changed(name):
        return [n for n, p in getattr(state, name).named_parameters()
                if not torch.equal(before[name][n], p)]

    assert len(changed("d")) == len(before["d"])
    # at step 1 only the zero-init warp heads get nonzero gradients
    assert "stage1.head.weight" in changed("g")
    assert changed("feat") == []
    assert all(p.requires_grad for p in state.d.parameters())  # unfrozen again


def test_step_rejects_unknown_modes():
    for over in ({"temporal_mode": "none"}, {"pixel_loss_mode": "l2"}):
        with pytest.raises(ValueError, match="unknown"):
            make_train_step(ModelConfig(**TINY), TrainConfig(**TCFG, **over))


def _dropout_losses(rng_seed, global_seed):
    cfg = ModelConfig(**{**TINY, "use_dropout": True})
    tcfg = TrainConfig(**TCFG)
    state = create_train_state(cfg, tcfg, CPU)
    with torch.no_grad():  # nonzero heads: fresh heads hide any dropout
        for s in range(cfg.num_stages):
            head = getattr(state.g, f"stage{s}").head
            head.weight.copy_(torch.randn(head.weight.shape,
                                          generator=torch.Generator().manual_seed(s)) * 1e-2)
    state.rng.manual_seed(rng_seed)
    torch.manual_seed(global_seed)
    step = make_train_step(cfg, tcfg)
    batch = batch_to_device(make_train_batch(2, 32, 32, 3, seed=2), CPU)
    return [float(v) for m in (step(state, batch), step(state, batch)) for v in m.values()]


def test_dropout_draws_from_the_state_generator():
    """Same state seed: identical losses, whatever the global RNG; another
    state seed: other dropout masks, other losses."""
    a = _dropout_losses(rng_seed=1, global_seed=0)
    assert a == _dropout_losses(rng_seed=1, global_seed=123)
    assert a != _dropout_losses(rng_seed=2, global_seed=0)


# ----------------------------------------------------------------- loop --

@pytest.fixture
def batches():
    """``synthetic_batch_iterator`` whose threads stop at teardown."""
    made = []

    def make(cfg, tcfg):
        made.append(synthetic_batch_iterator(cfg, tcfg))
        return made[-1]

    yield make
    for it in made:
        it.close()


def _loop_cfg(tmp_path, **over):
    return TrainConfig(**{**TCFG, "checkpoint_dir": str(tmp_path / "ckpt"),
                          "log_every": 1, **over})


def test_train_logs_jsonl_and_checkpoints(tmp_path, batches):
    cfg = ModelConfig(**TINY)
    log_path = tmp_path / "scalars.jsonl"
    tcfg = _loop_cfg(tmp_path, scalar_log_path=str(log_path), checkpoint_every=2,
                     keep_checkpoints=1)
    seen = []
    state = train(cfg, tcfg, batches(cfg, tcfg), max_steps=3,
                  log_fn=seen.append, device="cpu")
    assert state.step == 3
    lines = [json.loads(s) for s in log_path.read_text().splitlines()]
    assert lines == seen and [m["step"] for m in lines] == [1, 2, 3]
    assert all(np.isfinite(m["loss_g"]) and m["sec_per_step"] > 0 for m in lines)
    assert ckpt.latest_step(tcfg.checkpoint_dir) == 3
    assert sorted(os.listdir(tcfg.checkpoint_dir)) == ["3"]  # keep=1 pruned step 2


def test_fault_injection_then_resume(tmp_path, capsys, batches):
    cfg = ModelConfig(**TINY)
    tcfg = _loop_cfg(tmp_path, checkpoint_every=1, fault_inject_step=2)
    with pytest.raises(FaultInjected, match="step 2"):
        train(cfg, tcfg, batches(cfg, tcfg), max_steps=3, device="cpu")
    assert ckpt.latest_step(tcfg.checkpoint_dir) == 1
    saved = ckpt.load_generator_state_dict(tcfg.checkpoint_dir)
    tcfg = dataclasses.replace(tcfg, fault_inject_step=-1)
    seen = []
    state = train(cfg, tcfg, batches(cfg, tcfg), resume=True,
                  max_steps=3, log_fn=seen.append, device="cpu")
    assert state.step == 3 and [m["step"] for m in seen] == [2, 3]
    assert '"event": "resumed", "step": 1' in capsys.readouterr().err
    assert not torch.equal(saved["stage1.head.weight"], state.g.stage1.head.weight)


def test_checkpoint_round_trip_and_ema_reconcile(tmp_path, capsys):
    cfg = ModelConfig(**TINY)
    tcfg = TrainConfig(**TCFG, ema_decay=0.5)
    state = create_train_state(cfg, tcfg, CPU)
    make_train_step(cfg, tcfg)(state, batch_to_device(make_train_batch(2, 32, 32, 3, seed=5), CPU))
    d = str(tmp_path)
    ckpt.save_state(d, state)
    fresh = ckpt.restore_state(d, create_train_state(cfg, tcfg, CPU))
    assert fresh.step == 1 and torch.equal(fresh.rng.get_state(), state.rng.get_state())
    for a, b in ((fresh.g, state.g), (fresh.d, state.d), (fresh.g_ema, state.g_ema)):
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                     b.state_dict().values()))
    assert fresh.g_opt.state_dict()["state"][0]["exp_avg"].equal(
        state.g_opt.state_dict()["state"][0]["exp_avg"])
    assert fresh.g_sched.last_epoch == 1
    # EMA preferred when loading generator weights
    ema = ckpt.load_generator_state_dict(d)
    assert torch.equal(ema["stage1.head.weight"], state.g_ema.stage1.head.weight)
    raw = ckpt.load_generator_state_dict(d, prefer_ema=False)
    assert torch.equal(raw["stage1.head.weight"], state.g.stage1.head.weight)
    # resume without EMA tracking drops it; with tracking but none saved, starts one
    no_ema = ckpt.restore_state(d, create_train_state(cfg, TrainConfig(**TCFG), CPU))
    assert no_ema.g_ema is None
    assert "ema_dropped_on_resume" in capsys.readouterr().err
    ckpt.save_state(str(tmp_path / "plain"), no_ema)
    again = ckpt.restore_state(str(tmp_path / "plain"), create_train_state(cfg, tcfg, CPU))
    assert torch.equal(again.g_ema.stage1.head.weight, no_ema.g.stage1.head.weight)
    assert "ema_initialized_on_resume" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        ckpt.restore_state(d, state, step=7)


def test_eval_hook_tracks_the_best_step(tmp_path, batches):
    cfg = ModelConfig(**TINY)
    tcfg = _loop_cfg(tmp_path, eval_every=1)
    scores = iter([0.2, 0.5, 0.3])

    def eval_fn(state):
        return {"eval_stability": next(scores)}

    eval_fn.fingerprint = "clip-a"
    seen = []
    train(cfg, tcfg, batches(cfg, tcfg), max_steps=3,
          log_fn=seen.append, eval_fn=eval_fn, device="cpu")
    assert ckpt.best_step(tcfg.checkpoint_dir) == {
        "step": 2, "metric": "eval_stability", "value": 0.5,
        "eval_fingerprint": "clip-a"}
    assert [m["eval_stability"] for m in seen if "eval_stability" in m] == [0.2, 0.5, 0.3]
    best = ckpt.load_generator_state_dict(tcfg.checkpoint_dir, step="best")
    assert set(best) == set(CascadedGenerator(cfg).state_dict())


def test_debug_nans_raises_at_log_time(tmp_path):
    cfg = ModelConfig(**TINY)
    tcfg = _loop_cfg(tmp_path, debug_nans=True)
    batch = make_train_batch(2, 32, 32, 3, seed=0, dtype=np.float32)
    batch["stable"][:] = np.nan
    with pytest.raises(FloatingPointError, match="non-finite metrics at step 1"):
        train(cfg, tcfg, iter([batch] * 2), max_steps=2, device="cpu")


def _nan_then_finite(n):
    """A float batch whose ``stable`` is NaN, then ``n - 1`` finite ones."""
    batches = [make_train_batch(2, 32, 32, 3, seed=i, dtype=np.float32) for i in range(n)]
    batches[0]["stable"][:] = np.nan
    return batches


def test_debug_nans_stops_at_the_step_that_makes_a_nan_in_both_packages(tmp_path):
    """``log_every`` 5, ``checkpoint_every`` 1, a NaN batch at step 1:
    both packages raise ``FloatingPointError`` in step 1, before any log
    or checkpoint (the JAX package through ``jax_debug_nans``, which it
    sets process-wide and which is restored here)."""
    from pwstablenet_tpu.train import checkpoint as jax_ckpt
    from pwstablenet_tpu.train.loop import train as jax_train

    over = dict(log_every=5, checkpoint_every=1, debug_nans=True)
    logged = []
    tcfg = TrainConfig(**TCFG, **over, checkpoint_dir=str(tmp_path / "port"))
    with pytest.raises(FloatingPointError, match="non-finite metrics at step 1 "):
        train(ModelConfig(**TINY), tcfg, iter(_nan_then_finite(3)), max_steps=3,
              log_fn=logged.append, device="cpu")
    jtcfg = JaxTrainConfig(**TCFG, **over, checkpoint_dir=str(tmp_path / "jax"))
    before = jax.config.jax_debug_nans
    try:
        with pytest.raises(FloatingPointError):
            jax_train(JaxModelConfig(**TINY), jtcfg, iter(_nan_then_finite(3)),
                      max_steps=3, log_fn=logged.append)
    finally:
        jax.config.update("jax_debug_nans", before)
    assert logged == []
    assert ckpt.latest_step(tcfg.checkpoint_dir) is None
    assert jax_ckpt.latest_step(jtcfg.checkpoint_dir) is None
    for d in (tcfg.checkpoint_dir, jtcfg.checkpoint_dir):
        assert not os.path.exists(d) or os.listdir(d) == []


def test_debug_nans_checks_every_step_and_only_under_the_flag(monkeypatch, tmp_path):
    """The per-step check (and its host sync) runs once a step under
    ``debug_nans`` and never without it."""
    from pwstablenet_tpu_torch.train import loop

    checked = []
    monkeypatch.setattr(loop, "_check_finite", lambda state, m, step: checked.append(step))
    batches = [make_train_batch(2, 32, 32, 3, seed=i) for i in range(3)]
    for flag, expect in ((False, []), (True, [1, 2, 3])):
        checked.clear()
        tcfg = _loop_cfg(tmp_path, debug_nans=flag, log_every=5)
        train(ModelConfig(**TINY), tcfg, iter(batches), max_steps=3, log_fn=lambda m: None,
              device="cpu")
        assert checked == expect


def test_debug_nans_names_what_went_non_finite():
    from pwstablenet_tpu_torch.train.loop import _check_finite

    cfg, tcfg = ModelConfig(**TINY), TrainConfig(**TCFG, ema_decay=0.5)
    state = create_train_state(cfg, tcfg, CPU)
    m = make_train_step(cfg, tcfg)(state, batch_to_device(make_train_batch(2, 32, 32, 3, seed=1), CPU))
    _check_finite(state, m, 7)
    with torch.no_grad():
        state.g_ema.stage0.head.weight[0, 0, 0, 0] = float("inf")
        next(iter(state.d_opt.state.values()))["exp_avg_sq"].view(-1)[0] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite state at step 7 "
                                                 r"\(non-finite: D's Adam moments, the EMA\)"):
        _check_finite(state, m, 7)


def test_train_needs_a_card_or_an_explicit_cpu(monkeypatch, tmp_path):
    cfg = ModelConfig(**TINY)
    tcfg = _loop_cfg(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg, tcfg, iter([]), max_steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(cfg, tcfg)
    # TensorBoard logs are ported: on the CPU, the writer opens its file
    train(cfg, dataclasses.replace(tcfg, tb_log_dir=str(tmp_path / "tb")), iter([]),
          max_steps=0, device="cpu")
    assert len(os.listdir(tmp_path / "tb")) == 1
    # without a process group a mesh of two devices is a mesh of one:
    # the plain step, and the loop's logs and checkpoints on this process
    logged = []
    state = train(cfg, tcfg, iter([make_train_batch(2, 32, 32, 3, seed=0)]),
                  mesh_cfg=MeshConfig(num_devices=2), max_steps=1, log_fn=logged.append,
                  device="cpu")
    assert state.step == 1 and [m["step"] for m in logged] == [1]
    assert ckpt.latest_step(tcfg.checkpoint_dir) == 1


def test_prefetcher_yields_in_order_raises_and_closes():
    from pwstablenet_tpu_torch.data.prefetch import Prefetcher

    assert list(Prefetcher(iter(range(5)), depth=2)) == [0, 1, 2, 3, 4]

    def failing():
        yield 1
        raise KeyError("producer")

    it = Prefetcher(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer"):
        next(it)

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = Prefetcher(endless(), depth=2)
    assert [next(it), next(it)] == [0, 1]
    it.close(timeout=10)
    assert not it._thread.is_alive()
    # what was queued before close, then the end (not a wait forever)
    rest = list(it)
    assert rest == list(range(2, 2 + len(rest))) and len(rest) <= 2
    with pytest.raises(StopIteration):
        next(it)

