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
bound only, left out of the 99.9 % share, and set to the JAX values
after each step.  Left apart, they alone make the two sides' second
steps differ (through the rounding of the norms' one-pass variance):
with them synced, every other element stays within 1e-6.  The tolerance
also needs every leaky-ReLU input to lie farther from 0 than the two
sides' rounding: with the vanilla GAN loss, batch 4 puts one of D's at
-5.83e-7 in JAX and +5.84e-7 in the port, so its slope differs (1 vs
0.2) and D's weight gradient by 1.2 % of its largest element (1.8e-6
with that element on JAX's side); that case's second step runs on
batch 5 (``tests/torch_port_step_drift.py`` prints these readings)."""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pwstablenet_tpu.config import ModelConfig as JaxModelConfig
from pwstablenet_tpu.config import TrainConfig as JaxTrainConfig
from pwstablenet_tpu.train import create_train_state as jax_create_train_state
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


def _run_pair(train_over, steps=2, check=True):
    """Both steps on the same batches (``seeds``, default (3, 4)); after
    each step the port's norm-fed conv biases are set to JAX's.  Returns,
    per step, the share of G's and D's other elements within 1e-6 and
    their max |diff| / lr."""
    over = {**TCFG, **train_over}
    seeds = over.pop("seeds", (3, 4))
    jstep, jstate, step, state = _pair(TINY, over)
    lr = over["lr_g"]
    readings = []
    for n, seed in enumerate(seeds[:steps], start=1):
        batch = make_train_batch(2, 32, 32, TINY["temporal_window"], seed=seed)
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        m = step(state, batch_to_device(batch, CPU))
        readings.append({
            what: (float((free <= 1e-6).double().mean()), float(free.max()) / lr)
            for what, (_, free) in (("G", _param_diffs(state.g, jstate.g_params)),
                                    ("D", _param_diffs(state.d, jstate.d_params)))})
        if check:
            assert set(m) == set(jm)
            for k in jm:
                assert m[k].device == CPU and m[k].dim() == 0
                np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
            assert state.step == int(jstate.step) == n
            _assert_params_close(state.g, jstate.g_params, lr, n, "G")
            _assert_params_close(state.d, jstate.d_params, lr, n, "D")
            _assert_params_close(state.feat, jstate.feat_params, 0.0, n, "feat")
            if over.get("ema_decay", 0) > 0:
                _assert_params_close(state.g_ema, jstate.g_ema, lr, n, "EMA")
        _sync_from_jax(state, jstate)
    return readings


@pytest.mark.parametrize(
    "train_over",
    [
        {"pixel_loss_mode": p, "temporal_mode": t}
        for p in ("l1", "mean_matched", "gradient") for t in ("raw", "compensated")
    ] + [{"grad_accum_steps": 2}, {"ema_decay": 0.9}, {"gan_loss": "hinge"},
         # batch 4 puts one of D's leaky-ReLU inputs within rounding of
         # the kink at the vanilla second step (module docstring)
         {"gan_loss": "vanilla", "seeds": (3, 5)}],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()),
)
def test_train_step_matches_jax(train_over):
    _run_pair(train_over)


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

