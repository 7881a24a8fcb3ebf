"""The training slice's pieces vs the JAX reference on the CPU: every
loss and mode, the discriminator and the feature extractor (weights
carried by ``interop.from_jax``), the learning-rate schedule, and the
synthetic batch generator.  Inputs come from numpy seeds and go through
both packages."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pwstablenet_tpu.config import ModelConfig as JaxModelConfig
from pwstablenet_tpu.config import TrainConfig as JaxTrainConfig
from pwstablenet_tpu.data.synthetic import make_train_batch as jax_make_train_batch
from pwstablenet_tpu.models import FeatureExtractor as JaxFeat
from pwstablenet_tpu.models import PatchDiscriminator as JaxDisc
from pwstablenet_tpu.train import losses as jl
from pwstablenet_tpu.train.state import make_lr_schedule as jax_lr_schedule

from pwstablenet_tpu_torch.config import ModelConfig, TrainConfig
from pwstablenet_tpu_torch.data.synthetic import make_train_batch
from pwstablenet_tpu_torch.interop.from_jax import state_dict_to_tree, tree_to_state_dict
from pwstablenet_tpu_torch.models.discriminator import PatchDiscriminator
from pwstablenet_tpu_torch.models.features import FeatureExtractor
from pwstablenet_tpu_torch.train import losses as tl
from pwstablenet_tpu_torch.train.state import make_lr_schedule

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


# ------------------------------------------------------------- losses --

@pytest.mark.parametrize("kind", ["lsgan", "vanilla", "hinge"])
def test_gan_losses_match_reference(kind):
    real, fake = _rand((2, 6, 6, 1), 0, -3, 3), _rand((2, 6, 6, 1), 1, -3, 3)
    np.testing.assert_allclose(
        float(tl.gan_loss_d(_t(real), _t(fake), kind)),
        float(jl.gan_loss_d(jnp.asarray(real), jnp.asarray(fake), kind)), rtol=RTOL)
    np.testing.assert_allclose(
        float(tl.gan_loss_g(_t(fake), kind)),
        float(jl.gan_loss_g(jnp.asarray(fake), kind)), rtol=RTOL)
    with pytest.raises(ValueError, match="gan loss"):
        tl.gan_loss_g(_t(fake), "wgan")


def test_bce_is_stable_for_large_logits():
    big = torch.tensor([-200.0, 200.0])
    assert torch.isfinite(tl.gan_loss_d(big, big, "vanilla"))
    assert torch.isfinite(tl.gan_loss_g(big, "vanilla"))


@pytest.mark.parametrize("mode", ["l1", "mean_matched", "gradient"])
def test_pixel_losses_match_reference(mode):
    """Values, and the gradient w.r.t. ``pred``: for ``mean_matched``
    that shows the gain's stopped gradient on both sides."""
    pred, tgt = _rand((2, 8, 10, 3), 2), _rand((2, 8, 10, 3), 3)
    ref, ref_grad = jax.value_and_grad(
        lambda p: jl.pixel_loss_photometric(p, jnp.asarray(tgt), mode)
    )(jnp.asarray(pred))
    p = _t(pred).requires_grad_(True)
    out = tl.pixel_loss_photometric(p, _t(tgt), mode)
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=RTOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad), rtol=RTOL, atol=1e-9)
    if mode == "mean_matched":
        # with the gain differentiated the gradient would differ
        p2 = _t(pred).requires_grad_(True)
        p01, t01 = (p2 + 1) * 0.5, (_t(tgt) + 1) * 0.5
        gain = torch.clamp(t01.mean((1, 2), keepdim=True)
                           / (p01.mean((1, 2), keepdim=True) + 1e-4), 0.5, 2.0)
        (torch.mean(torch.abs(p01 * gain - t01)) * 2.0).backward()
        assert np.abs(p2.grad.numpy() - p.grad.numpy()).max() > 1e-6


def test_feature_temporal_smoothness_and_stage_losses_match_reference():
    fp = [_rand((2, 8, 8, 4), 4), _rand((2, 4, 4, 6), 5)]
    ft = [_rand((2, 8, 8, 4), 6), _rand((2, 4, 4, 6), 7)]
    np.testing.assert_allclose(
        float(tl.feature_loss([_t(a) for a in fp], [_t(a) for a in ft])),
        float(jl.feature_loss([jnp.asarray(a) for a in fp], [jnp.asarray(a) for a in ft])),
        rtol=RTOL)
    out_pair, gt_pair = _rand((2, 2, 8, 8, 3), 8), _rand((2, 2, 8, 8, 3), 9)
    np.testing.assert_allclose(
        float(tl.temporal_loss(_t(out_pair))),
        float(jl.temporal_loss(jnp.asarray(out_pair))), rtol=RTOL)
    np.testing.assert_allclose(
        float(tl.temporal_loss_compensated(_t(out_pair), _t(gt_pair))),
        float(jl.temporal_loss_compensated(jnp.asarray(out_pair), jnp.asarray(gt_pair))),
        rtol=RTOL)
    flow = _rand((2, 8, 8, 2), 10, -0.1, 0.1)
    np.testing.assert_allclose(
        float(tl.warp_smoothness_loss(_t(flow))),
        float(jl.warp_smoothness_loss(jnp.asarray(flow))), rtol=RTOL)
    per = [np.float32(1.5), np.float32(0.25), np.float32(3.0)]
    np.testing.assert_allclose(
        float(tl.stage_weighted([torch.tensor(v) for v in per], (0.5, 1.0, 2.0))),
        float(jl.stage_weighted([jnp.asarray(v) for v in per], (0.5, 1.0, 2.0))),
        rtol=RTOL)


# ------------------------------------------- discriminator, features --

SMALL = dict(model_resolution=(32, 32), num_levels=5, disc_base_features=8,
             disc_num_layers=2, feat_channels=(8, 16, 16))


def _redraw(params, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        a = np.asarray(x)
        if name == "kernel":
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if name == "bias":
            return (rng.standard_normal(a.shape) * 0.05).astype(np.float32)
        return (1.0 + rng.standard_normal(a.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _disc_pair(overrides, seed):
    jcfg, cfg = JaxModelConfig(**overrides), ModelConfig(**overrides)
    x = _rand((2, 32, 32, 6), seed + 100)
    params = _redraw(JaxDisc(jcfg).init(jax.random.PRNGKey(0), jnp.asarray(x)), seed)
    model = PatchDiscriminator(cfg)
    model.load_state_dict(tree_to_state_dict(params))
    ref = np.asarray(JaxDisc(jcfg).apply(params, jnp.asarray(x)))
    with torch.no_grad():
        out = model(_t(x)).numpy()
    return params, model, ref, out


def _feat_pair(overrides, seed):
    jcfg, cfg = JaxModelConfig(**overrides), ModelConfig(**overrides)
    x = _rand((2, 32, 32, 3), seed + 100)
    params = _redraw(JaxFeat(jcfg).init(jax.random.PRNGKey(0), jnp.asarray(x)), seed)
    model = FeatureExtractor(cfg)
    model.load_state_dict(tree_to_state_dict(params))
    ref = [np.asarray(r) for r in JaxFeat(jcfg).apply(params, jnp.asarray(x))]
    out = [o.numpy() for o in model(_t(x))]
    return params, model, ref, out


@pytest.mark.parametrize("disc_norm", ["instance", "batch", "group", "none"])
def test_discriminator_matches_flax_f32(disc_norm):
    _, _, ref, out = _disc_pair({**SMALL, "disc_norm": disc_norm,
                                 "compute_dtype": "float32"}, seed=1)
    assert out.shape == ref.shape == (2, 6, 6, 1) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=5e-4)


def test_feature_extractor_matches_flax_f32():
    _, model, ref, out = _feat_pair({**SMALL, "compute_dtype": "float32"}, seed=2)
    assert [o.shape for o in out] == [r.shape for r in ref] == [
        (2, 32, 32, 8), (2, 16, 16, 16), (2, 8, 8, 16)]
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o, r, atol=5e-4)
    assert not any(p.requires_grad for p in model.parameters())  # frozen


def test_discriminator_and_features_match_flax_bf16():
    """bf16 activations on both sides round at different places: MSE <=
    1e-3 against the f32-scale outputs."""
    _, _, ref, out = _disc_pair({**SMALL, "compute_dtype": "bfloat16"}, seed=3)
    assert out.dtype == np.float32
    assert float(np.mean((out - ref) ** 2)) <= 1e-3
    _, _, ref, out = _feat_pair({**SMALL, "compute_dtype": "bfloat16"}, seed=4)
    for r, o in zip(ref, out):
        assert o.dtype == np.float32
        assert float(np.mean((o - r) ** 2)) <= 1e-3


def test_disc_and_feature_mappings_round_trip():
    for params, model, _, _ in (
        _disc_pair({**SMALL, "compute_dtype": "float32"}, seed=5),
        _feat_pair({**SMALL, "compute_dtype": "float32"}, seed=6),
    ):
        back = state_dict_to_tree(model.state_dict())["params"]
        flat_ref = jax.tree_util.tree_leaves_with_path(params["params"])
        flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_ref) == len(flat_back)
        for path, leaf in flat_ref:
            np.testing.assert_array_equal(flat_back[path], np.asarray(leaf), err_msg=str(path))


def test_too_deep_discriminator_raises():
    cfg = ModelConfig(**{**SMALL, "model_resolution": (16, 16), "num_levels": 4,
                         "disc_num_layers": 3})
    with pytest.raises(ValueError, match="too deep"):
        PatchDiscriminator(cfg)(torch.zeros(1, 16, 16, 6))


# --------------------------------------------------- lr schedule, data --

@pytest.mark.parametrize("frac", [0.5, 0.0, 0.9])
def test_lr_schedule_matches_optax(frac):
    cfg = TrainConfig(num_epochs=3, steps_per_epoch=7, lr_decay_start_frac=frac)
    jcfg = JaxTrainConfig(num_epochs=3, steps_per_epoch=7, lr_decay_start_frac=frac)
    total = 21
    start = int(total * frac)
    ref = jax_lr_schedule(jcfg, jcfg.lr_g)
    factor = make_lr_schedule(cfg)
    for k in sorted({0, max(start - 1, 0), start, start + 3, total, total + 5}):
        np.testing.assert_allclose(cfg.lr_g * factor(k), float(ref(k)), rtol=1e-6, atol=1e-12)


def test_lr_schedule_drives_adam_at_the_pre_update_count():
    """LambdaLR in the port's state: update k runs at factor(k)."""
    from pwstablenet_tpu_torch.train.state import _adam

    cfg = TrainConfig(num_epochs=1, steps_per_epoch=4, lr_decay_start_frac=0.5)
    p = torch.nn.Parameter(torch.zeros(1))
    opt, sched = _adam([p], 1.0, cfg)
    seen = []
    for _ in range(5):
        seen.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(1)
        opt.step()
        sched.step()
    np.testing.assert_allclose(seen, [1.0, 1.0, 1.0, 0.5, 0.0])


@pytest.mark.parametrize("seed,rich", [(3, False), (11, True)])
def test_make_train_batch_bitwise_equal_to_reference(seed, rich):
    kw = dict(seed=seed, rich=rich, temporal_center=None)
    ours = make_train_batch(2, 24, 32, 3, **kw)
    ref = jax_make_train_batch(2, 24, 32, 3, **kw)
    assert set(ours) == set(ref) == {"stacks", "stable"}
    for k in ours:
        assert ours[k].dtype == ref[k].dtype == np.uint8
        np.testing.assert_array_equal(ours[k], ref[k])
    causal = make_train_batch(1, 16, 16, 3, seed=seed, temporal_center=2, dtype=np.float32)
    ref = jax_make_train_batch(1, 16, 16, 3, seed=seed, temporal_center=2, dtype=np.float32)
    for k in causal:
        np.testing.assert_array_equal(causal[k], ref[k])
