"""Port generator vs the flax ``CascadedGenerator`` on the CPU, with the
same weights carried over by ``interop.from_jax``, and the weight
mapping's round trip."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pwstablenet_tpu.config import ModelConfig as JaxModelConfig
from pwstablenet_tpu.models import CascadedGenerator as JaxGenerator

from pwstablenet_tpu_torch.config import ModelConfig
from pwstablenet_tpu_torch.interop.from_jax import (
    jax_params_to_state_dict,
    state_dict_to_jax_params,
)
from pwstablenet_tpu_torch.models.generator import CascadedGenerator

# the SMALL config of tests/test_torch_parity.py, two stages
SMALL = dict(
    temporal_window=3,
    num_levels=5,
    base_features=8,
    max_features=32,
    model_resolution=(64, 64),
    num_stages=2,
    compute_dtype="float32",
)


def random_jax_params(jcfg, seed):
    """flax params as nested numpy dicts, every kernel and bias redrawn
    (nonzero head) from a numpy seed."""
    h, w = jcfg.model_resolution
    params = JaxGenerator(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, jcfg.stack_channels))
    )
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = path[-1].key
        a = np.asarray(leaf)
        if name == "kernel":
            return (rng.standard_normal(a.shape) * 0.05).astype(np.float32)
        if name == "bias":
            return (rng.standard_normal(a.shape) * 0.02).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(redraw, params)


def run_pair(overrides, seed=0, batch=2):
    jcfg = JaxModelConfig(**overrides)
    cfg = ModelConfig(**overrides)
    params = random_jax_params(jcfg, seed)
    model = CascadedGenerator(cfg).eval()
    model.load_state_dict(jax_params_to_state_dict(params, cfg))
    h, w = cfg.model_resolution
    x = np.random.default_rng(seed + 100).uniform(
        -1, 1, (batch, h, w, cfg.stack_channels)
    ).astype(np.float32)
    ref = JaxGenerator(jcfg).apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    return [np.asarray(r) for r in ref], [o.float().numpy() for o in out]


def test_state_dict_round_trip():
    cfg = ModelConfig(**SMALL)
    params = random_jax_params(JaxModelConfig(**SMALL), 0)
    sd = jax_params_to_state_dict(params, cfg)
    model_sd = CascadedGenerator(cfg).state_dict()
    assert set(sd) == set(model_sd)
    for k, v in sd.items():
        assert v.shape == model_sd[k].shape, k
    back = state_dict_to_jax_params(sd, cfg)["params"]
    flat_ref = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf), err_msg=str(path))
    with pytest.raises(ValueError, match="stages"):
        jax_params_to_state_dict(params, dataclasses.replace(cfg, num_stages=1))


@pytest.mark.parametrize(
    "overrides",
    [
        {"interstage": "features"},
        {"interstage": "warped"},
        {"interstage": "both"},
        {"norm": "batch"},
        {"norm": "group"},
        {"norm": "none"},
        {"decoder_impl": "phase_conv"},
        {"use_dropout": True, "num_stages": 1},
        {"temporal_center": 2, "padding_mode": "zeros"},
    ],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()),
)
def test_generator_matches_flax_f32(overrides):
    """Every interstage wiring, norm kind and decoder lowering; dropout
    is off at inference on both sides."""
    ref, out = run_pair({**SMALL, **overrides}, seed=1)
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        assert o.shape == r.shape
        assert np.abs(r).max() > 1e-2  # nonzero head: a real comparison
        mse = float(np.mean((r - o) ** 2))
        assert mse <= 1e-3, f"warp-map MSE {mse}"
        np.testing.assert_allclose(o, r, atol=5e-4)


def test_generator_matches_flax_bf16():
    """bf16 activations on both sides: the frameworks round at different
    places (conv accumulation, bias add), so flows differ by a few bf16
    ulps of the activations.  Tolerance: warp-map MSE <= 1e-3 (the
    reference's contract) and max |diff| <= 2e-2 normalized units."""
    ref, out = run_pair({**SMALL, "compute_dtype": "bfloat16"}, seed=2)
    for r, o in zip(ref, out):
        assert o.dtype == np.float32 and np.abs(r).max() > 1e-2
        mse = float(np.mean((r - o) ** 2))
        assert mse <= 1e-3, f"warp-map MSE {mse}"
        np.testing.assert_allclose(o, r, atol=2e-2)


def test_fresh_generator_is_identity_warp():
    cfg = ModelConfig(**SMALL)
    model = CascadedGenerator(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.rand(1, 64, 64, cfg.stack_channels)
    with torch.no_grad():
        flows = model(x)
    assert all(torch.equal(f, torch.zeros_like(f)) for f in flows)
    # the seed decides the weights
    again = CascadedGenerator(cfg, generator=torch.Generator().manual_seed(0))
    other = CascadedGenerator(cfg, generator=torch.Generator().manual_seed(1))
    w0 = model.stage0.down1.conv.weight
    assert torch.equal(w0, again.stage0.down1.conv.weight)
    assert not torch.equal(w0, other.stage0.down1.conv.weight)
