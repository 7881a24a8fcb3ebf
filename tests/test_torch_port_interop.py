"""The port's checkpoint interop against the JAX package's, on the CPU:
the reference's ``.pth`` layout in and out (``interop.torch_import``,
``interop.torch_ref``), torchvision VGG weights into the feature
extractor, and the JAX package's Orbax checkpoints read without JAX
(``interop.from_orbax``).  Flows are held to the generator tolerances of
``tests/test_torch_port_models.py`` (warp-map MSE <= 1e-3, atol 5e-4),
a resumed train step to ``tests/test_torch_port_train.py``'s."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pwstablenet_tpu.config import ModelConfig as JaxModelConfig
from pwstablenet_tpu.config import TrainConfig as JaxTrainConfig
from pwstablenet_tpu.interop import torch_import as jax_import
from pwstablenet_tpu.interop import torch_ref as jax_ref
from pwstablenet_tpu.models import CascadedGenerator as JaxGenerator
from pwstablenet_tpu.models import FeatureExtractor as JaxFeatureExtractor
from pwstablenet_tpu.train import checkpoint as jax_ckpt

from pwstablenet_tpu_torch.config import ModelConfig, TrainConfig
from pwstablenet_tpu_torch.data.synthetic import make_train_batch
from pwstablenet_tpu_torch.interop import (
    feat_state_dict_to_port,
    load_torch_checkpoint,
    port_to_torch_state_dict,
    torch_state_dict_to_port,
    torchvision_vgg_to_port,
)
from pwstablenet_tpu_torch.interop import from_orbax, torch_ref
from pwstablenet_tpu_torch.interop.from_jax import (
    jax_params_to_state_dict,
    state_dict_to_jax_params,
    tree_to_state_dict,
)
from pwstablenet_tpu_torch.models.features import FeatureExtractor
from pwstablenet_tpu_torch.models.generator import CascadedGenerator
from pwstablenet_tpu_torch.train import checkpoint as ckpt
from pwstablenet_tpu_torch.train.loop import batch_to_device
from pwstablenet_tpu_torch.train.state import create_train_state

from test_torch_port_models import random_jax_params
from test_torch_port_train import CPU, TCFG, TINY, _assert_params_close, _pair

SMALL = dict(temporal_window=3, num_levels=4, base_features=8, max_features=16,
             model_resolution=(32, 32), compute_dtype="float32")


def _reference_weights(jcfg, seed):
    """The JAX package's ``TorchCascadedGenerator`` with every conv redrawn
    (a nonzero head) from a torch seed."""
    model = jax_ref.TorchCascadedGenerator(jcfg)
    torch.manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            torch.nn.init.normal_(m.weight, std=0.05)
            torch.nn.init.normal_(m.bias, std=0.02)
    return model


def _flows_close(ours, ref):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        o, r = np.asarray(o), np.asarray(r)
        assert o.shape == r.shape and np.abs(r).max() > 1e-2  # a real comparison
        mse = float(np.mean((o - r) ** 2))
        assert mse <= 1e-3, f"warp-map MSE {mse}"
        np.testing.assert_allclose(o, r, atol=5e-4)


def _port_flows(cfg, state_dict, x):
    model = CascadedGenerator(cfg).eval()
    model.load_state_dict(state_dict)
    with torch.no_grad():
        return [f.numpy() for f in model(torch.from_numpy(x))]


def _jax_flows(jcfg, params, x):
    return [np.asarray(f) for f in JaxGenerator(jcfg).apply(params, jnp.asarray(x))]


def _stack(cfg, seed, batch=2):
    h, w = cfg.model_resolution
    return np.random.default_rng(seed).uniform(
        -1, 1, (batch, h, w, cfg.stack_channels)).astype(np.float32)


# ------------------------------------------------------------ .pth -----

@pytest.mark.parametrize("over", [
    {"num_stages": 2, "interstage": i, "norm": n}
    for i in ("features", "warped", "both")
    for n in ("instance", "batch", "group", "none")
] + [{"num_stages": 1, "norm": n} for n in ("instance", "batch", "group", "none")],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_pth_loads_and_matches_jax(tmp_path, over):
    """A ``.pth`` of the JAX package's ``TorchCascadedGenerator``: the
    port's ``load_torch_checkpoint`` against the JAX package's, through
    each side's generator."""
    jcfg, cfg = JaxModelConfig(**SMALL, **over), ModelConfig(**SMALL, **over)
    path = str(tmp_path / "ref.pth")
    torch.save(_reference_weights(jcfg, seed=1).state_dict(), path)
    x = _stack(cfg, seed=2)
    _flows_close(_port_flows(cfg, load_torch_checkpoint(path, cfg), x),
                 _jax_flows(jcfg, jax_import.load_torch_checkpoint(path, jcfg), x))


def test_pth_mapping_is_a_rename_of_the_jax_conversion():
    """``torch_state_dict_to_port`` equals the JAX package's
    ``torch_state_dict_to_flax`` followed by ``jax_params_to_state_dict``:
    the same tensors under other names, none transposed or flipped."""
    jcfg, cfg = JaxModelConfig(**SMALL), ModelConfig(**SMALL)
    sd = _reference_weights(jcfg, seed=3).state_dict()
    ours = torch_state_dict_to_port(sd, cfg)
    via_jax = jax_params_to_state_dict(jax_import.torch_state_dict_to_flax(sd, jcfg), cfg)
    assert list(ours) == list(CascadedGenerator(cfg).state_dict())
    assert set(ours) == set(via_jax)
    for k, v in ours.items():
        assert torch.equal(v, via_jax[k]), k
    # the same tensors: a permutation of names
    assert sorted(v.sum().item() for v in ours.values()) == sorted(
        v.sum().item() for v in sd.values())


def test_pth_mapping_refuses_what_it_does_not_know():
    cfg = ModelConfig(**SMALL)
    sd = _reference_weights(JaxModelConfig(**SMALL), seed=4).state_dict()
    with pytest.raises(KeyError, match="stages.0.extra"):
        torch_state_dict_to_port({**sd, "stages.0.extra.weight": torch.zeros(1)}, cfg)
    with pytest.raises(ValueError, match="stages"):
        torch_state_dict_to_port(sd, dataclasses.replace(cfg, num_stages=1))
    with pytest.raises(ValueError, match="shape"):
        torch_state_dict_to_port(sd, dataclasses.replace(cfg, base_features=4))
    missing = dict(sd)
    del missing["stages.1.head.bias"]
    with pytest.raises(KeyError, match="stages.1.head.bias"):
        torch_state_dict_to_port(missing, cfg)
    with pytest.raises(KeyError, match="extra"):
        port_to_torch_state_dict({"stage0.extra.weight": torch.zeros(1)}, cfg)


def test_torch_ref_has_the_reference_layout():
    """The port's ``torch_ref`` against the JAX package's: the same names
    and shapes, and the same forward for one set of weights."""
    for over in ({}, {"interstage": "features", "norm": "group"}, {"num_stages": 1}):
        jcfg, cfg = JaxModelConfig(**SMALL, **over), ModelConfig(**SMALL, **over)
        ref = _reference_weights(jcfg, seed=5)
        ours = torch_ref.TorchCascadedGenerator(cfg)
        assert {k: v.shape for k, v in ours.state_dict().items()} == {
            k: v.shape for k, v in ref.state_dict().items()}
        ours.load_state_dict(ref.state_dict())
        x = torch.from_numpy(_stack(cfg, seed=6)).permute(0, 3, 1, 2)
        with torch.no_grad():
            for a, b in zip(ours(x), ref(x)):
                assert torch.equal(a, b)
    f_ref = jax_ref.TorchFeatureExtractor(JaxModelConfig(**SMALL))
    f_ours = torch_ref.TorchFeatureExtractor(ModelConfig(**SMALL))
    assert {k: v.shape for k, v in f_ours.state_dict().items()} == {
        k: v.shape for k, v in f_ref.state_dict().items()}


def test_export_back_round_trips_and_matches_jax():
    """``port_to_torch_state_dict`` of a port state dict: bit for bit the
    JAX package's ``flax_to_torch_state_dict`` of the same weights, and
    back through ``torch_state_dict_to_port`` unchanged."""
    jcfg, cfg = JaxModelConfig(**SMALL), ModelConfig(**SMALL)
    sd = jax_params_to_state_dict(random_jax_params(jcfg, 7), cfg)
    out = port_to_torch_state_dict(sd, cfg)
    ref = jax_import.flax_to_torch_state_dict(state_dict_to_jax_params(sd, cfg), jcfg)
    assert set(out) == set(ref)
    for k, v in out.items():
        assert v.dtype == torch.float32 and torch.equal(v, torch.from_numpy(ref[k])), k
    back = torch_state_dict_to_port(out, cfg)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_feature_extractor_and_torchvision_vgg_import():
    """``feat_state_dict_to_port`` and ``torchvision_vgg_to_port`` against
    the JAX package's conversions, through each side's extractor; a VGG
    whose widths do not fit raises."""
    over = {**SMALL, "feat_channels": (64, 128)}
    jcfg, cfg = JaxModelConfig(**over), ModelConfig(**over)
    gen = torch.Generator().manual_seed(8)
    # torchvision VGG16 ``features``: convs at 0, 2, 5, 7 (ReLUs and a
    # pool between), then the next blocks'
    shapes = {0: (64, 3), 2: (64, 64), 5: (128, 64), 7: (128, 128), 10: (256, 128)}
    vgg = {}
    for idx, (o, i) in shapes.items():
        vgg[f"features.{idx}.weight"] = torch.randn(o, i, 3, 3, generator=gen) * 0.05
        vgg[f"features.{idx}.bias"] = torch.randn(o, generator=gen) * 0.02
    x = np.random.default_rng(9).uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    ref = JaxFeatureExtractor(jcfg).apply(
        jax_import.torchvision_vgg_to_flax(vgg, jcfg), jnp.asarray(x))
    feat = FeatureExtractor(cfg)
    feat.load_state_dict(torchvision_vgg_to_port(vgg, cfg))
    with torch.no_grad():
        ours = feat(torch.from_numpy(x))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="VGG conv features.0"):
        torchvision_vgg_to_port(vgg, dataclasses.replace(cfg, feat_channels=(32, 64)))
    with pytest.raises(ValueError, match="VGG"):
        torchvision_vgg_to_port(vgg, dataclasses.replace(cfg, feat_channels=(64, 128, 256, 512)))
    # the reference layout's extractor
    tfe = jax_ref.TorchFeatureExtractor(jcfg)
    ours = feat_state_dict_to_port(tfe.state_dict(), cfg)
    via_jax = tree_to_state_dict(jax_import.feat_state_dict_to_flax(tfe.state_dict(), jcfg))
    assert list(ours) == list(FeatureExtractor(cfg).state_dict())
    assert all(torch.equal(v, via_jax[k]) for k, v in ours.items())
    with pytest.raises(KeyError, match="features.0.weight"):
        feat_state_dict_to_port(vgg, cfg)


@pytest.mark.parametrize("wrap", ["plain", "state_dict", "generator", "G", "model", "module"])
def test_load_torch_checkpoint_takes_every_wrapped_form(tmp_path, wrap):
    jcfg, cfg = JaxModelConfig(**SMALL), ModelConfig(**SMALL)
    model = _reference_weights(jcfg, seed=10)
    sd = model.state_dict()
    obj = {"plain": sd, "module": model}.get(wrap, {wrap: sd, "step": 7})
    path = str(tmp_path / "ref.pt")
    torch.save(obj, path)
    got = load_torch_checkpoint(path, cfg)
    want = torch_state_dict_to_port(sd, cfg)
    assert list(got) == list(want) and all(torch.equal(got[k], v) for k, v in want.items())


# ----------------------------------------------------------- Orbax -----

def test_orbax_params_export_matches_jax(tmp_path):
    """A ``save_params`` export: the port's generator from it against the
    JAX package's ``load_generator_params`` through the flax generator."""
    jcfg, cfg = JaxModelConfig(**SMALL), ModelConfig(**SMALL)
    params = random_jax_params(jcfg, 11)
    path = str(tmp_path / "export")
    jax_ckpt.save_params(path, params)
    assert from_orbax.is_orbax_checkpoint(path)
    sd = ckpt.load_generator_state_dict(path, cfg=cfg)
    ref = jax_params_to_state_dict(params, cfg)
    assert list(sd) == list(ref) and all(torch.equal(sd[k], v) for k, v in ref.items())
    x = _stack(cfg, seed=12)
    _flows_close(_port_flows(cfg, sd, x),
                 _jax_flows(jcfg, jax_ckpt.load_generator_params(path), x))


def _jax_run(tmp_path, ema):
    """A JAX training run's checkpoint directory, written by the JAX
    package: step 0 as created, step 3 with redrawn weights (and EMA),
    and a best-eval export at step 3."""
    jcfg = JaxModelConfig(**TINY)
    jtcfg = JaxTrainConfig(**TCFG, ema_decay=0.9 if ema else 0.0)
    from pwstablenet_tpu.train import create_train_state as jax_create_train_state

    state, _ = jax_create_train_state(jcfg, jtcfg, jax.random.PRNGKey(0))
    d = str(tmp_path / ("ema" if ema else "plain"))
    jax_ckpt.save_state(d, state)
    later = state.replace(
        step=jnp.asarray(3, jnp.int32),
        g_params=random_jax_params(jcfg, 13),
        g_ema=random_jax_params(jcfg, 14) if ema else None)
    jax_ckpt.save_state(d, later)
    jax_ckpt.save_best(d, later, 3, "eval_stability", 0.5)
    return d, ModelConfig(**TINY)


@pytest.mark.parametrize("ema", [False, True], ids=["no_ema", "ema"])
def test_orbax_training_dir_picks_the_weights_jax_picks(tmp_path, ema):
    d, cfg = _jax_run(tmp_path, ema)
    assert ckpt.latest_step(d) == 3 and from_orbax.orbax_steps(d) == [0, 3]
    for kwargs in ({}, {"prefer_ema": False}, {"step": 0}, {"step": 3}, {"step": "best"}):
        ours = ckpt.load_generator_state_dict(d, cfg=cfg, **kwargs)
        ref = jax_params_to_state_dict(
            jax.device_get(jax_ckpt.load_generator_params(d, **kwargs)), cfg)
        assert list(ours) == list(ref), kwargs
        assert all(torch.equal(ours[k], v) for k, v in ref.items()), kwargs
    x = _stack(cfg, seed=15)
    _flows_close(_port_flows(cfg, from_orbax.load_orbax_generator_state_dict(d, cfg), x),
                 _jax_flows(JaxModelConfig(**TINY), jax_ckpt.load_generator_params(d), x))


def test_orbax_missing_step_and_best_give_the_jax_error_texts(tmp_path):
    d, cfg = _jax_run(tmp_path, ema=False)
    for step in (7, "best"):
        path = d if step == 7 else str(tmp_path)  # tmp_path has no best record
        with pytest.raises(FileNotFoundError) as ref:
            jax_ckpt.load_generator_params(path, step=step)
        if step == "best":
            os.makedirs(os.path.join(path, "1", "default"))  # an Orbax directory
        with pytest.raises(FileNotFoundError) as ours:
            ckpt.load_generator_state_dict(path, cfg=cfg, step=step)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(FileNotFoundError, match="step 7 not found"):
        from_orbax.restore_state_from_orbax(d, None, step=7)


@pytest.mark.parametrize("ema", [0.0, 0.9], ids=["no_ema", "ema"])
def test_restore_from_orbax_resumes_like_jax(tmp_path, ema):
    """A JAX state after one step, its Adam counts moved into the
    learning-rate decay (count 6 of 10, decay from 5), saved by the JAX
    package; the JAX step from its restore against the port's step from
    ``restore_state``, on one batch."""
    over = {**TCFG, "ema_decay": ema}
    jstep, jstate, step, _ = _pair(TINY, over)
    batch = make_train_batch(2, 32, 32, TINY["temporal_window"], seed=3)
    jstate, _ = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))

    def recount(opt):
        adam, sched = opt
        return (adam._replace(count=jnp.asarray(6, jnp.int32)),
                sched._replace(count=jnp.asarray(6, jnp.int32)))

    jstate = jstate.replace(step=jnp.asarray(6, jnp.int32), g_opt=recount(jstate.g_opt),
                            d_opt=recount(jstate.d_opt))
    d = str(tmp_path / "run")
    jax_ckpt.save_state(d, jstate)
    jstate = jax_ckpt.restore_state(d, jstate)

    cfg, tcfg = ModelConfig(**TINY), TrainConfig(**over)
    state = ckpt.restore_state(d, create_train_state(cfg, tcfg, CPU))
    assert state.step == 6 and state.g_sched.last_epoch == 6
    assert state.g_opt.param_groups[0]["lr"] == pytest.approx(over["lr_g"] * 0.8)
    for module, jparams in ((state.g, jstate.g_params), (state.d, jstate.d_params),
                            (state.feat, jstate.feat_params)):
        ref = tree_to_state_dict(jax.device_get(jparams))
        assert all(torch.equal(v, ref[k]) for k, v in module.state_dict().items())

    nxt = make_train_batch(2, 32, 32, TINY["temporal_window"], seed=4)
    jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, nxt))
    m = step(state, batch_to_device(nxt, CPU))
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert state.step == int(jstate.step) == 7
    lr = over["lr_g"]
    _assert_params_close(state.g, jstate.g_params, lr, 2, "G")
    _assert_params_close(state.d, jstate.d_params, lr, 2, "D")
    _assert_params_close(state.feat, jstate.feat_params, 0.0, 2, "feat")
    if ema:
        _assert_params_close(state.g_ema, jstate.g_ema, lr, 2, "EMA")


def test_restore_from_orbax_reconciles_the_ema(tmp_path, capsys):
    cfg = ModelConfig(**TINY)
    plain, _ = _jax_run(tmp_path, ema=False)
    tracked, _ = _jax_run(tmp_path, ema=True)
    state = ckpt.restore_state(plain, create_train_state(cfg, TrainConfig(**TCFG, ema_decay=0.9), CPU))
    assert "ema_initialized_on_resume" in capsys.readouterr().err
    assert all(torch.equal(a, b) for a, b in zip(state.g_ema.state_dict().values(),
                                                 state.g.state_dict().values()))
    state = ckpt.restore_state(tracked, create_train_state(cfg, TrainConfig(**TCFG), CPU))
    assert state.g_ema is None and "ema_dropped_on_resume" in capsys.readouterr().err
    # the dropout generator: from the run's seed and the restored step
    again = ckpt.restore_state(tracked, create_train_state(cfg, TrainConfig(**TCFG), CPU))
    assert torch.equal(again.rng.get_state(), state.rng.get_state())
    other = ckpt.restore_state(
        tracked, create_train_state(cfg, TrainConfig(**TCFG), CPU), step=0)
    assert not torch.equal(other.rng.get_state(), state.rng.get_state())


def test_without_tensorstore_each_entry_point_names_it(tmp_path, monkeypatch):
    d, cfg = _jax_run(tmp_path, ema=False)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    for call in (lambda: from_orbax.read_orbax_tree(os.path.join(d, "3", "default")),
                 lambda: from_orbax.load_orbax_generator_state_dict(d, cfg),
                 lambda: ckpt.load_generator_state_dict(d, cfg=cfg),
                 lambda: ckpt.restore_state(d, create_train_state(cfg, TrainConfig(**TCFG), CPU))):
        with pytest.raises(ImportError, match="tensorstore"):
            call()


def test_the_port_reads_orbax_without_jax(tmp_path):
    """In a fresh process: import the port's interop and utilities, read
    an Orbax export, and find no JAX, flax, optax, orbax or JAX-package
    module loaded."""
    path = str(tmp_path / "export")
    jax_ckpt.save_params(path, random_jax_params(JaxModelConfig(**SMALL), 16))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {root!r})\n"
        "import pwstablenet_tpu_torch.interop\n"
        "import pwstablenet_tpu_torch.interop.from_orbax as fo\n"
        "import pwstablenet_tpu_torch.utils\n"
        f"tree = fo.read_orbax_tree({path!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pwstablenet_tpu'))\n"
        "print(json.dumps({'stages': sorted(tree['params']), 'bad': bad}))\n"
    )
    # -I: no PYTHON* variables and no user site, so only the port's own
    # imports can load a module
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), timeout=240, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"stages": ["stage0", "stage1"], "bad": []}
