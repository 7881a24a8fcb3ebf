"""The port's training recipes (``pwstablenet_tpu_torch.examples``) on
the CPU at a tiny model and size, against the JAX package's recipes
(``examples/``: their settings, read by running each script with its
building functions stubbed) and its ``train``, eval hook and
checkpoints; and the package-level names of the port against the JAX
package's."""

import collections
import contextlib
import dataclasses
import importlib
import inspect
import io
import json
import os
import runpy
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest

from pwstablenet_tpu.config import DataConfig as JaxDataConfig
from pwstablenet_tpu.config import ModelConfig as JaxModelConfig
from pwstablenet_tpu.config import TrainConfig as JaxTrainConfig
from pwstablenet_tpu.data import deepstab as jax_deepstab
from pwstablenet_tpu.data.synthetic import RICH as JAX_RICH
from pwstablenet_tpu.data.synthetic import synthetic_pair_clip as jax_pair_clip
from pwstablenet_tpu.eval import stability_score as jax_stability_score
from pwstablenet_tpu.eval.hooks import make_clip_eval_hook as jax_eval_hook
from pwstablenet_tpu.train import checkpoint as jax_ckpt
from pwstablenet_tpu.train.loop import train as jax_train

from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig
from pwstablenet_tpu_torch.eval import stability_report, stability_score
from pwstablenet_tpu_torch.examples import (
    deepstab_recipe,
    train_rich_deepstab,
    train_stressed_deepstab,
    train_synthetic_demo,
)
from pwstablenet_tpu_torch.pipeline import Stabilizer
from pwstablenet_tpu_torch.train import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the TINY config of tests/test_train_step.py
TINY = dict(
    temporal_window=3, num_levels=4, base_features=8, max_features=16,
    model_resolution=(32, 32), num_stages=2, disc_num_layers=2,
    feat_channels=(8, 16), compute_dtype="float32",
)
# the recipes' cuts: 2 steps on 1 pair of 12 frames of 64x96, the hook
# every step
STEPS, PAIRS = 2, 1
CUTS = dict(frames=12, size=(64, 96), eval_every=1)
RECIPES = {
    "rich": (train_rich_deepstab, ModelConfig(**TINY)),
    "stressed": (train_stressed_deepstab, ModelConfig(**TINY, use_dropout=True)),
}
METRIC_KEYS = {"loss_d", "loss_g", "grad_norm_g", "grad_norm_d", "adv", "pixel",
               "feature", "temporal", "warp_reg"}
REPORT_KEYS = {"stability_score", "jitter_rms_px", "tracked_pair_fraction",
               "original_stability_score", "original_jitter_rms_px",
               "cropping_ratio", "distortion_value"}


def _run_printed(fn, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(**kwargs)
    return result, out.getvalue().splitlines()


def _line(lines, prefix):
    (line,) = [ln for ln in lines if ln.startswith(prefix)]
    return line[len(prefix):]


@pytest.fixture(scope="module", params=sorted(RECIPES))
def recipe_run(request, tmp_path_factory):
    module, cfg = RECIPES[request.param]
    work = str(tmp_path_factory.mktemp(request.param))
    result, lines = _run_printed(module.run, steps=STEPS, pairs=PAIRS, work_dir=work,
                                 model_cfg=cfg, device="cpu", **CUTS)
    return request.param, cfg, result, lines


def test_recipe_runs_to_its_end_and_prints_the_jax_keys(recipe_run):
    name, _, result, lines = recipe_run
    assert _line(lines, "writing ").startswith(f"{PAIRS}-pair {name} dataset under ")
    assert _line(lines, "dataset: ") == f"{PAIRS} pairs"
    records = [json.loads(ln) for ln in lines if ln.startswith("{")]
    metrics = [r for r in records if "loss_g" in r]
    hooks = [r for r in records if "eval_stability" in r]
    # logged every 50 steps and at the last; the hook every step
    assert [m["step"] for m in metrics] == [STEPS]
    assert [h["step"] for h in hooks] == list(range(1, STEPS + 1))
    for m in metrics:
        assert set(m) == METRIC_KEYS | {"step", "sec_per_step"}
        assert all(np.isfinite(v) for v in m.values())
    for h in hooks:
        assert set(h) == {"eval_stability", "eval_stability_unstable",
                          "eval_psnr_vs_stable", "step"}
    assert json.loads(_line(lines, "best: ")) == result["best"]
    for label in ("ema", "best"):
        report = json.loads(_line(lines, f"EVAL[{label}] "))
        assert set(report) == REPORT_KEYS
        assert report == {k: round(v, 4) for k, v in result["evals"][label].items()}
    assert float(_line(lines, "gt-stable ceiling: ")) == round(result["gt_stable_ceiling"], 4)
    assert set(json.loads(_line(lines, "seconds: "))) == {
        "make_data", "clips", "train", "evals", "total", "sec_per_step", "steps_per_s"}
    assert result["pairs"] == PAIRS and result["log"] == metrics and result["hooks"] == hooks


def test_best_record_is_the_largest_hook_reading_and_reloads(recipe_run):
    """``best_step.json`` holds the largest logged ``eval_stability``; the
    ``best`` export, in a fresh ``Stabilizer``, scores it again."""
    _, cfg, result, _ = recipe_run
    values = [h["eval_stability"] for h in result["hooks"]]
    best = ckpt.best_step(result["checkpoint_dir"])
    assert best == result["best"]
    assert best["metric"] == "eval_stability" and best["value"] == max(values)
    assert best["step"] == result["hooks"][values.index(max(values))]["step"]
    stab = Stabilizer(cfg, PipelineConfig(batch_windows=8), device="cpu",
                      state_dict=ckpt.load_generator_state_dict(result["checkpoint_dir"],
                                                                step="best"))
    out, _ = stab.stabilize_frames(result["hook_clip"])
    assert abs(stability_score(out.astype(np.float32) / 127.5 - 1.0) - best["value"]) <= 1e-6


def test_rich_recipe_matches_the_jax_package(tmp_path):
    """The rich recipe's settings at the tiny size through the JAX
    package's ``train``, eval hook and checkpoints: the same unstable
    baseline and the same record keys as the port's run."""
    port_cfg = ModelConfig(**TINY)
    port, _ = _run_printed(train_rich_deepstab.run, steps=STEPS, pairs=PAIRS,
                           work_dir=str(tmp_path / "port"), model_cfg=port_cfg,
                           device="cpu", **CUTS)
    # the JAX script's body (examples/train_rich_deepstab.py) at the cuts
    root, ckpt_dir = str(tmp_path / "jax" / "data"), str(tmp_path / "jax" / "ckpt")
    h, w = CUTS["size"]
    jax_deepstab.write_synthetic_deepstab(root, num_pairs=PAIRS, frames=CUTS["frames"],
                                          height=h, width=w, seed=5, rich=True)
    cfg = JaxModelConfig(**TINY)
    tcfg = JaxTrainConfig(batch_size=8, num_epochs=1, steps_per_epoch=STEPS, w_feature=1.0,
                          log_every=50, checkpoint_every=500, checkpoint_dir=ckpt_dir,
                          ema_decay=0.995, eval_every=CUTS["eval_every"])
    ds = jax_deepstab.DeepStabDataset(
        JaxDataConfig(data_root=root, crop_size=cfg.model_resolution, num_decode_threads=4),
        cfg.temporal_window)
    stable, unstable = jax_pair_clip(32, h, w, seed=999, shake_px=7.0, **JAX_RICH)
    clip_u8 = np.clip((unstable + 1) * 127.5, 0, 255).round().astype(np.uint8)
    records = []
    jax_train(cfg, tcfg, jax_deepstab.batch_iterator(ds, tcfg.batch_size, seed=0),
              max_steps=STEPS, log_fn=records.append,
              eval_fn=jax_eval_hook(cfg, clip_u8, stable_clip=stable, batch_windows=8))
    hooks = [r for r in records if "eval_stability" in r]
    metrics = [r for r in records if "eval_stability" not in r]
    assert [h_["step"] for h_ in hooks] == [h_["step"] for h_ in port["hooks"]]
    for a, b in zip(hooks, port["hooks"]):
        assert set(a) == set(b)
        assert abs(a["eval_stability_unstable"] - b["eval_stability_unstable"]) <= 1e-6
    assert [m["step"] for m in metrics] == [m["step"] for m in port["log"]]
    assert all(set(a) == set(b) for a, b in zip(metrics, port["log"]))
    assert set(jax_ckpt.best_step(ckpt_dir)) == set(port["best"])


@pytest.mark.parametrize("clip", ["hook", "eval"])
def test_recipe_clips_match_the_jax_package(clip):
    frames, seed = {"hook": deepstab_recipe.HOOK_CLIP, "eval": deepstab_recipe.EVAL_CLIP}[clip]
    assert (frames, seed) == {"hook": (32, 999), "eval": (48, 1234)}[clip]
    stable, unstable, u8 = deepstab_recipe.rich_clip(frames, (40, 56), seed)
    j_stable, j_unstable = jax_pair_clip(frames, 40, 56, seed=seed, shake_px=7.0, **JAX_RICH)
    np.testing.assert_array_equal(stable, j_stable)
    np.testing.assert_array_equal(unstable, j_unstable)
    np.testing.assert_array_equal(
        u8, np.clip((j_unstable + 1) * 127.5, 0, 255).round().astype(np.uint8))


def test_rich_eval_clip_scores_its_stable_camera_below_its_shaky_view():
    """Why the rich recipes' ``EVAL`` cannot show learning by
    ``stability_score`` (``ROADMAP.md`` Queue 3): on their fresh clip
    (48 frames of 320x448) the spectral score does not rank by shake,
    and the ground-truth stable camera reads below the shaky view; the
    jitter in px ranks the two as expected.  The JAX package's metric
    reads the same."""
    frames, seed = deepstab_recipe.EVAL_CLIP
    stable, unstable, _ = deepstab_recipe.rich_clip(frames, (320, 448), seed)
    calm, shaky = stability_report(stable), stability_report(unstable)
    assert calm["tracked_pair_fraction"] == shaky["tracked_pair_fraction"] == 1.0
    assert calm["stability_score"] < shaky["stability_score"]
    assert calm["jitter_rms_px"] < 0.1 and shaky["jitter_rms_px"] > 5.0
    for clip, report in ((stable, calm), (unstable, shaky)):
        assert abs(jax_stability_score(clip) - report["stability_score"]) <= 1e-6


def test_synthetic_demo_runs_to_its_end(tmp_path):
    cfg = ModelConfig(**TINY)
    result, lines = _run_printed(train_synthetic_demo.run, steps=3, work_dir=str(tmp_path),
                                 model_cfg=cfg, device="cpu")
    assert lines[0] == "pre-generating batches..." and lines[-1] == "DONE"
    assert "params saved" in lines
    records = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r["step"] for r in records] == [0, 2]
    assert all(set(r) == METRIC_KEYS | {"step", "elapsed"} for r in records)
    report = json.loads(_line(lines, "EVAL "))
    assert set(report) == REPORT_KEYS | {"gt_stable_score", "mean_abs_flow_px"}
    assert all(np.isfinite(v) for v in report.values())
    assert result["params"] == str(tmp_path / "checkpoints" / "demo_params")
    saved = ckpt.load_generator_state_dict(result["params"])
    assert saved.keys() == Stabilizer(cfg, device="cpu").model.state_dict().keys()


class _Calls:
    """The calls a recipe makes to the functions it is built from, each
    bound to the real function's signature with its defaults: configs as
    ``dataclasses.asdict``, arrays by shape, dtype and mean, paths below
    the work directory relative to it."""

    # arguments that name the same thing in the two packages
    RENAME = {"directory": "path", "state_dict": "params"}
    # arguments that only one package has, or objects the stubs made
    DROP = {"device", "rng", "gen", "disc", "feat", "grad_sync", "dataset", "cfg",
            "batch_iterator", "log_fn"}

    def __init__(self, work):
        self.work = work
        self.calls = collections.defaultdict(list)

    def _value(self, v):
        if dataclasses.is_dataclass(v):
            return type(v).__name__, self._value(dataclasses.asdict(v))
        if isinstance(v, np.ndarray):
            return "array", v.shape, str(v.dtype), round(float(v.mean()), 6)
        if isinstance(v, dict):
            return {k: self._value(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(self._value(x) for x in v)
        if isinstance(v, str) and os.sep in v:
            return os.path.relpath(os.path.normpath(v), self.work)
        return v

    def stub(self, event, real, ret=None):
        sig = inspect.signature(real)

        def fn(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            self.calls[event].append({
                self.RENAME.get(k, k): self._value(v)
                for k, v in bound.arguments.items() if k not in self.DROP})
            return ret(bound.arguments) if callable(ret) else ret
        return fn

    def stabilizer(self, real):
        record = self.stub("Stabilizer", real)
        calls = self

        class Stub:
            def __init__(self, *args, **kwargs):
                record(*args, **kwargs)

            def stabilize_frames(self, frames):
                calls.calls["stabilize_frames"].append(calls._value(frames))
                return frames, np.zeros(1, np.float32)
        return Stub

    def by_event(self):
        return {k: sorted(v, key=repr) for k, v in self.calls.items()}


def _clip(num_frames, height, width, seed=0, **_):
    """A stand-in clip pair, told apart by its seed."""
    shape = (num_frames, 2, 2, 3)
    return np.full(shape, -0.5, np.float32), np.full(shape, seed % 100 / 100, np.float32)


def _stub_common(monkeypatch, calls, pkg):
    """The clip renderer, the metric and the ``Stabilizer`` of ``pkg``,
    stubbed and recorded."""
    data = importlib.import_module(f"{pkg}.data")
    synthetic = importlib.import_module(f"{pkg}.data.synthetic")
    ev = importlib.import_module(f"{pkg}.eval")
    pipeline = importlib.import_module(f"{pkg}.pipeline")
    clip = calls.stub("synthetic_pair_clip", synthetic.synthetic_pair_clip, lambda a: _clip(**a))
    monkeypatch.setattr(synthetic, "synthetic_pair_clip", clip)
    monkeypatch.setattr(data, "synthetic_pair_clip", clip)
    monkeypatch.setattr(ev, "stability_report", calls.stub(
        "stability_report", ev.stability_report, {"stability_score": 0.5}))
    monkeypatch.setattr(pipeline, "Stabilizer", calls.stabilizer(pipeline.Stabilizer))


def _stub_deepstab(monkeypatch, calls, pkg):
    """Everything ``train_*_deepstab`` calls beyond the stdlib, stubbed
    and recorded: nothing is rendered, trained or written."""
    _stub_common(monkeypatch, calls, pkg)
    deepstab = importlib.import_module(f"{pkg}.data.deepstab")
    hooks = importlib.import_module(f"{pkg}.eval.hooks")
    loop = importlib.import_module(f"{pkg}.train.loop")
    ck = importlib.import_module(f"{pkg}.train.checkpoint")
    monkeypatch.setattr(tempfile, "mkdtemp", calls.stub(
        "mkdtemp", tempfile.mkdtemp, calls.work))
    monkeypatch.setattr(deepstab, "write_synthetic_deepstab", calls.stub(
        "write_synthetic_deepstab", deepstab.write_synthetic_deepstab))
    monkeypatch.setattr(deepstab, "DeepStabDataset", calls.stub(
        "DeepStabDataset", deepstab.DeepStabDataset,
        lambda a: types.SimpleNamespace(
            pairs=[None] * calls.calls["write_synthetic_deepstab"][-1]["num_pairs"])))
    monkeypatch.setattr(deepstab, "batch_iterator", calls.stub(
        "batch_iterator", deepstab.batch_iterator,
        types.SimpleNamespace(close=lambda: None)))
    monkeypatch.setattr(hooks, "make_clip_eval_hook", calls.stub(
        "make_clip_eval_hook", hooks.make_clip_eval_hook, "hook"))

    def trained(a):
        if a["log_fn"] is not None:
            a["log_fn"]({"step": a["max_steps"], "sec_per_step": 1.0})
        ema = types.SimpleNamespace(state_dict=lambda: "ema")
        return types.SimpleNamespace(generator_params=lambda: ema)

    monkeypatch.setattr(loop, "train", calls.stub("train", loop.train, trained))
    monkeypatch.setattr(ck, "best_step", calls.stub(
        "best_step", ck.best_step, {"step": 1, "metric": "eval_stability", "value": 0.5}))
    if pkg == "pwstablenet_tpu":
        state = importlib.import_module(f"{pkg}.train.state")
        monkeypatch.setattr(state, "generator_params", lambda s: "ema")
        load = "load_generator_params"
    else:
        load = "load_generator_state_dict"
    monkeypatch.setattr(ck, load, calls.stub("load_generator", getattr(ck, load), "best"))


def _stub_demo(monkeypatch, calls, pkg):
    """Everything ``train_synthetic_demo`` calls beyond the stdlib, stubbed
    and recorded; each train step counted."""
    _stub_common(monkeypatch, calls, pkg)
    data = importlib.import_module(f"{pkg}.data")
    train_pkg = importlib.import_module(f"{pkg}.train")
    ck = importlib.import_module(f"{pkg}.train.checkpoint")
    monkeypatch.setattr(data, "make_train_batch", calls.stub(
        "make_train_batch", data.make_train_batch, {}))

    def step(state, batch):
        done = calls.calls["steps"]
        calls.calls["steps"] = [(done[0] if done else 0) + 1]
        return state, {"loss_g": 1.0}

    state = types.SimpleNamespace(g_params="g", g=types.SimpleNamespace(state_dict=lambda: "g"))
    if pkg == "pwstablenet_tpu":
        import jax

        monkeypatch.setattr(jax, "jit", lambda f: f)
        monkeypatch.setattr(train_pkg, "create_train_state", calls.stub(
            "create_train_state", train_pkg.create_train_state, (state, (None,) * 3)))
        monkeypatch.setattr(train_pkg, "make_train_step", calls.stub(
            "make_train_step", train_pkg.make_train_step, lambda a: step))
        monkeypatch.setattr(ck, "save_params", calls.stub("save", ck.save_params))
    else:
        loop = importlib.import_module(f"{pkg}.train.loop")
        monkeypatch.setattr(loop, "batch_to_device", lambda batch, device: batch)
        monkeypatch.setattr(train_pkg, "create_train_state", calls.stub(
            "create_train_state", train_pkg.create_train_state, state))
        monkeypatch.setattr(train_pkg, "make_train_step", calls.stub(
            "make_train_step", train_pkg.make_train_step,
            lambda a: lambda s, b: step(s, b)[1]))
        monkeypatch.setattr(ck, "save_generator_state_dict",
                            calls.stub("save", ck.save_generator_state_dict))


SETTINGS = {
    "train_synthetic_demo": (train_synthetic_demo, _stub_demo, "steps"),
    "train_rich_deepstab": (train_rich_deepstab, _stub_deepstab, "train"),
    "train_stressed_deepstab": (train_stressed_deepstab, _stub_deepstab, "train"),
}


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_recipe_settings_match_the_jax_script(name, tmp_path, monkeypatch):
    """Each recipe at its defaults passes the JAX script's own settings
    (``examples/<name>.py``, run here as a script with its default
    arguments) to every function it is built from: the configs field by
    field, the data and clip arguments, steps, paths and the checkpoint
    reloaded, with the building functions stubbed on both sides."""
    module, stub, event = SETTINGS[name]
    script = os.path.join(REPO, "examples", f"{name}.py")
    sides = {}
    for pkg in ("pwstablenet_tpu", "pwstablenet_tpu_torch"):
        work = tmp_path / pkg
        work.mkdir()
        monkeypatch.chdir(work)
        calls = _Calls(str(work))
        with monkeypatch.context() as m, contextlib.redirect_stdout(io.StringIO()):
            stub(m, calls, pkg)
            if pkg == "pwstablenet_tpu":
                m.setattr(sys, "argv", [script])
                runpy.run_path(script, run_name="__main__")
            else:
                module.run(device="cpu")
        sides[pkg] = calls.by_event()
    jax_side, port_side = sides["pwstablenet_tpu"], sides["pwstablenet_tpu_torch"]
    assert jax_side[event] and set(jax_side) == set(port_side)
    for key in sorted(jax_side):
        assert port_side[key] == jax_side[key], key


def test_importing_a_recipe_runs_nothing(tmp_path):
    code = r"""
import importlib, sys
for name in ("train_synthetic_demo", "train_rich_deepstab", "train_stressed_deepstab",
             "deepstab_recipe"):
    importlib.import_module("pwstablenet_tpu_torch.examples." + name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pwstablenet_tpu"))
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == "" and os.listdir(tmp_path) == []


# JAX names with no port name of the same spelling, and the port's
# counterpart of each (module path, then attributes)
COUNTERPARTS = {
    "pwstablenet_tpu.train.generator_params":
        "pwstablenet_tpu_torch.train.state:TrainState.generator_params",
    "pwstablenet_tpu.train.create_models":
        "pwstablenet_tpu_torch.train.state:create_train_state",
    "pwstablenet_tpu.train.make_optimizers":
        "pwstablenet_tpu_torch.train.state:create_train_state",
    "pwstablenet_tpu.kernels.grid_sample_pallas":
        "pwstablenet_tpu_torch.kernels.grid_sample:grid_sample_f32",
    "pwstablenet_tpu.interop.feat_state_dict_to_flax":
        "pwstablenet_tpu_torch.interop.torch_import:feat_state_dict_to_port",
    "pwstablenet_tpu.interop.flax_to_torch_state_dict":
        "pwstablenet_tpu_torch.interop.torch_import:port_to_torch_state_dict",
    "pwstablenet_tpu.interop.torch_state_dict_to_flax":
        "pwstablenet_tpu_torch.interop.torch_import:torch_state_dict_to_port",
    "pwstablenet_tpu.interop.torchvision_vgg_to_flax":
        "pwstablenet_tpu_torch.interop.torch_import:torchvision_vgg_to_port",
    # shardings of the JAX mesh: the port shards and replicates tensors
    "pwstablenet_tpu.parallel.batch_sharding":
        "pwstablenet_tpu_torch.parallel.mesh:shard_batch",
    "pwstablenet_tpu.parallel.replicated":
        "pwstablenet_tpu_torch.parallel.mesh:replicate_tree",
}
SUBPACKAGES = ["", ".cli", ".data", ".eval", ".interop", ".kernels", ".models", ".ops",
               ".parallel", ".train", ".utils"]


def _public_names(module):
    names = {n for n, v in vars(module).items()
             if not n.startswith("_") and not inspect.ismodule(v)}
    return names | ({"__version__"} if hasattr(module, "__version__") else set())


def _resolve(target):
    path, attrs = target.split(":")
    obj = importlib.import_module(path)
    for attr in attrs.split("."):
        obj = getattr(obj, attr)
    return obj


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s.strip(".") or "root")
def test_package_names_match_the_jax_package(sub):
    """Every public name of a JAX (sub)package's ``__init__`` is in the
    port's same (sub)package, or ``COUNTERPARTS`` names one that exists."""
    jax_mod = importlib.import_module("pwstablenet_tpu" + sub)
    port_mod = importlib.import_module("pwstablenet_tpu_torch" + sub)
    names = _public_names(jax_mod)
    assert names
    missing = []
    for name in sorted(names):
        key = f"pwstablenet_tpu{sub}.{name}"
        if key in COUNTERPARTS:
            assert not hasattr(port_mod, name), f"{key}: both a counterpart and the name"
            assert callable(_resolve(COUNTERPARTS[key])), key
        elif not hasattr(port_mod, name):
            missing.append(key)
    assert not missing
    if sub == "":
        assert port_mod.__version__ == jax_mod.__version__


def test_importing_the_package_builds_nothing_and_leaves_jax_out():
    code = r"""
import importlib, sys
import torch
for sub in ("", ".data", ".eval", ".train", ".models", ".ops"):
    importlib.import_module("pwstablenet_tpu_torch" + sub)
from pwstablenet_tpu_torch.kernels import _build
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pwstablenet_tpu"))
assert not bad, bad
assert not torch.cuda.is_initialized()
assert _build.library.cache_info().currsize == 0
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_every_module_of_the_port_imports_first():
    """Each module of the port, imported first in a fresh interpreter
    (a child forked before any port module is loaded), imports: the
    package-level re-exports add no import cycle (``kernels.grid_sample``
    imports ``ops``, whose ``__init__`` imports ``ops.warp``, which
    needs ``kernels.grid_sample``)."""
    code = r"""
import importlib, os, sys
import torch  # the children inherit it
root = os.path.join(sys.argv[1], "pwstablenet_tpu_torch")
names = []
for d, _, files in os.walk(root):
    rel = os.path.relpath(d, sys.argv[1]).replace(os.sep, ".")
    names += [rel if f == "__init__.py" else f"{rel}.{f[:-3]}"
              for f in files if f.endswith(".py") and "__pycache__" not in d]
assert not any(m.startswith("pwstablenet_tpu_torch") for m in sys.modules)
failed = []
for name in sorted(names):
    pid = os.fork()
    if pid == 0:
        try:
            importlib.import_module(name)
        except BaseException as e:
            print(name, repr(e), flush=True)
            os._exit(1)
        os._exit(0)
    if os.waitpid(pid, 0)[1]:
        failed.append(name)
assert len(names) >= 40 and not failed, (len(names), failed)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code, REPO], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
