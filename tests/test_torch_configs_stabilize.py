"""The JAX package's non-default settings, the combinations of
``chip_smoke.CONFIGS``, through the port's ``Stabilizer`` against the
JAX package's on the CPU; what the combinations reach (with the
defaults, every value of every choice that the port's config and CLI
offer); and the kernel launches that ``chip_smoke.config_launches``
derives for them, counted here on the plain versions.

Each combination's model and pipeline overrides at ``SMALL`` (the
pipeline tests' model, f32 activations), with weights drawn from one
seed for both packages: ``stabilize_frames`` of an 11-frame clip in
chunks of 4 windows (two full chunks carrying the halo, then a padded
flush chunk), then the port's ``stabilize_video`` of the clip as a
lossless file (held to the reference's border crop of its frames, and
the warp-field archive, or none without ``emit_warp_fields``).  Tolerances: float32 fields atol 5e-4, float16
fields atol 1e-3, bfloat16 fields MSE <= 1e-3 and max |diff| <= 2e-2 (as
``test_generator_matches_flax_bf16`` holds), frames +-1 code."""

import dataclasses
import inspect
import os
import re

import numpy as np
import pytest

import chip_smoke
from chip_smoke import CONFIGS
from pwstablenet_tpu_torch import config as port_config
from pwstablenet_tpu_torch.cli.main import _model_cfg, build_parser
from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig, TrainConfig
from pwstablenet_tpu_torch.data import video_io
from pwstablenet_tpu_torch.data.synthetic import make_train_batch
from pwstablenet_tpu_torch.data.warp_fields import load_warp_fields
from pwstablenet_tpu_torch.kernels import grid_sample as K
from pwstablenet_tpu_torch.pipeline import Stabilizer
from pwstablenet_tpu_torch.train.loop import train

from test_torch_port_pipeline import _clip, _pair

SECTIONS = {"model": ModelConfig, "pipeline": PipelineConfig, "train": TrainConfig}
# a CLI flag's dest where it is not the config field's name
CLI_FIELDS = {"warp_dtype": "warp_field_dtype"}
# the settings that are not choices among names: the values a run must take
OPTIONS = {
    "num_stages": {"1": lambda v: v == 1, "2 or more": lambda v: v >= 2},
    "grad_accum_steps": {"> 1": lambda v: v > 1},
    "ema_decay": {"> 0": lambda v: v > 0},
    "border_crop_frac": {"> 0": lambda v: v > 0},
}


def _fields():
    return {f.name: cls for cls in SECTIONS.values() for f in dataclasses.fields(cls)}


def choices():
    """Each choice field's values as the port states them: the
    ``# a | b | c`` comment beside the field in ``config.py``, the
    ``choices=`` of the CLI flag that sets it, and both values of every
    boolean field of ``ModelConfig`` and ``PipelineConfig``."""
    fields = _fields()
    found = {}
    for m in re.finditer(r"^\s+(\w+): \w+ = \S+\s+#\s*(\w+(?:\s*\|\s*\w+)+)",
                         inspect.getsource(port_config), re.M):
        found.setdefault(m.group(1), set()).update(v.strip() for v in m.group(2).split("|"))
    sub = next(a for a in build_parser()._actions if a.choices and "train" in a.choices)
    for parser in sub.choices.values():
        for action in parser._actions:
            if action.choices is None:
                continue
            field = CLI_FIELDS.get(action.dest, action.dest)
            assert field in fields, f"--{action.dest}: no config field {field!r}"
            found.setdefault(field, set()).update(action.choices)
    for cls in (ModelConfig, PipelineConfig):
        for f in dataclasses.fields(cls):
            if f.type == "bool":
                found[f.name] = {True, False}
    return found


def missing(configs):
    """The choice values and options that neither the defaults nor any
    combination of ``configs`` takes."""
    runs = [{}] + list(configs.values())
    taken = {}
    for run in runs:
        for section, cls in SECTIONS.items():
            made = cls(**run.get(section, {}))
            for f in dataclasses.fields(cls):
                taken.setdefault(f.name, []).append(getattr(made, f.name))
    gaps = [(name, v) for name, values in choices().items()
            for v in sorted(values, key=str) if v not in taken[name]]
    gaps += [(name, what) for name, tests in OPTIONS.items()
             for what, ok in tests.items() if not any(ok(v) for v in taken[name])]
    return gaps


def test_the_combinations_take_every_choice_of_the_port():
    found = choices()
    # the reading itself works: the fields that hold a choice, each
    # with at least two values
    assert {"norm", "disc_norm", "interstage", "decoder_impl", "padding_mode",
            "compute_dtype", "gan_loss", "pixel_loss_mode", "temporal_mode",
            "warp_field_dtype", "align_corners", "use_dropout", "emit_warp_fields"} <= set(found)
    assert all(len(v) >= 2 for v in found.values()), found
    assert missing(CONFIGS) == []


OVERRIDES = [(name, section, key) for name, combo in CONFIGS.items()
             for section, over in combo.items() for key in over]


@pytest.mark.parametrize("name,section,key", OVERRIDES,
                         ids=["/".join(o) for o in OVERRIDES])
def test_each_override_is_the_only_run_of_its_value(name, section, key):
    """Taking any one override out of the combinations leaves a choice
    value or an option that no run takes: the coverage test fails."""
    cut = {n: {s: {k: v for k, v in over.items() if (n, s, k) != (name, section, key)}
               for s, over in combo.items()} for n, combo in CONFIGS.items()}
    assert missing(cut) != []


def test_the_cli_flags_of_the_configs_phase_are_a_s_settings():
    """``chip_smoke.py`` drives the CLI with A's settings, as far as the
    CLI has flags for them."""
    a = CONFIGS["A-group-phaseconv-features-zeros"]
    args = build_parser().parse_args(
        ["train", "--synthetic", *chip_smoke.CONFIGS_CLI_MODEL, *chip_smoke.CONFIGS_CLI_TRAIN])
    cfg = _model_cfg(args)
    for k in ("norm", "decoder_impl", "interstage"):
        assert getattr(cfg, k) == a["model"][k]
    got = {"gan_loss": args.gan_loss, "pixel_loss_mode": args.pixel_loss_mode,
           "temporal_mode": args.temporal_mode, "grad_accum_steps": args.grad_accum}
    assert got == a["train"]


def _assert_fields_close(flows, ref_flows, dtype):
    assert flows.dtype == ref_flows.dtype and flows.shape == ref_flows.shape
    ours, theirs = flows.astype(np.float32), ref_flows.astype(np.float32)
    assert np.abs(theirs).max() > 1e-2  # a real warp
    if dtype == "bfloat16":
        mse = float(np.mean((ours - theirs) ** 2))
        assert mse <= 1e-3, f"warp-map MSE {mse}"
        np.testing.assert_allclose(ours, theirs, atol=2e-2)
    else:
        np.testing.assert_allclose(ours, theirs, atol=1e-3 if dtype == "float16" else 5e-4)


def _codes(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stabilizer_matches_jax(name, tmp_path):
    combo = CONFIGS[name]
    model = {**combo["model"], "compute_dtype": "float32"}
    pipe = {**combo["pipeline"], "output_codec": "FFV1"}
    ref, port = _pair(model, 4, **pipe)
    clip = _clip(frames=11)
    ref_out, ref_flows = ref.stabilize_frames(clip)
    out, flows = port.stabilize_frames(clip)
    assert out.shape == clip.shape and out.dtype == ref_out.dtype == np.uint8
    assert _codes(out, ref_out) <= 1
    _assert_fields_close(flows, ref_flows, port.pipeline_cfg.warp_field_dtype)

    # the file path: the port's encoder takes the cropped size (the
    # reference's own stabilize_video does not: ROADMAP.md Queue 3), so
    # the file is held to the reference's crop of its frames
    src, dst, wf = (str(tmp_path / n) for n in ("clip.avi", "out.avi", "fields.npz"))
    video_io.write_video(src, clip, 30.0, codec="FFV1")
    res = port.stabilize_video(src, dst, warp_field_path=wf)
    got, _ = video_io.read_video(dst, dtype=np.uint8)
    cropped = ref._border_crop(ref_out)
    frac = port.pipeline_cfg.border_crop_frac
    assert got.shape == cropped.shape == (11, 48 - 2 * int(48 * frac), 64 - 2 * int(64 * frac), 3)
    assert np.array_equal(got, port._border_crop(out))
    assert _codes(got, cropped) <= 1
    emitted = port.pipeline_cfg.emit_warp_fields
    assert emitted == ref.pipeline_cfg.emit_warp_fields
    assert ("warp_fields" in res) == os.path.exists(wf) == emitted
    if emitted:
        kept = load_warp_fields(wf)
        assert kept.dtype == flows.dtype
        assert np.array_equal(kept.view(np.uint8), flows.view(np.uint8))


def _counting(monkeypatch):
    """Count the calls of each kernel wrapper (on the CPU the wrappers
    run the plain versions, which ``K.LAUNCHES`` does not count)."""
    calls = dict.fromkeys(K.LAUNCHES, 0)
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(K, name), **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(K, name, counted)
    return calls


@pytest.mark.parametrize("name", list(CONFIGS) + ["defaults"])
def test_config_launches_counts_what_the_code_calls(name, monkeypatch, tmp_path):
    """``config_launches`` against the wrappers' calls: ``stabilize_frames``
    of a 19-frame clip in chunks of 8 windows (3 chunks, as the configs
    phase's 24 frames), uint8 and float, and two steps of ``train()``, at
    a tiny model with each combination's settings."""
    combo = CONFIGS.get(name, {"model": {}, "pipeline": {}, "train": {}})
    model = {**chip_smoke.TINY_TRAIN, **combo["model"]}
    cfg = ModelConfig(**model)
    calls = _counting(monkeypatch)
    st = Stabilizer(cfg, PipelineConfig(batch_windows=8, **combo["pipeline"]), device="cpu")
    clip = _clip(frames=19)
    st.stabilize_frames(clip)
    assert calls == chip_smoke.config_launches(model, chunks=3)
    # a float clip (the CLI's synthetic one) takes the f32 output warp
    calls.update(dict.fromkeys(calls, 0))
    st.stabilize_frames(clip.astype(np.float32) / 127.5 - 1.0)
    assert calls == chip_smoke.config_launches(model, chunks=3, uint8=False)

    calls.update(dict.fromkeys(calls, 0))
    tcfg = TrainConfig(batch_size=2, log_every=1, checkpoint_dir=str(tmp_path),
                       **combo["train"])
    h, w = cfg.model_resolution
    batches = [make_train_batch(2, h, w, cfg.temporal_window, seed=seed) for seed in range(2)]
    train(cfg, tcfg, iter(batches), max_steps=2, log_fn=lambda m: None, device="cpu")
    assert calls == chip_smoke.config_launches(model, steps=2, accum=tcfg.grad_accum_steps)
