"""The port's command line (``pwstablenet_tpu_torch.cli``) on the CPU
(``--device cpu``), in process, at the TINY model sizes: every ported
subcommand, its output line, its files, the data-parallel flags in a
single process, checkpoints from the reference's ``.pth`` and the JAX
package's Orbax directories, and the subcommand not written yet."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pwstablenet_tpu.cli import main as jax_main
from pwstablenet_tpu.config import ModelConfig as JaxModelConfig
from pwstablenet_tpu.config import TrainConfig as JaxTrainConfig
from pwstablenet_tpu.data import warp_fields as jax_warp_fields
from pwstablenet_tpu.interop.torch_ref import TorchCascadedGenerator as JaxTorchGenerator
from pwstablenet_tpu.train import checkpoint as jax_ckpt
from pwstablenet_tpu.train import create_train_state as jax_create_train_state

from pwstablenet_tpu_torch.cli import main
from pwstablenet_tpu_torch.config import DataConfig, ModelConfig, PipelineConfig
from pwstablenet_tpu_torch.data import video_io, warp_fields
from pwstablenet_tpu_torch.data.deepstab import DeepStabDataset
from pwstablenet_tpu_torch.data.synthetic import synthetic_pair_clip
from pwstablenet_tpu_torch.export import ExportedStabilizerStep
from pwstablenet_tpu_torch.interop import jax_params_to_state_dict, load_torch_checkpoint
from pwstablenet_tpu_torch.pipeline import Stabilizer
from pwstablenet_tpu_torch.train import checkpoint as ckpt
from pwstablenet_tpu_torch.utils.tb_writer import read_event_file

# the TINY model of tests/test_torch_port_train.py, as flags
MODEL = ["--temporal-window", "3", "--num-levels", "4", "--base-features", "8",
         "--max-features", "16", "--model-height", "32", "--model-width", "32",
         "--disc-layers", "2"]
TINY = ModelConfig(temporal_window=3, num_levels=4, base_features=8, max_features=16,
                   model_resolution=(32, 32), disc_num_layers=2)
CPU = ["--device", "cpu"]


def _last_json(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def _strict_loads(line):
    def refuse(token):
        raise ValueError(f"non-strict JSON token {token}")

    return json.loads(line, parse_constant=refuse)


def test_stabilize_synthetic_writes_video_and_fields(tmp_path, capsys):
    out, wf = str(tmp_path / "out.avi"), str(tmp_path / "wf.npz")
    rc = main(["stabilize", "--synthetic", "--frames", "10", "--height", "48",
               "--width", "64", "--batch-windows", "4", "--output", out,
               "--warp-fields", wf, "--warp-dtype", "float16", *MODEL, *CPU])
    assert rc == 0
    assert _last_json(capsys) == {"frames": 10, "shape": [10, 48, 64, 3], "output": out}
    assert video_io.read_video(out)[0].shape == (10, 48, 64, 3)
    flows = warp_fields.load_warp_fields(wf)
    assert flows.shape == (10, 32, 32, 2) and flows.dtype == np.float16
    np.testing.assert_array_equal(jax_warp_fields.load_warp_fields(wf), flows)
    # the seed-0 generator of the CLI, on the seed-0 synthetic clip
    _, clip = synthetic_pair_clip(10, 48, 64, seed=0)
    st = Stabilizer(TINY, PipelineConfig(batch_windows=4, warp_field_dtype="float16"),
                    device="cpu")
    np.testing.assert_array_equal(st.stabilize_frames(clip)[1], flows)


def test_train_tb_scalars_eval_ema_export_then_stabilize(tmp_path, capsys):
    """train --synthetic with every logging flag and the eval hook; its
    --export-params and its best-eval step load into stabilize."""
    tb, log = str(tmp_path / "tb"), str(tmp_path / "scalars.jsonl")
    exported, ck = str(tmp_path / "gen"), str(tmp_path / "ckpt")
    rc = main(["train", "--synthetic", "--steps", "2", "--batch-size", "2",
               "--log-every", "1", "--checkpoint-every", "2", "--checkpoint-dir", ck,
               "--ema-decay", "0.9", "--tb-log-dir", tb, "--scalar-log", log,
               "--eval-every", "2", "--export-params", exported, *MODEL, *CPU])
    assert rc == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [m["step"] for m in lines if "loss_g" in m] == [1, 2]
    assert [m["step"] for m in lines if "eval_stability" in m] == [2]
    with open(log) as f:
        assert [json.loads(ln) for ln in f] == lines
    (events,) = glob.glob(tb + "/events.out.tfevents.*")
    tags = {k for e in read_event_file(events) for k in e.get("scalars", {})}
    assert {"loss_g", "loss_d", "eval_stability"} <= tags
    # the export is the EMA copy, as is the best-eval export
    sd = ckpt.load_generator_state_dict(exported)
    assert all(torch.equal(v, ckpt.load_generator_state_dict(ck)[k]) for k, v in sd.items())
    assert all(torch.equal(v, ckpt.load_generator_state_dict(ck, step="best")[k])
               for k, v in sd.items())

    for source in (["--checkpoint", exported], ["--checkpoint", ck, "--checkpoint-step", "best"],
                   ["--checkpoint", ck, "--checkpoint-step", "2"]):
        rc = main(["stabilize", "--synthetic", "--frames", "6", "--height", "48",
                   "--width", "64", "--batch-windows", "3", *source, *MODEL, *CPU])
        assert rc == 0 and _last_json(capsys)["frames"] == 6
    with pytest.raises(FileNotFoundError, match="step 7"):
        main(["stabilize", "--synthetic", "--frames", "6", "--checkpoint", ck,
              "--checkpoint-step", "7", *MODEL, *CPU])


def test_train_resume_continues(tmp_path, capsys):
    ck = str(tmp_path / "ckpt")
    args = ["train", "--synthetic", "--batch-size", "2", "--log-every", "1",
            "--checkpoint-every", "1", "--checkpoint-dir", ck, *MODEL, *CPU]
    assert main([*args, "--steps", "1"]) == 0
    assert main([*args, "--steps", "2", "--resume"]) == 0
    captured = capsys.readouterr()
    assert json.dumps({"event": "resumed", "step": 1}) in captured.err
    steps = [json.loads(ln)["step"] for ln in captured.out.splitlines() if ln.startswith("{")]
    assert steps == [1, 2]
    assert ckpt.latest_step(ck) == 2


def _reference_pth(path):
    """A ``.pth`` of the JAX package's ``TorchCascadedGenerator`` at the
    TINY sizes, every conv redrawn (a nonzero head)."""
    model = JaxTorchGenerator(JaxModelConfig(**dataclasses.asdict(TINY)))
    torch.manual_seed(0)
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            torch.nn.init.normal_(m.weight, std=0.05)
            torch.nn.init.normal_(m.bias, std=0.02)
    torch.save({"state_dict": model.state_dict()}, path)
    return path


def _orbax_export(path):
    """A ``save_params`` export of the JAX package at the TINY sizes."""
    from test_torch_port_models import random_jax_params

    params = random_jax_params(JaxModelConfig(**dataclasses.asdict(TINY)), 3)
    jax_ckpt.save_params(path, params)
    return path, jax_params_to_state_dict(params, TINY)


@pytest.mark.parametrize("kind", ["pth", "orbax"])
def test_stabilize_from_a_reference_or_jax_checkpoint(tmp_path, capsys, monkeypatch, kind):
    """``stabilize --checkpoint`` a ``.pth`` or an Orbax export: exit 0,
    and the frames and fields of the same weights passed directly."""
    if kind == "pth":
        path = _reference_pth(str(tmp_path / "ref.pth"))
        sd = load_torch_checkpoint(path, TINY)
    else:
        path, sd = _orbax_export(str(tmp_path / "export"))
    seen = []
    stabilize_frames = Stabilizer.stabilize_frames

    def recorded(self, frames):
        seen.append(stabilize_frames(self, frames))
        return seen[-1]

    monkeypatch.setattr(Stabilizer, "stabilize_frames", recorded)
    rc = main(["stabilize", "--synthetic", "--frames", "10", "--height", "48",
               "--width", "64", "--batch-windows", "4", "--checkpoint", path, *MODEL, *CPU])
    assert rc == 0 and _last_json(capsys)["frames"] == 10
    _, clip = synthetic_pair_clip(10, 48, 64, seed=0)
    st = Stabilizer(TINY, PipelineConfig(batch_windows=4), state_dict=sd, device="cpu")
    out, flows = stabilize_frames(st, clip)
    assert np.abs(flows).max() > 1e-3  # the weights' warp, not the identity
    np.testing.assert_array_equal(seen[0][0], out)
    np.testing.assert_array_equal(seen[0][1], flows)


def test_export_from_a_reference_pth(tmp_path, capsys):
    path = _reference_pth(str(tmp_path / "ref.pth"))
    out = str(tmp_path / "step.pt2")
    rc = main(["export", "--output", out, "--height", "48", "--width", "64",
               "--batch-windows", "4", "--checkpoint", path, *MODEL, *CPU])
    assert rc == 0 and _last_json(capsys)["artifact"] == out
    st = Stabilizer(TINY, PipelineConfig(batch_windows=4),
                    state_dict=load_torch_checkpoint(path, TINY), device="cpu")
    frames = torch.randint(0, 256, (4 + 2, 48, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    got, want = ExportedStabilizerStep.load(out)(st.model.state_dict(), frames), \
        st._chunk_step(frames)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_train_resume_from_a_jax_orbax_run(tmp_path, capsys):
    """``train --resume`` over a ``--checkpoint-dir`` that holds a JAX run's
    Orbax step: it continues from that step and writes the port's
    format from there."""
    ck = str(tmp_path / "ckpt")
    jstate, _ = jax_create_train_state(JaxModelConfig(**dataclasses.asdict(TINY)),
                                       JaxTrainConfig(batch_size=2), jax.random.PRNGKey(0))
    jax_ckpt.save_state(ck, jstate.replace(step=jnp.asarray(1, jnp.int32)))
    rc = main(["train", "--synthetic", "--batch-size", "2", "--log-every", "1",
               "--checkpoint-every", "1", "--checkpoint-dir", ck, "--steps", "3",
               "--resume", *MODEL, *CPU])
    assert rc == 0
    captured = capsys.readouterr()
    assert json.dumps({"event": "resumed", "step": 1}) in captured.err
    steps = [json.loads(ln)["step"] for ln in captured.out.splitlines() if ln.startswith("{")]
    assert steps == [2, 3]
    assert ckpt.latest_step(ck) == 3
    assert os.path.isfile(os.path.join(ck, "3", ckpt.STATE_FILE))
    assert os.path.isdir(os.path.join(ck, "1", "default"))  # the JAX run's step stays


def test_stabilize_data_parallel_without_a_process_group_is_the_plain_run(tmp_path, capsys):
    """--data-parallel with no launcher: a mesh of one, so mesh=None."""
    runs = {}
    for name, flag in (("plain", []), ("dp", ["--data-parallel"])):
        wf = str(tmp_path / f"{name}.npz")
        assert main(["stabilize", "--synthetic", "--frames", "10", "--height", "48",
                     "--width", "64", "--batch-windows", "4", "--warp-fields", wf,
                     *flag, *MODEL, *CPU]) == 0
        runs[name] = (_last_json(capsys), np.load(wf)["warp_fields"])
    assert runs["dp"][0] == runs["plain"][0]
    np.testing.assert_array_equal(runs["dp"][1], runs["plain"][1])


def test_train_mesh_devices_1_is_the_plain_run(tmp_path, capsys):
    runs = {}
    for name, flag in (("plain", []), ("mesh1", ["--mesh-devices", "1"])):
        ck = str(tmp_path / name)
        assert main(["train", "--synthetic", "--steps", "2", "--batch-size", "2",
                     "--log-every", "1", "--checkpoint-dir", ck, *flag, *MODEL, *CPU]) == 0
        lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
        runs[name] = ([{k: v for k, v in m.items() if k != "sec_per_step"} for m in lines],
                      ckpt.load_generator_state_dict(ck))
    assert runs["mesh1"][0] == runs["plain"][0] and len(runs["plain"][0]) == 2
    for k, v in runs["plain"][1].items():
        assert torch.equal(runs["mesh1"][1][k], v), k


def test_export_writes_a_loadable_step(tmp_path, capsys):
    out = str(tmp_path / "step.pt2")
    rc = main(["export", "--output", out, "--height", "48", "--width", "64",
               "--batch-windows", "4", *MODEL, *CPU])
    assert rc == 0
    assert _last_json(capsys) == {"artifact": out, "frame_hw": [48, 64], "batch_windows": 4}
    step = ExportedStabilizerStep.load(out)
    st = Stabilizer(TINY, PipelineConfig(batch_windows=4), device="cpu")
    frames = torch.randint(0, 256, (4 + 2, 48, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    got, want = step(st.model.state_dict(), frames), st._chunk_step(frames)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_stabilize_video_then_apply_warp_reproduces_it(tmp_path, capsys):
    src = str(tmp_path / "in.avi")
    _, clip = synthetic_pair_clip(9, 48, 64, seed=2)
    video_io.write_video(src, clip, 30.0, codec="MJPG")
    out, wf = str(tmp_path / "out.mp4"), str(tmp_path / "wf.npz")
    rc = main(["stabilize", "--input", src, "--output", out, "--warp-fields", wf,
               "--batch-windows", "4", *MODEL, *CPU])
    assert rc == 0
    assert _last_json(capsys) == {"frames": 9, "fps": 30.0, "output": out, "warp_fields": wf}
    redo = str(tmp_path / "redo.mp4")
    rc = main(["apply-warp", "--input", src, "--warp-fields", wf, "--output", redo,
               "--batch-frames", "4", *MODEL, *CPU])
    assert rc == 0
    assert _last_json(capsys) == {"frames": 9, "output": redo}
    # the same frames, encoded by mp4v twice (the native runtime's OpenCV,
    # then the Python bindings'): equal but for the two encoders' losses
    a = video_io.read_video(redo, dtype=np.uint8)[0].astype(np.int32)
    b = video_io.read_video(out, dtype=np.uint8)[0].astype(np.int32)
    assert a.shape == b.shape == (9, 48, 64, 3)
    assert np.abs(a - b).mean() < 2.0
    short = str(tmp_path / "short.npz")
    np.savez(short, warp_fields=np.zeros((12, 32, 32, 2), np.float32))
    with pytest.raises(SystemExit) as info:
        main(["apply-warp", "--input", src, "--warp-fields", short, "--output", redo,
              *MODEL, *CPU])
    assert info.value.code == 2
    assert "has 9 frames but" in capsys.readouterr().err


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A tiny make-data tree: 2 pairs of 12 frames of 40x56."""
    path = str(tmp_path_factory.mktemp("tree"))
    assert main(["make-data", "--out", path, "--pairs", "2", "--frames", "12",
                 "--height", "40", "--width", "56", "--seed", "1"]) == 0
    return path


@pytest.mark.parametrize("flags", [[], ["--rich", "--texture-detail-px", "4"], ["--curriculum"]],
                         ids=["plain", "rich-texture", "curriculum"])
def test_make_data_matches_reference(tmp_path, capsys, flags):
    size = ["--pairs", "2", "--frames", "8", "--height", "40", "--width", "56", "--seed", "2"]
    ours, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert main(["make-data", "--out", ours, *size, *flags]) == 0
    line = _last_json(capsys)
    assert jax_main(["make-data", "--out", ref, *size, *flags]) == 0
    assert line == {**_last_json(capsys), "root": ours}
    ds = DeepStabDataset(DataConfig(data_root=ours, crop_size=(32, 32)), 3)
    assert len(ds.pairs) == 2
    for sub in ("stable/00.avi", "unstable/01.avi"):
        np.testing.assert_array_equal(video_io.read_video(f"{ours}/{sub}", dtype=np.uint8)[0],
                                      video_io.read_video(f"{ref}/{sub}", dtype=np.uint8)[0])


def test_train_from_data_root(tree, tmp_path, capsys):
    rc = main(["train", "--data-root", tree, "--steps", "2", "--batch-size", "2",
               "--log-every", "1", "--resize-scale", "1.0", "1.2", "--decode-threads", "3",
               "--checkpoint-dir", str(tmp_path / "ckpt"), *MODEL, *CPU])
    assert rc == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [m["step"] for m in lines] == [1, 2]
    assert all(np.isfinite(m["loss_g"]) and np.isfinite(m["loss_d"]) for m in lines)
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 2


def test_train_from_data_root_with_eval_clip(tree, tmp_path, capsys):
    rc = main(["train", "--data-root", tree, "--steps", "2", "--batch-size", "2",
               "--log-every", "1", "--eval-every", "2",
               "--eval-clip", f"{tree}/unstable/01.avi",
               "--checkpoint-dir", str(tmp_path / "ckpt"), *MODEL, *CPU])
    assert rc == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    evals = [m for m in lines if "eval_stability" in m]
    assert [m["step"] for m in evals] == [2]
    assert {"eval_stability", "eval_stability_unstable"} <= set(evals[0])


@pytest.mark.parametrize("flags", [["--eval-every", "2"], ["--eval-clip", "clip.avi"]],
                         ids=["eval-every-alone", "eval-clip-alone"])
def test_eval_flags_come_in_pairs(tree, capsys, flags):
    argv = ["train", "--data-root", tree, "--steps", "1", *flags]
    with pytest.raises(SystemExit) as info:
        main([*argv, *MODEL, *CPU])
    assert info.value.code == 2
    err = capsys.readouterr().err
    assert "DeepStab mode needs BOTH --eval-every and --eval-clip" in err
    with pytest.raises(SystemExit) as info:
        jax_main(argv)
    assert info.value.code == 2 and capsys.readouterr().err == err


def test_eval_prints_strict_json(tmp_path, capsys):
    """A 3-frame clip leaves the jitter unmeasured (NaN) and a clip
    scored against itself has an infinite PSNR: both print as null."""
    stable, unstable = synthetic_pair_clip(3, 96, 128, seed=4)
    a, b = str(tmp_path / "a.avi"), str(tmp_path / "b.avi")
    video_io.write_video(a, unstable, 30.0, codec="FFV1")
    video_io.write_video(b, stable, 30.0, codec="FFV1")
    assert main(["eval", "--input", a, "--original", b, "--ground-truth", a]) == 0
    report = _strict_loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["jitter_rms_px"] is None and report["psnr_db"] is None
    assert report["ssim"] == pytest.approx(1.0)
    assert {"stability_score", "tracked_pair_fraction", "cropping_ratio",
            "distortion_value", "original_stability_score"} <= set(report)


def test_missing_input_output_is_a_usage_error(capsys):
    assert main(["stabilize", *MODEL, *CPU]) == 2
    assert "--input/--output required" in capsys.readouterr().err


def test_commands_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["stabilize", "--synthetic", "--frames", "4", *MODEL])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["export", "--output", "unused.pt2", *MODEL])


@pytest.mark.parametrize("argv, module", [
    (["bench"], "BENCHMARK.json"),
], ids=["bench"])
def test_unported_flags_name_their_roadmap_item(argv, module):
    if argv[0] in ("stabilize", "train"):
        argv = [*argv, *MODEL, *CPU]
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item") as info:
        main(argv)
    assert module in str(info.value)
