"""The port's DeepStab loader (``data.deepstab``) against the JAX
package's on the CPU: the same trees and seeds give bitwise-equal
files, samples and batches (uint8, the same numpy draws and host ops);
plus the port's counterparts of ``tests/test_data.py``'s loader cases
and a short ``train()`` from a tree on disk."""

import dataclasses
import threading

import numpy as np
import pytest

from pwstablenet_tpu.config import DataConfig as JaxDataConfig
from pwstablenet_tpu.data import deepstab as jax_deepstab

from pwstablenet_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from pwstablenet_tpu_torch.data import deepstab, video_io
from pwstablenet_tpu_torch.data.synthetic import synthetic_pair_clip
from pwstablenet_tpu_torch.train.loop import train


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tree written by the JAX package: 2 pairs of 24 frames of 96x128."""
    path = str(tmp_path_factory.mktemp("deepstab"))
    jax_deepstab.write_synthetic_deepstab(path, num_pairs=2, frames=24, height=96, width=128)
    return path


def _decode_tree(path):
    return {
        f"{sub}/{i:02d}": video_io.read_video(f"{path}/{sub}/{i:02d}.avi", dtype=np.uint8)[0]
        for sub in ("stable", "unstable") for i in range(2)
    }


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b) == ["stable", "stacks"]
    for k in a:
        assert a[k].dtype == b[k].dtype == np.uint8 and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


def test_data_config_matches_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(DataConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxDataConfig)]
    assert ours == ref
    assert DataConfig().crop_size == (256, 256) and DataConfig().num_decode_threads == 2


@pytest.mark.parametrize("kwargs", [
    {},
    {"rich": True},
    {"curriculum": True, "shake_px": 5.0},
    {"texture_detail_px": 4.0},
], ids=["plain", "rich", "curriculum-user-key", "texture-detail"])
def test_write_synthetic_deepstab_matches_reference(tmp_path, kwargs):
    ours, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    deepstab.write_synthetic_deepstab(ours, num_pairs=2, frames=6, height=48, width=64,
                                      seed=3, **kwargs)
    jax_deepstab.write_synthetic_deepstab(ref, num_pairs=2, frames=6, height=48, width=64,
                                          seed=3, **kwargs)
    a, b = _decode_tree(ours), _decode_tree(ref)
    for k in a:
        assert a[k].shape == (6, 48, 64, 3)
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("window, data_over", [
    (3, {}),
    (3, {"random_flip": False}),
    (3, {"resize_scale_range": (1.0, 1.25)}),
    (3, {"resize_scale_range": (0.6, 1.0)}),
    (5, {"frame_stride": 2}),
    (5, {"temporal_center": 4}),
    (5, {"temporal_center": 4, "resize_scale_range": (0.6, 1.0), "random_flip": False}),
    (3, {"crop_size": (48, 112), "resize_scale_range": (0.6, 1.0)}),
], ids=["flip", "no-flip", "upscale", "downscale", "stride-2", "causal", "causal-down-no-flip",
        "wide-crop-down"])
def test_sample_matches_reference(root, window, data_over):
    """Two samples in a row from each seed's generator, so a draw too
    many or too few in one sample shows in the next.  The wide crop
    makes the width bound the scale's lower clamp."""
    data_over = {"crop_size": (64, 64), **data_over}
    center = data_over.pop("temporal_center", None)
    ours = deepstab.DeepStabDataset(DataConfig(data_root=root, **data_over), window,
                                    temporal_center=center)
    ref = jax_deepstab.DeepStabDataset(JaxDataConfig(data_root=root, **data_over), window,
                                       temporal_center=center)
    ch, cw = data_over["crop_size"]
    for seed in range(4):
        rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(2):
            a, b = ours.sample(rng_a), ref.sample(rng_b)
            assert a["stacks"].shape == (2, ch, cw, 3 * window)
            _assert_batches_equal(a, b)


@pytest.mark.parametrize("threads", [1, 3])
def test_batch_iterator_matches_reference_and_closes(root, threads):
    def data(cls):
        return cls(data_root=root, crop_size=(64, 64), num_decode_threads=threads,
                   resize_scale_range=(1.0, 1.25))

    ref_it = jax_deepstab.batch_iterator(
        jax_deepstab.DeepStabDataset(data(JaxDataConfig), 3), batch_size=3, seed=7)
    ref = [next(ref_it) for _ in range(3)]
    before = set(threading.enumerate())
    it = deepstab.batch_iterator(deepstab.DeepStabDataset(data(DataConfig), 3),
                                 batch_size=3, seed=7)
    for want in ref:
        got = next(it)
        assert got["stacks"].shape == (3, 2, 64, 64, 9)
        _assert_batches_equal(got, want)
    started = [t for t in threading.enumerate() if t not in before]
    assert started  # the prefetch thread (and the decode pool)
    it.close()
    assert not [t.name for t in started if t.is_alive()]
    with pytest.raises(StopIteration):  # nothing is queued after close
        while True:
            next(it)


def test_dataset_sample_shapes(root):
    ds = deepstab.DeepStabDataset(DataConfig(data_root=root, crop_size=(64, 64)), 3)
    s = ds.sample(np.random.default_rng(0))
    assert s["stacks"].shape == (2, 64, 64, 9) and s["stable"].shape == (2, 64, 64, 3)
    assert s["stacks"].dtype == s["stable"].dtype == np.uint8


def test_dataset_temporal_consistency(root):
    """The two time steps share video and crop: the second stack's centre
    frame is the first stack's next frame."""
    cfg = DataConfig(data_root=root, crop_size=(64, 64), random_flip=False)
    s = deepstab.DeepStabDataset(cfg, 3).sample(np.random.default_rng(1))
    np.testing.assert_array_equal(s["stacks"][1][..., 3:6], s["stacks"][0][..., 6:9])


def test_batch_iterator_shapes(root):
    ds = deepstab.DeepStabDataset(DataConfig(data_root=root, crop_size=(64, 64)), 3)
    it = deepstab.batch_iterator(ds, batch_size=3, seed=0)
    b = next(it)
    it.close()
    assert b["stacks"].shape == (3, 2, 64, 64, 9) and b["stable"].shape == (3, 2, 64, 64, 3)


def test_too_short_video_raises(tmp_path):
    path = str(tmp_path / "short")
    deepstab.write_synthetic_deepstab(path, num_pairs=1, frames=4, height=96, width=128)
    with pytest.raises(ValueError, match="temporal_window"):
        deepstab.DeepStabDataset(DataConfig(data_root=path, crop_size=(64, 64)), 7)


def test_too_short_pair_skipped_with_warning(tmp_path, capsys):
    path = str(tmp_path / "mixed")
    deepstab.write_synthetic_deepstab(path, num_pairs=2, frames=20, height=96, width=128)
    s, u = synthetic_pair_clip(4, 96, 128, seed=9)
    video_io.write_video(f"{path}/stable/01.avi", s, 30.0, "MJPG")
    video_io.write_video(f"{path}/unstable/01.avi", u, 30.0, "MJPG")
    ds = deepstab.DeepStabDataset(DataConfig(data_root=path, crop_size=(64, 64)), 7)
    assert len(ds.pairs) == 1
    err = capsys.readouterr().err
    assert "skipping video pair '01.avi': only 4 frames" in err
    ref = jax_deepstab.DeepStabDataset(JaxDataConfig(data_root=path, crop_size=(64, 64)), 7)
    assert capsys.readouterr().err == err and ref.pairs == ds.pairs
    for seed in range(4):  # only the long pair is ever drawn
        assert ds.sample(np.random.default_rng(seed))["stacks"].shape == (2, 64, 64, 21)


def test_missing_root_raises():
    with pytest.raises(FileNotFoundError):
        deepstab.DeepStabDataset(DataConfig(data_root="/nonexistent"), 3)


def test_train_from_a_tree_on_disk(tmp_path):
    """``train()`` on the CPU, fed by ``batch_iterator`` over a tree that
    ``write_synthetic_deepstab`` wrote, at a tiny model."""
    path = str(tmp_path / "tree")
    deepstab.write_synthetic_deepstab(path, num_pairs=2, frames=10, height=40, width=56)
    cfg = ModelConfig(temporal_window=3, num_levels=4, base_features=8, max_features=16,
                      model_resolution=(32, 32), disc_num_layers=2, feat_channels=(8, 16),
                      compute_dtype="float32")
    tcfg = TrainConfig(batch_size=2, log_every=1, checkpoint_dir=str(tmp_path / "ckpt"))
    ds = deepstab.DeepStabDataset(
        DataConfig(data_root=path, crop_size=cfg.model_resolution,
                   resize_scale_range=(1.0, 1.25)), cfg.temporal_window)
    it = deepstab.batch_iterator(ds, tcfg.batch_size, seed=0)
    logged = []
    try:
        state = train(cfg, tcfg, it, max_steps=2, log_fn=logged.append, device="cpu")
    finally:
        it.close()
    assert state.step == 2 and [m["step"] for m in logged] == [1, 2]
    assert all(np.isfinite(v) for m in logged for v in m.values())
