"""The port's ``parallel/`` against the JAX package's, on the CPU.

One module-scoped fixture starts two gloo ranks
(``tests/torch_port_parallel_worker.py``, a ``file://`` rendezvous) that
run every two-rank case once; meanwhile this process computes the JAX
side on a 2-device mesh of the 8-device CPU platform that the test
session provides, so the JAX mesh has the port's world size.  Weights
cross with ``interop.from_jax``.  Each case is its own test:

- the data-parallel train step, two steps, against the JAX
  ``data_parallel_step``, at ``tests/test_torch_port_train.py``'s
  tolerances, with the whole state (parameters, Adam's moments, the EMA
  if on) set to the JAX step's after the first step, so that both ranks
  start the second from JAX's state (the ranks' steps do not run
  through that file's ``Kinks``: they run in subprocesses without JAX);
- ``grad_accum_steps=2`` under data parallelism against the plain
  data-parallel step (micro-batches inside each rank's shard), at the
  reference's tolerances (``tests/test_parallel.py``);
- a ``norm="batch"`` generator on a batch of wildly differing samples
  split over the ranks against the JAX generator unsharded: global
  statistics pass, local ones must fail; and its synced gradient
  against the port's unsharded gradient;
- the clip-sharded ``Stabilizer`` (instance and batch norm) against the
  JAX ``Stabilizer(mesh=...)``;
- ``spatial_sharded_warp`` (border, reflection, uint8; halo 8) against
  the unsharded JAX oracle;
- the refusals, ``process_info``, a rank left out of the mesh, and the
  CLI under two ranks (only rank 0 prints and writes).

Every wait is bounded: the rendezvous and each collective time out
after 120 s and the fixture kills the ranks after ``RANKS_TIMEOUT_S``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pwstablenet_tpu import pipeline as jax_pipeline
from pwstablenet_tpu.config import MeshConfig as JaxMeshConfig
from pwstablenet_tpu.config import ModelConfig as JaxModelConfig
from pwstablenet_tpu.config import PipelineConfig as JaxPipelineConfig
from pwstablenet_tpu.config import TrainConfig as JaxTrainConfig
from pwstablenet_tpu.data.synthetic import synthetic_pair_clip
from pwstablenet_tpu.models import CascadedGenerator as JaxGenerator
from pwstablenet_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from pwstablenet_tpu.ops.warp import flow_to_grid as jax_flow_to_grid
from pwstablenet_tpu.parallel import data_parallel_step as jax_data_parallel_step
from pwstablenet_tpu.parallel import make_mesh as jax_make_mesh
from pwstablenet_tpu.parallel import replicate_tree as jax_replicate_tree
from pwstablenet_tpu.parallel import shard_batch as jax_shard_batch
from pwstablenet_tpu.train import create_train_state as jax_create_train_state
from pwstablenet_tpu.train import make_train_step as jax_make_train_step

from pwstablenet_tpu_torch.cli import main as cli_main
from pwstablenet_tpu_torch.config import ModelConfig, TrainConfig
from pwstablenet_tpu_torch.data.synthetic import make_train_batch
from pwstablenet_tpu_torch.interop.from_jax import jax_params_to_state_dict, tree_to_state_dict
from pwstablenet_tpu_torch.models.discriminator import PatchDiscriminator
from pwstablenet_tpu_torch.models.features import FeatureExtractor
from pwstablenet_tpu_torch.models.generator import CascadedGenerator
from pwstablenet_tpu_torch.parallel import maybe_initialize_distributed, process_info

import torch_port_parallel_worker as W
from test_torch_port_pipeline import _assert_close, _random_params
from test_torch_port_train import _assert_params_close, _redraw_heads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_parallel_worker.py")
WORLD = 2
RANKS_TIMEOUT_S = 240.0


def _jax_mesh():
    return jax_make_mesh(JaxMeshConfig(num_devices=WORLD))


def _flat(prefix, sd):
    return {prefix + k: v.numpy() for k, v in sd.items()}


def _inputs():
    """Everything the ranks read, and the JAX objects the references
    need."""
    inputs, jx = {}, {}
    # the data-parallel train step: the JAX state, warp heads redrawn
    jcfg, jtcfg = JaxModelConfig(**W.DP_TINY), JaxTrainConfig(**W.DP_TCFG)
    jstate, models = jax_create_train_state(jcfg, jtcfg, jax.random.PRNGKey(0))
    g_params = _redraw_heads(jstate.g_params, seed=7)
    jstate = jstate.replace(g_params=jax.tree_util.tree_map(jnp.asarray, g_params))
    cfg = ModelConfig(**W.DP_TINY)
    inputs.update(_flat("dp_g.", jax_params_to_state_dict(g_params, cfg)))
    inputs.update(_flat("dp_d.", tree_to_state_dict(jax.device_get(jstate.d_params))))
    inputs.update(_flat("dp_f.", tree_to_state_dict(jax.device_get(jstate.feat_params))))
    jx["dp"] = (jcfg, jtcfg, jstate, models)

    # the norm="batch" generator of tests/test_parallel.py, head redrawn
    bcfg = dataclasses.replace(jcfg, norm="batch", num_stages=1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16, 16, bcfg.stack_channels)).astype(np.float32)
    x += np.arange(8, dtype=np.float32)[:, None, None, None] * 2.0
    x *= (1.0 + np.arange(8, dtype=np.float32) / 4.0)[:, None, None, None]
    params = jax.tree_util.tree_map(
        np.asarray, JaxGenerator(bcfg).init(jax.random.PRNGKey(0), jnp.asarray(x)))
    head = params["params"]["stage0"]["head"]
    head["kernel"] = (rng.standard_normal(head["kernel"].shape) * 0.05).astype(np.float32)
    inputs.update(_flat("bn_g.", jax_params_to_state_dict(
        params, ModelConfig(**{**W.DP_TINY, "norm": "batch", "num_stages": 1}))))
    inputs["bn_x"] = x
    inputs["bn_cot"] = rng.standard_normal((8, 16, 16, 2)).astype(np.float32)
    jx["bn"] = (bcfg, params)

    # the clip-sharded Stabilizer, random weights, each norm
    _, clip = synthetic_pair_clip(16, 48, 64, seed=11)
    inputs["stab_clip"] = clip
    for norm in W.STAB_NORMS:
        scfg = JaxModelConfig(**{**W.STAB, "norm": norm})
        sparams = _random_params(scfg, seed=3)
        inputs.update(_flat(f"stab_{norm}.", jax_params_to_state_dict(
            sparams, ModelConfig(**{**W.STAB, "norm": norm}))))
        jx[f"stab_{norm}"] = (scfg, sparams)

    # the row-sharded warp: smooth flows, as tests/test_parallel.py makes them
    for name, seed, mag in (("border", 0, 0.25), ("reflection", 3, 0.2), ("uint8", 9, 0.2)):
        r = np.random.default_rng(seed)
        b = 1 if name == "uint8" else 2
        if name == "uint8":
            img = r.integers(0, 256, (b, 64, 128, 3), np.uint8)
        else:
            img = r.random((b, 64, 128, 3), np.float32)
        lf = (r.random((b, 4, 4, 2), np.float32) - 0.5) * mag
        flow = jax.image.resize(jnp.asarray(lf), (b, 64, 128, 2), "bilinear")
        inputs[f"sp_{name}_img"], inputs[f"sp_{name}_flow"] = img, np.asarray(flow)
    return inputs, jx


def _jax_dp_steps(jx, work):
    """Two JAX data-parallel steps on the ranks' batches; after the first,
    its whole state (every parameter of G and D, Adam's ``mu`` and
    ``nu``, the EMA if it is on) goes to ``work/jax_sync.npz``, from
    which both ranks start their second step."""
    jcfg, jtcfg, jstate, (gen, disc, feat) = jx
    mesh = _jax_mesh()
    step = jax_data_parallel_step(jax_make_train_step(jcfg, jtcfg, gen, disc, feat), mesh)
    state = jax_replicate_tree(jax.tree_util.tree_map(np.asarray, jstate), mesh)
    out = []
    for n, seed in enumerate(W.DP_SEEDS, start=1):
        batch = make_train_batch(W.DP_TCFG["batch_size"], 16, 16, W.DP_TINY["temporal_window"],
                                 seed=seed)
        state, metrics = step(state, jax_shard_batch(batch, mesh))
        host = jax.device_get(state)
        out.append(({k: float(v) for k, v in metrics.items()}, host))
        if n == 1:
            sync = {}
            for what, params, opt in (("g", host.g_params, host.g_opt),
                                      ("d", host.d_params, host.d_opt)):
                for part, tree in (("", params), ("_mu", opt[0].mu), ("_nu", opt[0].nu)):
                    sync.update(_flat(f"{what}{part}.", tree_to_state_dict(tree)))
            if host.g_ema is not None:
                sync.update(_flat("ema.", tree_to_state_dict(host.g_ema)))
            tmp = os.path.join(work, "jax_sync.tmp.npz")
            np.savez(tmp, **sync)
            os.replace(tmp, os.path.join(work, "jax_sync.npz"))
    return out


def _references(jx, inputs):
    ref = {}
    bcfg, bparams = jx["bn"]
    ref["bn"] = np.asarray(jax.jit(JaxGenerator(bcfg).apply)(bparams, inputs["bn_x"])[0])
    # the port's unsharded gradient of sum(flow * cot)
    g = CascadedGenerator(ModelConfig(**{**W.DP_TINY, "norm": "batch", "num_stages": 1}))
    g.load_state_dict({k[5:]: torch.from_numpy(v) for k, v in inputs.items()
                       if k.startswith("bn_g.")})
    (g(torch.from_numpy(inputs["bn_x"]))[0] * torch.from_numpy(inputs["bn_cot"])).sum().backward()
    ref["bn_grad"] = {n: p.grad.numpy() for n, p in g.named_parameters()}
    for norm in W.STAB_NORMS:
        scfg, sparams = jx[f"stab_{norm}"]
        stab = jax_pipeline.Stabilizer(scfg, JaxPipelineConfig(batch_windows=8), params=sparams,
                                       mesh=_jax_mesh())
        ref[f"stab_{norm}"] = stab.stabilize_frames(inputs["stab_clip"])
    for name in W.SPATIAL_CASES:
        img = jnp.asarray(inputs[f"sp_{name}_img"])
        grid = jax_flow_to_grid(jnp.asarray(inputs[f"sp_{name}_flow"]))
        if name == "uint8":
            unit = jax_grid_sample(img.astype(jnp.float32) / 127.5 - 1.0, grid,
                                   padding_mode="border")
            ref["sp_uint8"] = np.clip((np.asarray(unit) + 1.0) * 127.5, 0, 255).round()
        else:
            mode = "reflection" if name == "reflection" else "border"
            ref[f"sp_{name}"] = np.asarray(jax_grid_sample(img, grid, padding_mode=mode))
    return ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("parallel"))
    inputs, jx = _inputs()
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), os.path.join(work, "rendezvous"), work],
        env=env, cwd=work, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
    t0 = time.monotonic()
    try:
        jax_dp = _jax_dp_steps(jx["dp"], work)
        ref = _references(jx, inputs)
        for p in procs:
            p.wait(timeout=max(RANKS_TIMEOUT_S - (time.monotonic() - t0), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    results = []
    for r, p in enumerate(procs):
        with open(os.path.join(work, f"rank{r}.log")) as f:
            log = f.read()
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
        with open(os.path.join(work, f"rank{r}.json")) as f:
            info = json.load(f)
        results.append((dict(np.load(os.path.join(work, f"rank{r}.npz"))), info))
    return {"ranks": results, "jax_dp": jax_dp, "ref": ref, "work": work,
            "seconds": time.monotonic() - t0}


def _both(ranks, key):
    """Rank 0's and rank 1's array ``key``."""
    return [out[key] for out, _ in ranks["ranks"]]


def _module(cls, cfg, out, prefix):
    m = cls(cfg)
    m.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in out.items()
                       if k.startswith(prefix)})
    return m


def test_dp_train_step_matches_jax(ranks):
    cfg, lr = ModelConfig(**W.DP_TINY), JaxTrainConfig(**W.DP_TCFG).lr_g
    (out0, info0), (out1, _) = ranks["ranks"]
    for n, (jm, jstate) in enumerate(ranks["jax_dp"], start=1):
        m = info0[f"dp_metrics{n}"]
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=f"step {n} {k}")
        for cls, what, jparams, step_lr in ((CascadedGenerator, "g", jstate.g_params, lr),
                                            (PatchDiscriminator, "d", jstate.d_params, lr),
                                            (FeatureExtractor, "f", jstate.feat_params, 0.0)):
            prefix = f"dp{n}_{what}."
            _assert_params_close(_module(cls, cfg, out0, prefix), jparams, step_lr, n,
                                 f"step {n} {what}")
            # the replicas stay equal
            for k, v in out0.items():
                if k.startswith(prefix):
                    np.testing.assert_array_equal(out1[k], v, err_msg=k)
    assert info0["dp_step"] == 2


def test_grad_accum_under_data_parallel_matches(ranks):
    lr = TrainConfig(**W.DP_TCFG).lr_g
    for out, info in ranks["ranks"]:
        m1, m2 = info["accum_plain_metrics"], info["accum_accum_metrics"]
        np.testing.assert_allclose(m1["loss_d"], m2["loss_d"], rtol=1e-4)
        np.testing.assert_allclose(m1["loss_g"], m2["loss_g"], rtol=1e-3)
        names = [k[len("accum_plain_g."):] for k in out if k.startswith("accum_plain_g.")]
        assert names
        for k in names:
            np.testing.assert_allclose(out["accum_plain_g." + k], out["accum_accum_g." + k],
                                       rtol=1e-3, atol=2.5 * lr, err_msg=k)


def test_batch_norm_uses_global_statistics(ranks):
    ref = ranks["ref"]["bn"]
    assert np.abs(ref).max() > 1e-4  # a nontrivial output
    synced = np.concatenate(_both(ranks, "bn_sync"))
    np.testing.assert_allclose(synced, ref, rtol=1e-4, atol=1e-5)
    # the mutation: each rank's own statistics fail the same check
    local = np.concatenate(_both(ranks, "bn_local"))
    assert not np.allclose(local, ref, rtol=1e-4, atol=1e-5)


def test_batch_norm_sync_gradient_is_the_global_batch_gradient(ranks):
    ref = ranks["ref"]["bn_grad"]
    # rounding scales with the largest gradient (the biases that feed a
    # norm have a gradient that is zero but for rounding)
    atol = 1e-5 * max(np.abs(g).max() for g in ref.values())
    for out, _ in ranks["ranks"]:
        for name, g in ref.items():
            # each rank holds the mean of the ranks' gradients
            np.testing.assert_allclose(out["bn_grad." + name] * WORLD, g,
                                       rtol=1e-4, atol=atol, err_msg=name)


@pytest.mark.parametrize("norm", W.STAB_NORMS)
def test_clip_sharded_stabilizer_matches_jax(ranks, norm):
    ref_out, ref_flows = ranks["ref"][f"stab_{norm}"]
    for out, _ in ranks["ranks"]:  # every rank returns the whole clip
        _assert_close(out[f"stab_{norm}_frames"], out[f"stab_{norm}_flows"], ref_out, ref_flows)


@pytest.mark.parametrize("name", W.SPATIAL_CASES)
def test_spatial_sharded_warp_matches_unsharded(ranks, name):
    bands = _both(ranks, f"sp_{name}")
    assert all(b.shape[1] == 32 for b in bands)  # each rank returns its band
    out, ref = np.concatenate(bands, axis=1), ranks["ref"][f"sp_{name}"]
    if name == "uint8":
        assert out.dtype == np.uint8
        assert np.abs(out.astype(np.int16) - ref).max() <= 1
    else:
        np.testing.assert_allclose(out, ref, atol=5e-5)


@pytest.mark.parametrize("case, match", [
    ("batch_windows", "divisible"), ("zeros", "zeros"), ("halo", "halo"), ("rows", "divide"),
])
def test_refusals(ranks, case, match):
    for _, info in ranks["ranks"]:
        assert info["refusals"][case] is not None and match in info["refusals"][case]


def test_process_info_under_two_ranks(ranks):
    for r, (_, info) in enumerate(ranks["ranks"]):
        assert info["process_info"] == {"process_index": r, "process_count": WORLD,
                                        "local_devices": 1, "global_devices": WORLD}
        assert info["initialized_again"] is True


def test_single_process_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize_distributed() is False
    monkeypatch.setenv("RANK", "0")  # an environment with no usable rendezvous
    assert maybe_initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert process_info() == {"process_index": 0, "process_count": 1,
                              "local_devices": 1, "global_devices": 1}


def test_ranks_outside_the_mesh_take_no_step(ranks):
    (_, info0), (_, info1) = ranks["ranks"]
    assert info0["outside"] == {"step": 1, "logged": 1}
    assert info1["outside"] == {"step": 0, "logged": 0}


def test_cli_train_two_ranks_only_rank_0_prints_and_checkpoints(ranks):
    (_, info0), (_, info1) = ranks["ranks"]
    t0, t1 = info0["cli_train"], info1["cli_train"]
    assert t0["rc"] == t1["rc"] == 0
    (line,) = t0["stdout"]
    assert json.loads(line)["step"] == 1
    assert t1["stdout"] == []
    assert t0["checkpoints"] == ["1"] and t1["checkpoints"] == []


def test_cli_stabilize_data_parallel_two_ranks(ranks, tmp_path, capsys):
    (_, info0), (_, info1) = ranks["ranks"]
    s0, s1 = info0["cli_stabilize"], info1["cli_stabilize"]
    assert s0["rc"] == s1["rc"] == 0
    assert json.loads(s0["stdout"][-1])["frames"] == 10 and s1["stdout"] == []
    assert s0["wrote_fields"] and not s1["wrote_fields"]
    # rank 0's fields equal a single-process run's
    plain = str(tmp_path / "plain.npz")
    assert cli_main(["stabilize", "--synthetic", "--frames", "10", "--height", "48", "--width",
                     "64", "--batch-windows", "4", "--warp-fields", plain, *W.CLI_TINY]) == 0
    capsys.readouterr()
    np.testing.assert_allclose(np.load(os.path.join(ranks["work"], "cli_fields0.npz"))
                               ["warp_fields"], np.load(plain)["warp_fields"], atol=1e-6)


def test_dropout_seed_folds_the_rank():
    """Ranks draw distinct dropout masks while their generators stay
    equal (a known difference: the reference draws one mask over the
    global batch)."""
    from pwstablenet_tpu_torch.train.step import _dropout_seed

    states = [SimpleNamespace(rng=torch.Generator().manual_seed(5)) for _ in range(WORLD)]
    seeds = [_dropout_seed(s, rank) for rank, s in enumerate(states)]
    assert seeds[1] == seeds[0] + 1
    assert torch.equal(states[0].rng.get_state(), states[1].rng.get_state())
    assert _dropout_seed(SimpleNamespace(rng=torch.Generator().manual_seed(5))) == seeds[0]
