"""One rank of the port's two-rank ``parallel/`` cases on the CPU (gloo).

    python tests/torch_port_parallel_worker.py RANK WORLD INIT_FILE WORK

``tests/test_torch_port_parallel.py`` starts two of these. Each joins
the process group through ``INIT_FILE`` (a ``file://`` rendezvous, so
parallel test workers cannot collide on a port), reads the inputs the
test wrote to ``WORK/inputs.npz``, runs every case and writes its
results to ``WORK/rank<R>.npz`` and ``WORK/rank<R>.json``.  The
data-parallel train step's case comes last: after its first step it
waits for ``WORK/jax_sync.npz``, the JAX step's whole state (every
parameter of G and D, Adam's moments, the EMA if it is on; see
``tests/test_torch_port_train.py``), which the test writes while the
ranks run the other cases, and loads it, so that both ranks start the
second step from JAX's state.

It imports torch and the port only: no JAX.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from pwstablenet_tpu_torch.config import ModelConfig, PipelineConfig, TrainConfig
from pwstablenet_tpu_torch.data.synthetic import make_train_batch
from pwstablenet_tpu_torch.models.discriminator import PatchDiscriminator
from pwstablenet_tpu_torch.models.features import FeatureExtractor
from pwstablenet_tpu_torch.models.generator import CascadedGenerator
from pwstablenet_tpu_torch.parallel import (
    GradSync,
    data_parallel_step,
    make_mesh,
    maybe_initialize_distributed,
    process_info,
    replicate_tree,
    shard_batch,
    spatial_sharded_warp,
    sync_batch_norm,
)
from pwstablenet_tpu_torch.pipeline import Stabilizer
from pwstablenet_tpu_torch.train.loop import batch_to_device, train
from pwstablenet_tpu_torch.train.state import make_train_state
from pwstablenet_tpu_torch.train.step import make_train_step

CPU = torch.device("cpu")
# tests/test_parallel.py's TINY: the data-parallel train step's model
DP_TINY = dict(
    temporal_window=3, num_levels=3, base_features=8, max_features=16,
    model_resolution=(16, 16), num_stages=2, disc_num_layers=1,
    feat_channels=(8,), compute_dtype="float32",
)
DP_TCFG = dict(batch_size=8, num_epochs=1, steps_per_epoch=4)
DP_SEEDS = (3, 4)
# tests/test_parallel.py's clip-sharded Stabilizer
STAB = dict(
    temporal_window=3, num_levels=4, base_features=8, max_features=16,
    model_resolution=(32, 32), num_stages=2, compute_dtype="float32",
)
STAB_NORMS = ("instance", "batch")
SPATIAL_CASES = ("border", "reflection", "uint8")
CLI_TINY = ["--temporal-window", "3", "--num-levels", "4", "--base-features", "8",
            "--max-features", "16", "--model-height", "32", "--model-width", "32",
            "--disc-layers", "2", "--device", "cpu"]
SYNC_WAIT_S = 240.0


def _state_dict(inputs, prefix):
    return {k[len(prefix):]: torch.from_numpy(v.copy()) for k, v in inputs.items()
            if k.startswith(prefix)}


def _flat(prefix, sd):
    return {prefix + k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _dp_state(inputs, cfg, tcfg):
    g, d, f = CascadedGenerator(cfg), PatchDiscriminator(cfg), FeatureExtractor(cfg)
    g.load_state_dict(_state_dict(inputs, "dp_g."))
    d.load_state_dict(_state_dict(inputs, "dp_d."))
    f.load_state_dict(_state_dict(inputs, "dp_f."))
    return make_train_state(tcfg, g, d, f, torch.Generator().manual_seed(0), CPU)


def _batch(seed, mesh):
    batch = make_train_batch(DP_TCFG["batch_size"], 16, 16, DP_TINY["temporal_window"],
                             seed=seed)
    return batch_to_device(shard_batch(batch, mesh), CPU)


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def case_process_info(out, info, inputs, mesh):
    info["process_info"] = process_info()
    info["initialized_again"] = maybe_initialize_distributed()


def case_refusals(out, info, inputs, mesh):
    """Each refusal, with the message it raised (None if it did not)."""
    img = torch.zeros(1, 64, 8, 3)
    flow = torch.zeros(1, 64, 8, 2)
    attempts = {
        "batch_windows": lambda: Stabilizer(ModelConfig(**STAB), PipelineConfig(batch_windows=3),
                                            device="cpu", mesh=mesh),
        "zeros": lambda: spatial_sharded_warp(img, flow, mesh, halo=8, padding_mode="zeros"),
        "halo": lambda: spatial_sharded_warp(img, flow, mesh, halo=33),
        "rows": lambda: spatial_sharded_warp(img[:, :63], flow[:, :63], mesh, halo=8),
    }
    info["refusals"] = {}
    for name, attempt in attempts.items():
        try:
            attempt()
            info["refusals"][name] = None
        except ValueError as e:
            info["refusals"][name] = str(e)


def case_spatial(out, info, inputs, mesh):
    for name in SPATIAL_CASES:
        img = torch.from_numpy(inputs[f"sp_{name}_img"])
        flow = torch.from_numpy(inputs[f"sp_{name}_flow"])
        mode = "reflection" if name == "reflection" else "border"
        out[f"sp_{name}"] = spatial_sharded_warp(img, flow, mesh, halo=8,
                                                 padding_mode=mode).numpy()


def case_batch_norm(out, info, inputs, mesh):
    """The norm="batch" generator on this rank's rows, with global
    statistics (synced) and with local ones; and the synced gradient of
    sum(flow * cot) (the mean over ranks of each rank's gradient)."""
    cfg = ModelConfig(**{**DP_TINY, "norm": "batch", "num_stages": 1})
    g = CascadedGenerator(cfg)
    g.load_state_dict(_state_dict(inputs, "bn_g."))
    x = shard_batch(torch.from_numpy(inputs["bn_x"]), mesh)
    cot = shard_batch(torch.from_numpy(inputs["bn_cot"]), mesh)
    with torch.no_grad():
        out["bn_local"] = g(x)[0].numpy()
    sync_batch_norm(g, mesh)
    flow = g(x)[0]
    out["bn_sync"] = flow.detach().numpy()
    (flow * cot).sum().backward()
    GradSync(mesh)(g)
    out.update({f"bn_grad.{n}": p.grad.numpy().copy() for n, p in g.named_parameters()})


def case_stabilizer(out, info, inputs, mesh):
    cfg = ModelConfig(**STAB)
    for norm in STAB_NORMS:
        c = dataclasses.replace(cfg, norm=norm)
        stab = Stabilizer(c, PipelineConfig(batch_windows=8),
                          state_dict=_state_dict(inputs, f"stab_{norm}."), device="cpu",
                          mesh=mesh)
        frames, flows = stab.stabilize_frames(inputs["stab_clip"])
        out[f"stab_{norm}_frames"], out[f"stab_{norm}_flows"] = frames, flows


def case_grad_accum(out, info, inputs, mesh):
    """One data-parallel step, plain and with grad_accum_steps=2, from
    one state and batch."""
    cfg = ModelConfig(**DP_TINY)
    for name, accum in (("plain", 1), ("accum", 2)):
        tcfg = TrainConfig(**DP_TCFG, grad_accum_steps=accum)
        state = replicate_tree(_dp_state(inputs, cfg, tcfg), mesh)
        step = data_parallel_step(make_train_step(cfg, tcfg), mesh)
        info[f"accum_{name}_metrics"] = _metrics(step(state, _batch(21, mesh)))
        out.update(_flat(f"accum_{name}_g.", state.g.state_dict()))


def case_outside_the_mesh(out, info, inputs, mesh):
    """A batch of 3 over 2 ranks: the mesh is rank 0 alone; rank 1 takes
    no step and waits at the barrier."""
    cfg = ModelConfig(**DP_TINY)
    tcfg = TrainConfig(**{**DP_TCFG, "batch_size": 3},
                       checkpoint_dir=os.path.join(info["work"], f"outside{mesh.rank}"))
    batches = iter(lambda: make_train_batch(3, 16, 16, 3, seed=0), None)
    logged = []
    state = train(cfg, tcfg, batches, max_steps=1, log_fn=logged.append, device="cpu")
    info["outside"] = {"step": state.step, "logged": len(logged)}


def _cli(argv):
    from pwstablenet_tpu_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return {"rc": rc, "stdout": buf.getvalue().strip().splitlines()}


def case_cli(out, info, inputs, mesh):
    r = mesh.rank
    work = info["work"]
    ckpt = os.path.join(work, f"cli_ckpt{r}")
    info["cli_train"] = _cli(["train", "--synthetic", "--steps", "1", "--batch-size", "2",
                              "--log-every", "1", "--mesh-devices", "2",
                              "--checkpoint-dir", ckpt, *CLI_TINY])
    info["cli_train"]["checkpoints"] = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    fields = os.path.join(work, f"cli_fields{r}.npz")
    info["cli_stabilize"] = _cli(["stabilize", "--synthetic", "--frames", "10", "--height",
                                  "48", "--width", "64", "--batch-windows", "4",
                                  "--data-parallel", "--warp-fields", fields, *CLI_TINY])
    info["cli_stabilize"]["wrote_fields"] = os.path.exists(fields)


def case_dp_train(out, info, inputs, mesh):
    """Two data-parallel steps from the JAX state; after the first, the
    whole state is set to the JAX step's (as
    tests/test_torch_port_train.py does)."""
    cfg, tcfg = ModelConfig(**DP_TINY), TrainConfig(**DP_TCFG)
    state = replicate_tree(_dp_state(inputs, cfg, tcfg), mesh)
    step = data_parallel_step(make_train_step(cfg, tcfg), mesh)
    for n, seed in enumerate(DP_SEEDS, start=1):
        info[f"dp_metrics{n}"] = _metrics(step(state, _batch(seed, mesh)))
        out.update(_flat(f"dp{n}_g.", state.g.state_dict()))
        out.update(_flat(f"dp{n}_d.", state.d.state_dict()))
        out.update(_flat(f"dp{n}_f.", state.feat.state_dict()))
        if n == 1:
            _load_jax_state(state, _wait_for(os.path.join(info["work"], "jax_sync.npz")))
    info["dp_step"] = state.step


@torch.no_grad()
def _load_jax_state(state, sync):
    """Every parameter of G and D and its Adam moments from ``sync``
    (``g.``, ``g_mu.``, ``g_nu.``, ``d.``, ...), and the EMA (``ema.``)
    if the state keeps one."""
    for what, module, opt in (("g", state.g, state.g_opt), ("d", state.d, state.d_opt)):
        for name, p in module.named_parameters():
            p.copy_(torch.from_numpy(sync[f"{what}.{name}"]))
            opt.state[p]["exp_avg"].copy_(torch.from_numpy(sync[f"{what}_mu.{name}"]))
            opt.state[p]["exp_avg_sq"].copy_(torch.from_numpy(sync[f"{what}_nu.{name}"]))
    if state.g_ema is not None:
        state.g_ema.load_state_dict(_state_dict(sync, "ema."))


def _wait_for(path):
    deadline = time.monotonic() + SYNC_WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {SYNC_WAIT_S} s")
        time.sleep(0.05)
    return dict(np.load(path))


CASES = (case_process_info, case_refusals, case_spatial, case_batch_norm,
         case_stabilizer, case_grad_accum, case_outside_the_mesh, case_cli, case_dp_train)


def main(rank, world, init_file, work):
    torch.set_num_threads(1)
    maybe_initialize_distributed(f"file://{init_file}", world_size=world, rank=rank,
                                 backend="gloo", timeout=120)
    inputs = dict(np.load(os.path.join(work, "inputs.npz")))
    mesh = make_mesh()
    out, info = {}, {"work": work, "seconds": {}}
    try:
        for case in CASES:
            t0 = time.perf_counter()
            case(out, info, inputs, mesh)
            info["seconds"][case.__name__] = time.perf_counter() - t0
    except Exception:
        info["error"] = traceback.format_exc()
        raise
    finally:
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
