"""Command-line interface of the port: the JAX package's ``cli/main.py``
subcommands with the same flags, each printing one JSON line on stdout.

    python -m pwstablenet_tpu_torch.cli stabilize --input shaky.avi --output out.mp4
    python -m pwstablenet_tpu_torch.cli make-data --out DeepStab --pairs 8
    python -m pwstablenet_tpu_torch.cli train --data-root DeepStab --steps 1000
    python -m pwstablenet_tpu_torch.cli train --synthetic --steps 1000
    python -m pwstablenet_tpu_torch.cli stabilize --synthetic --frames 24 --device cpu
    python -m pwstablenet_tpu_torch.cli bench
    torchrun --standalone --nproc_per_node N -m pwstablenet_tpu_torch.cli train --synthetic

Every command that runs a model runs on the card unless ``--device``
names another device (``--device cpu``: the plain CPU path).  Under a
launcher that starts one process per GPU (``torchrun``), ``train`` is
data-parallel over the processes and ``stabilize --data-parallel``
clip-sharded; only rank 0 prints and writes files.  ``--checkpoint``
takes a reference ``.pth``/``.pt`` file, a port checkpoint directory or
the JAX package's Orbax directory (an export or a training run's), and
``train --resume`` continues a JAX run's Orbax ``--checkpoint-dir``.
``bench`` runs the benchmark suite (``pwstablenet_tpu_torch.bench``) on
the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys


def _step_or_best(value: str):
    """--checkpoint-step accepts a step number or the literal 'best'."""
    if value == "best":
        return value
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected a step number or 'best', got {value!r}"
        )


def _add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--device", default=None,
                   help="device to run on (default: the CUDA card; 'cpu' "
                        "runs the plain CPU path)")
    p.add_argument("--temporal-window", type=int, default=None)
    p.add_argument("--temporal-center", type=int, default=None,
                   help="current-frame position in the stack (default: "
                        "centered; temporal_window-1 = causal "
                        "zero-lookahead live mode)")
    p.add_argument("--num-stages", type=int, default=None)
    p.add_argument("--num-levels", type=int, default=None)
    p.add_argument("--base-features", type=int, default=None)
    p.add_argument("--max-features", type=int, default=None)
    p.add_argument("--norm", choices=["batch", "instance", "group", "none"],
                   default=None)
    p.add_argument("--interstage", choices=["features", "warped", "both"],
                   default=None)
    p.add_argument("--decoder-impl", dest="decoder_impl",
                   choices=["deconv", "phase_conv"], default=None,
                   help="decoder 2x upsampler lowering (the port runs a "
                        "transposed conv for either)")
    p.add_argument("--disc-layers", dest="disc_num_layers", type=int,
                   default=None,
                   help="PatchGAN stride-2 layers (default 3 = 70x70 "
                        "receptive field; lower for tiny resolutions)")
    p.add_argument("--model-height", type=int, default=None)
    p.add_argument("--model-width", type=int, default=None,
                   help="working resolution (weights are fully "
                        "convolutional: a 256-trained checkpoint runs "
                        "at any multiple of 2^num_levels)")
    p.add_argument("--use-dropout", action="store_true", default=None,
                   help="decoder dropout (training regularizer; "
                        "inference-time generators are deterministic)")


def _model_cfg(args):
    from pwstablenet_tpu_torch.config import ModelConfig

    cfg = ModelConfig()
    over = {}
    for field in (
        "temporal_window", "temporal_center", "num_stages", "num_levels",
        "base_features", "max_features", "norm", "interstage",
        "decoder_impl", "disc_num_layers", "use_dropout",
    ):
        v = getattr(args, field, None)
        if v is not None:
            over[field] = v
    if args.model_height or args.model_width:
        h = args.model_height or cfg.model_resolution[0]
        w = args.model_width or cfg.model_resolution[1]
        over["model_resolution"] = (h, w)
    return dataclasses.replace(cfg, **over)


def _generator_weights(path: str, cfg, step=None):
    """A checkpoint -> the generator's ``state_dict``: a reference
    ``.pth``/``.pt`` file, a port checkpoint directory (a training run's,
    or an inference export) or the JAX package's Orbax directory (a
    training run's, or a ``save_params`` export)."""
    if path.endswith((".pth", ".pt")):
        from pwstablenet_tpu_torch.interop import load_torch_checkpoint

        return load_torch_checkpoint(path, cfg)
    from pwstablenet_tpu_torch.train import checkpoint as ckpt

    return ckpt.load_generator_state_dict(path, step=step, cfg=cfg)


def cmd_stabilize(args) -> int:
    import numpy as np

    from pwstablenet_tpu_torch.config import PipelineConfig
    from pwstablenet_tpu_torch.parallel import make_mesh, maybe_initialize_distributed
    from pwstablenet_tpu_torch.pipeline import Stabilizer

    model_cfg = _model_cfg(args)
    pipe_cfg = PipelineConfig(
        batch_windows=args.batch_windows,
        border_crop_frac=args.border_crop,
        emit_warp_fields=args.warp_fields is not None,
        warp_field_dtype=args.warp_dtype,
    )
    mesh = None
    if args.data_parallel:
        # clip-sharded inference: temporal windows split over the
        # processes of the launcher's group (batch_windows must divide)
        maybe_initialize_distributed()
        mesh = make_mesh()
        if mesh.size == 1:
            mesh = None
    primary = mesh is None or mesh.rank == 0
    state_dict = None
    if args.checkpoint:
        state_dict = _generator_weights(args.checkpoint, model_cfg, args.checkpoint_step)
    stab = Stabilizer(model_cfg, pipe_cfg, state_dict=state_dict, device=args.device,
                      mesh=mesh)

    if args.synthetic:
        from pwstablenet_tpu_torch.data.synthetic import synthetic_pair_clip

        _, unstable = synthetic_pair_clip(args.frames, args.height, args.width, seed=0)
        out, flows = stab.stabilize_frames(unstable)
        if not primary:
            return 0
        if args.output:
            from pwstablenet_tpu_torch.data import video_io

            video_io.write_video(args.output, out, 30.0)
        if args.warp_fields:
            np.savez_compressed(args.warp_fields, warp_fields=flows)
        print(json.dumps({
            "frames": int(out.shape[0]),
            "shape": list(out.shape),
            "output": args.output,
        }))
        return 0

    if not args.input or not args.output:
        print("--input/--output required (or --synthetic)", file=sys.stderr)
        return 2
    result = stab.stabilize_video(
        args.input, args.output,
        warp_field_path=args.warp_fields,
        max_frames=args.frames if args.frames > 0 else -1,
    )
    if primary:
        print(json.dumps(result))
    return 0


def cmd_train(args) -> int:
    from pwstablenet_tpu_torch.config import DataConfig, MeshConfig, TrainConfig
    from pwstablenet_tpu_torch.parallel import maybe_initialize_distributed, process_info
    from pwstablenet_tpu_torch.train.loop import synthetic_batch_iterator, train

    # data-parallel over the launcher's processes, if there are any
    maybe_initialize_distributed()
    model_cfg = _model_cfg(args)
    train_cfg = TrainConfig(
        batch_size=args.batch_size,
        steps_per_epoch=args.steps,
        num_epochs=1,
        lr_g=args.lr,
        lr_d=args.lr,
        gan_loss=args.gan_loss,
        temporal_mode=args.temporal_mode,
        pixel_loss_mode=args.pixel_loss_mode,
        grad_accum_steps=args.grad_accum,
        checkpoint_dir=args.checkpoint_dir,
        log_every=args.log_every,
        checkpoint_every=args.checkpoint_every,
        scalar_log_path=args.scalar_log or "",
        tb_log_dir=args.tb_log_dir or "",
        ema_decay=args.ema_decay,
        eval_every=args.eval_every,
        debug_nans=args.debug_nans,
        fault_inject_step=args.fault_inject_step,
        seed=args.seed,
    )
    eval_fn = None
    if args.synthetic:
        batches = synthetic_batch_iterator(model_cfg, train_cfg, rich=args.rich)
        if args.eval_every > 0:
            from pwstablenet_tpu_torch.data.synthetic import RICH, synthetic_pair_clip
            from pwstablenet_tpu_torch.eval.hooks import make_clip_eval_hook

            stable, unstable = synthetic_pair_clip(
                24, 96, 128, seed=10_000, **(RICH if args.rich else {})
            )
            eval_fn = make_clip_eval_hook(model_cfg, unstable, stable_clip=stable,
                                          batch_windows=4)
    else:
        if (args.eval_every > 0) != bool(args.eval_clip):
            # one without the other would silently give no periodic eval
            print(
                "pwstablenet train: error: DeepStab mode needs BOTH "
                "--eval-every and --eval-clip for periodic eval "
                "(got only one)",
                file=sys.stderr,
            )
            raise SystemExit(2)
        from pwstablenet_tpu_torch.data.deepstab import DeepStabDataset, batch_iterator

        data_cfg = DataConfig(
            data_root=args.data_root,
            crop_size=model_cfg.model_resolution,
            resize_scale_range=tuple(args.resize_scale),
            num_decode_threads=args.decode_threads,
        )
        ds = DeepStabDataset(data_cfg, model_cfg.temporal_window,
                             temporal_center=model_cfg.temporal_center)
        if args.eval_every > 0:
            import numpy as np

            from pwstablenet_tpu_torch.data.video_io import read_video
            from pwstablenet_tpu_torch.eval.hooks import make_clip_eval_hook

            clip, _ = read_video(args.eval_clip, max_frames=60, dtype=np.uint8)
            eval_fn = make_clip_eval_hook(model_cfg, clip)
        batches = batch_iterator(ds, train_cfg.batch_size, seed=args.seed)
    mesh_cfg = MeshConfig(num_devices=args.mesh_devices) if args.mesh_devices > 0 else None
    try:
        state = train(
            model_cfg, train_cfg, batches, mesh_cfg=mesh_cfg, resume=args.resume,
            max_steps=args.steps, eval_fn=eval_fn, device=args.device,
        )
    finally:
        batches.close()
    if args.export_params and process_info()["process_index"] == 0:
        from pwstablenet_tpu_torch.train import checkpoint as ckpt

        # inference weights (the EMA copy when tracked), which
        # `stabilize --checkpoint <path>` loads
        ckpt.save_generator_state_dict(args.export_params,
                                       state.generator_params().state_dict())
    return 0


def cmd_export(args) -> int:
    """Export the inference chunk step (``torch.export``, a .pt2)."""
    from pwstablenet_tpu_torch.config import PipelineConfig
    from pwstablenet_tpu_torch.export import save_chunk_step
    from pwstablenet_tpu_torch.pipeline import Stabilizer

    model_cfg = _model_cfg(args)
    state_dict = _generator_weights(args.checkpoint, model_cfg) if args.checkpoint else None
    stab = Stabilizer(model_cfg, PipelineConfig(batch_windows=args.batch_windows),
                      state_dict=state_dict, device=args.device)
    path = save_chunk_step(args.output, stab, frame_hw=(args.height, args.width))
    print(json.dumps({
        "artifact": path,
        "frame_hw": [args.height, args.width],
        "batch_windows": args.batch_windows,
    }))
    return 0


def cmd_apply_warp(args) -> int:
    """Re-apply a warp-field archive to the original video: the fields
    are the transformation, so this reproduces ``stabilize``'s output."""
    import numpy as np

    from pwstablenet_tpu_torch.data import video_io
    from pwstablenet_tpu_torch.data.warp_fields import load_warp_fields
    from pwstablenet_tpu_torch.pipeline import apply_warp_fields

    flows = load_warp_fields(args.warp_fields)
    frames, fps = video_io.read_video(args.input, dtype=np.uint8, max_frames=flows.shape[0])
    if frames.shape[0] != flows.shape[0]:
        print(
            f"pwstablenet apply-warp: error: {args.input} has "
            f"{frames.shape[0]} frames but {args.warp_fields} holds "
            f"{flows.shape[0]} fields",
            file=sys.stderr,
        )
        raise SystemExit(2)
    out = apply_warp_fields(frames, flows, _model_cfg(args),
                            batch_frames=args.batch_frames, device=args.device)
    video_io.write_video(args.output, out, fps)
    print(json.dumps({"frames": int(out.shape[0]), "output": args.output}))
    return 0


def _strict(value):
    """NaN and +-inf -> None, through dicts and lists: strict JSON."""
    if isinstance(value, dict):
        return {k: _strict(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_strict(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


def cmd_eval(args) -> int:
    from pwstablenet_tpu_torch.data import video_io
    from pwstablenet_tpu_torch.eval.metrics import fidelity_report, stability_report

    frames, _ = video_io.read_video(args.input)
    original = None
    if args.original:
        original, _ = video_io.read_video(args.original)
    report = stability_report(frames, original)
    if args.ground_truth:
        # PSNR/SSIM against an ALIGNED ground-truth stable clip
        gt, _ = video_io.read_video(args.ground_truth)
        n = min(len(frames), len(gt))
        report.update(fidelity_report(frames[:n], gt[:n]))
    # unmeasured metrics (NaN) and a perfect PSNR (inf) print as null
    print(json.dumps(_strict(report), allow_nan=False))
    return 0


def cmd_make_data(args) -> int:
    """Write a synthetic DeepStab-shaped dataset on disk."""
    from pwstablenet_tpu_torch.data.deepstab import write_synthetic_deepstab

    write_synthetic_deepstab(
        args.out,
        num_pairs=args.pairs,
        frames=args.frames,
        height=args.height,
        width=args.width,
        seed=args.seed,
        rich=args.rich,
        curriculum=args.curriculum,
        texture_detail_px=args.texture_detail_px,
    )
    print(json.dumps({
        "root": args.out, "pairs": args.pairs, "frames": args.frames,
        "height": args.height, "width": args.width,
        "rich": args.rich or args.curriculum,
        "curriculum": args.curriculum,
        "texture_detail_px": args.texture_detail_px,
    }))
    return 0


def cmd_bench(args) -> int:
    from pwstablenet_tpu_torch import bench

    return bench.main()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pwstablenet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("stabilize", help="stabilize a video")
    _add_model_args(s)
    s.add_argument("--input")
    s.add_argument("--output")
    s.add_argument("--checkpoint",
                   help="generator weights: a reference .pth/.pt file, a "
                        "port checkpoint directory (a training run's or an "
                        "--export-params export) or the JAX package's "
                        "Orbax directory (a training run's or a params "
                        "export)")
    s.add_argument("--checkpoint-step", type=_step_or_best, default=None,
                   help="pick this step from a training checkpoint dir "
                        "(default: latest), or 'best' for the "
                        "auto-tracked best-eval export")
    s.add_argument("--warp-fields", help="save warp fields to .npz")
    s.add_argument("--data-parallel", action="store_true",
                   help="clip-sharded inference over the processes of a "
                        "launcher such as torchrun (one per GPU)")
    s.add_argument("--warp-dtype", choices=["float32", "float16"],
                   default="float32",
                   help="dtype warp fields cross device->host in "
                        "(float16 halves the flow D2H bytes)")
    s.add_argument("--batch-windows", type=int, default=8)
    s.add_argument("--border-crop", type=float, default=0.0)
    s.add_argument("--synthetic", action="store_true",
                   help="use a procedural clip instead of --input")
    s.add_argument("--frames", type=int, default=-1)
    s.add_argument("--height", type=int, default=480)
    s.add_argument("--width", type=int, default=832)
    s.set_defaults(fn=cmd_stabilize)

    t = sub.add_parser("train", help="adversarial training")
    _add_model_args(t)
    t.add_argument("--data-root", default="DeepStab",
                   help="DeepStab-shaped tree of <root>/{stable,unstable}/"
                        "*.avi pairs (make-data writes one)")
    t.add_argument("--synthetic", action="store_true",
                   help="train on procedural batches made in memory "
                        "instead of --data-root")
    t.add_argument("--rich", action="store_true",
                   help="full synthetic scene model (perspective shake, "
                        "parallax, occluders, photometric jitter) for "
                        "--synthetic batches and the held-out eval clip")
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--steps", type=int, default=1000)
    t.add_argument("--checkpoint-dir", default="checkpoints")
    t.add_argument("--resume", action="store_true",
                   help="continue from the newest step in --checkpoint-dir "
                        "(the port's, or a JAX run's Orbax steps)")
    t.add_argument("--lr", type=float, default=2e-4)
    t.add_argument("--gan-loss", choices=["lsgan", "vanilla", "hinge"],
                   default="lsgan")
    t.add_argument("--temporal-mode", choices=["raw", "compensated"],
                   default="compensated",
                   help="temporal loss: raw |out_t-out_t+1| or "
                        "GT-motion-compensated |d(out)-d(gt)| (pans free)")
    t.add_argument("--pixel-loss-mode",
                   choices=["l1", "mean_matched", "gradient"],
                   default="l1",
                   help="pixel term: plain L1, brightness-gain-matched "
                        "L1 (exposure-step robust), or finite-difference "
                        "gradient L1")
    t.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batch gradient accumulation steps")
    t.add_argument("--log-every", type=int, default=50)
    t.add_argument("--scalar-log", help="also append JSONL scalars to this file")
    t.add_argument("--tb-log-dir",
                   help="write TensorBoard event files here "
                        "(dependency-free writer)")
    t.add_argument("--eval-every", type=int, default=0,
                   help="stabilize + score a held-out clip every N steps")
    t.add_argument("--eval-clip",
                   help="held-out unstable video for --eval-every "
                        "(DeepStab mode; synthetic mode generates one)")
    t.add_argument("--ema-decay", type=float, default=0.0,
                   help="track an EMA of the generator's weights (0 = "
                        "off); exported and preferred for inference")
    t.add_argument("--export-params",
                   help="after training, save the inference-only "
                        "generator weights (EMA if tracked) to this "
                        "directory")
    t.add_argument("--resize-scale", type=float, nargs=2,
                   default=[1.0, 1.0], metavar=("MIN", "MAX"),
                   help="random scale-jitter range before the crop")
    t.add_argument("--decode-threads", type=int, default=2)
    t.add_argument("--mesh-devices", type=int, default=-1,
                   help="cap the data-parallel mesh size (-1 = all "
                        "processes whose count divides the batch)")
    t.add_argument("--checkpoint-every", type=int, default=500)
    t.add_argument("--debug-nans", action="store_true",
                   help="after every step, check the metrics, G's and D's "
                        "parameters, their Adam moments and the EMA on the "
                        "card, and stop with FloatingPointError at the first "
                        "step that makes a NaN or inf, before it is logged "
                        "or checkpointed (one host sync a step)")
    t.add_argument("--fault-inject-step", type=int, default=-1)
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=cmd_train)

    x = sub.add_parser("export", help="export the inference step (torch.export, .pt2)")
    _add_model_args(x)
    x.add_argument("--output", required=True, help="artifact path")
    x.add_argument("--checkpoint",
                   help="generator weights: a reference .pth/.pt file, a "
                        "port checkpoint directory or the JAX package's "
                        "Orbax directory")
    x.add_argument("--height", type=int, default=720)
    x.add_argument("--width", type=int, default=1280)
    x.add_argument("--batch-windows", type=int, default=8)
    x.set_defaults(fn=cmd_export)

    aw = sub.add_parser(
        "apply-warp",
        help="re-apply exported warp fields (.npz) to the original "
             "video; the fields are the transformation, so this "
             "reproduces the stabilized output",
    )
    _add_model_args(aw)
    aw.add_argument("--input", required=True, help="original unstable video")
    aw.add_argument("--warp-fields", required=True,
                    help=".npz from stabilize --warp-fields")
    aw.add_argument("--output", required=True)
    aw.add_argument("--batch-frames", type=int, default=8)
    aw.set_defaults(fn=cmd_apply_warp)

    b = sub.add_parser("bench", help="run the benchmark suite")
    b.set_defaults(fn=cmd_bench)

    e = sub.add_parser("eval", help="stabilization quality metrics")
    e.add_argument("--input", required=True, help="stabilized video")
    e.add_argument("--original", help="original unstable video")
    e.add_argument("--ground-truth",
                   help="aligned GT stable video (adds PSNR/SSIM)")
    e.set_defaults(fn=cmd_eval)

    d = sub.add_parser(
        "make-data",
        help="write a synthetic DeepStab-shaped dataset "
             "(<out>/{stable,unstable}/*.avi pairs)",
    )
    d.add_argument("--out", required=True)
    d.add_argument("--rich", action="store_true",
                   help="full scene model: perspective shake, parallax "
                        "layers, moving occluders, photometric jitter, "
                        "per-pair motion diversity")
    d.add_argument("--curriculum", action="store_true",
                   help="rich scene model with the curriculum stressor "
                        "ranges (shake to 16 px, pan to 2.5, 1-4 "
                        "occluders, exposure steps to 2.0); train on it "
                        "with --pixel-loss-mode mean_matched, since plain "
                        "l1 on exposure-stepped data distorts the warps")
    d.add_argument("--pairs", type=int, default=4)
    d.add_argument("--frames", type=int, default=60)
    d.add_argument("--height", type=int, default=288)
    d.add_argument("--width", type=int, default=384)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--texture-detail-px", type=float, default=0.0,
                   help="add fine texture octaves down to ~this pixel "
                        "scale at native resolution (0 = off). Needed "
                        "for meaningful clips above ~480p, where the "
                        "base octaves alone leave the world featureless")
    d.set_defaults(fn=cmd_make_data)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
