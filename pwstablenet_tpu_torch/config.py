"""Typed configuration.

A copy of the JAX package's ``ModelConfig``, ``TrainConfig``,
``DataConfig``, ``MeshConfig`` and ``PipelineConfig`` (same fields,
defaults and validation), kept here so the port depends on nothing of
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Cascaded generator architecture.

    The generator consumes a temporal stack of ``temporal_window`` RGB
    frames (channels-concatenated) and emits one 2-channel per-pixel
    displacement field per cascade stage.
    """

    # --- temporal context ---
    temporal_window: int = 7          # frames per stack (center + neighbors)
    in_channels: int = 3              # per-frame channels (RGB)
    # Position of the CURRENT frame inside the stack. None = centered
    # (temporal_window // 2).  temporal_window - 1 = fully CAUSAL: all
    # context is past frames, so streaming inference needs no lookahead.
    temporal_center: "int | None" = None

    # --- stage UNet (pix2pix-style) ---
    num_levels: int = 8               # stride-2 down/up levels; 256x256 -> 1x1
    base_features: int = 64
    max_features: int = 512
    norm: str = "instance"            # batch | instance | group | none
    leaky_slope: float = 0.2
    dropout_rate: float = 0.5         # on the 3 innermost decoder levels
    use_dropout: bool = False

    # --- cascade ---
    num_stages: int = 2
    interstage: str = "both"          # features | warped | both

    # Decoder 2x-upsampler lowering in the JAX package.  Both values
    # share one parameter tree and one operator; the port runs
    # ``nn.ConvTranspose2d`` for either.
    decoder_impl: str = "deconv"      # deconv | phase_conv

    # --- warp-map head ---
    # Output is a displacement field in normalized grid units ([-1, 1]
    # spans the frame; see ops/warp.py).  The final conv is
    # zero-initialized so an untrained model is the identity warp.
    flow_scale: float = 1.0
    # The model always runs at this resolution; warp fields are
    # bilinearly upsampled to the frame resolution before application.
    model_resolution: Tuple[int, int] = (256, 256)  # (H, W)

    # --- grid-sample semantics ---
    align_corners: bool = True
    padding_mode: str = "border"      # zeros | border | reflection

    # --- PatchGAN discriminator (training slice) ---
    disc_base_features: int = 64
    disc_num_layers: int = 3
    disc_norm: str = "instance"

    # --- perceptual feature extractor (training slice) ---
    feat_channels: Tuple[int, ...] = (32, 64, 128)

    # --- numerics ---
    compute_dtype: str = "bfloat16"   # activations inside the network
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.temporal_window % 2 == 0 or self.temporal_window < 1:
            raise ValueError(
                f"temporal_window must be odd and >= 1, got "
                f"{self.temporal_window} (center frame + symmetric "
                "neighbors)"
            )
        if self.temporal_center is not None and not (
            0 <= self.temporal_center < self.temporal_window
        ):
            raise ValueError(
                f"temporal_center must be in [0, {self.temporal_window}) "
                f"or None, got {self.temporal_center}"
            )
        if self.decoder_impl not in ("deconv", "phase_conv"):
            raise ValueError(
                f"unknown decoder_impl {self.decoder_impl!r} "
                "(deconv | phase_conv)"
            )
        h, w = self.model_resolution
        if h % (2**self.num_levels) or w % (2**self.num_levels):
            raise ValueError(
                f"model_resolution {self.model_resolution} must be "
                f"divisible by 2^num_levels ({2**self.num_levels})"
            )

    @property
    def stack_channels(self) -> int:
        return self.temporal_window * self.in_channels

    @property
    def center_index(self) -> int:
        """Index of the current frame in the temporal stack."""
        if self.temporal_center is None:
            return self.temporal_window // 2
        return self.temporal_center

    @property
    def future_frames(self) -> int:
        """Lookahead frames needed per output frame (0 = causal)."""
        return self.temporal_window - 1 - self.center_index


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Adversarial training."""

    batch_size: int = 8               # global
    num_epochs: int = 40
    steps_per_epoch: int = 1000

    # Adam, pix2pix-style
    lr_g: float = 2e-4
    lr_d: float = 2e-4
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    # linear decay to 0 over the second half of training
    lr_decay_start_frac: float = 0.5

    # loss weights; the adversarial weight is 1
    w_pixel: float = 100.0
    w_feature: float = 10.0
    w_temporal: float = 10.0
    w_warp_reg: float = 1.0
    # per-stage supervision weights, later stages higher
    stage_weights: Tuple[float, ...] = (0.5, 1.0)

    gan_loss: str = "lsgan"           # lsgan | vanilla | hinge

    # pixel-term form: "l1" (the reference loss), "mean_matched" (a
    # per-sample/channel brightness gain divided out before the L1) or
    # "gradient" (L1 on spatial finite differences); see
    # train.losses.pixel_loss_photometric
    pixel_loss_mode: str = "l1"

    # temporal-consistency form: "raw" penalizes |out_t - out_{t+1}|;
    # "compensated" penalizes |d(out) - d(gt)|
    temporal_mode: str = "compensated"

    # micro-batch gradient accumulation: one G and one D update per
    # step from gradients averaged over grad_accum_steps micro-batches
    grad_accum_steps: int = 1

    # exponential moving average of generator params (0 = off)
    ema_decay: float = 0.0

    seed: int = 0
    log_every: int = 50
    # run the eval hook every N steps; 0 = only at the end of training
    eval_every: int = 0
    # optional JSONL scalar log file in addition to stdout; "" = stdout only
    scalar_log_path: str = ""
    # TensorBoard event-file directory; "" = disabled
    tb_log_dir: str = ""
    checkpoint_every: int = 1000
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    debug_nans: bool = False
    # debug flag: raise at this step to exercise resume
    fault_inject_step: int = -1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """DeepStab pairing and the host-side loader (``data.deepstab``)."""

    data_root: str = "DeepStab"
    stable_dir: str = "stable"
    unstable_dir: str = "unstable"
    crop_size: Tuple[int, int] = (256, 256)
    random_flip: bool = True
    # shared random scale jitter applied before the crop; (1.0, 1.0)
    # disables it. The lower bound is clamped so the crop always fits.
    resize_scale_range: Tuple[float, float] = (1.0, 1.0)
    frame_stride: int = 1             # stride between temporal neighbours
    prefetch_depth: int = 2           # batches queued ahead of the loop
    # decode worker threads per batch (deepstab.batch_iterator)
    num_decode_threads: int = 2
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Data-parallel mesh for training and clip-sharded inference: the
    first ``num_devices`` ranks of the process group, one GPU each
    (``parallel.mesh``)."""

    data_axis: str = "data"
    num_devices: int = -1             # -1 = every rank of the process group


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Video-in / video-out inference."""

    batch_windows: int = 8            # temporal windows per device step
    border_crop_frac: float = 0.0     # optional stabilize-crop (0 = off)
    emit_warp_fields: bool = True
    # dtype warp fields cross device->host in; float16 halves the D2H
    # bytes of the flow stream (keep float32 when feeding flows back
    # into computation)
    warp_field_dtype: str = "float32"
    output_codec: str = "mp4v"
    prefetch_depth: int = 2
