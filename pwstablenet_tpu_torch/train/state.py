"""Training state: the generator, discriminator and frozen feature
extractor, two Adam optimizers with their learning-rate schedules, the
EMA copy of the generator, the dropout generator and the step count.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Iterable, Optional

import torch

from pwstablenet_tpu_torch.config import ModelConfig, TrainConfig
from pwstablenet_tpu_torch.models.discriminator import PatchDiscriminator
from pwstablenet_tpu_torch.models.features import FeatureExtractor
from pwstablenet_tpu_torch.models.generator import CascadedGenerator
from pwstablenet_tpu_torch.pipeline import resolve_device


@dataclasses.dataclass
class TrainState:
    step: int
    g: CascadedGenerator
    d: PatchDiscriminator
    feat: FeatureExtractor             # frozen
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    g_sched: torch.optim.lr_scheduler.LambdaLR
    d_sched: torch.optim.lr_scheduler.LambdaLR
    # draws one dropout seed per step (a CPU generator, saved with the
    # checkpoint)
    rng: torch.Generator
    # exponential moving average of g (None unless
    # TrainConfig.ema_decay > 0); the preferred inference weights
    g_ema: Optional[CascadedGenerator] = None

    def generator_params(self, prefer_ema: bool = True) -> CascadedGenerator:
        """Generator for inference: the EMA copy when tracked, else the
        raw generator."""
        if prefer_ema and self.g_ema is not None:
            return self.g_ema
        return self.g


def feeds_a_norm(name: str, names: Iterable[str]) -> bool:
    """Whether ``name`` is the bias of a conv whose output goes straight
    into a norm with parameters: ``<block>.conv|deconv.bias`` beside
    ``<block>.norm``, or the discriminator's ``conv{i}.bias`` beside
    ``norm{i}`` (``names``: the module's ``state_dict`` names).  The norm
    removes any per-channel constant, so such a bias's gradient is zero
    but for rounding, and Adam moves it by ~lr in a direction set by
    rounding noise: two correct implementations disagree there."""
    parts = name.split(".")
    if parts[-1] != "bias":
        return False
    layer = parts[-2]
    norm = "norm" if layer in ("conv", "deconv") else layer.replace("conv", "norm")
    prefix = ".".join(parts[:-2] + [norm]) + "."
    return norm != layer and any(n.startswith(prefix) for n in names)


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Multiplier of the base learning rate at update ``count`` (the
    number of updates before this one, as optax counts): 1, then linear
    to 0 from ``lr_decay_start_frac`` of training on."""
    total = cfg.num_epochs * cfg.steps_per_epoch
    decay_start = int(total * cfg.lr_decay_start_frac)
    span = max(total - decay_start, 1)

    def factor(count: int) -> float:
        if count < decay_start:
            return 1.0
        return 1.0 - min((count - decay_start) / span, 1.0)

    return factor


def _adam(params, lr: float, cfg: TrainConfig):
    opt = torch.optim.Adam(params, lr=lr, betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8)
    # LambdaLR reads the factor at its own count, which step() advances
    # after each update: update k runs at factor(k)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, make_lr_schedule(cfg))


def create_train_state(
    model_cfg: ModelConfig, train_cfg: TrainConfig, device=None
) -> TrainState:
    """Initialise the models on the host from ``train_cfg.seed`` (one
    explicit generator, so the CPU and the card start from the same
    weights), then move them to ``device`` (the card unless the caller
    asks for the CPU)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(train_cfg.seed)
    g = CascadedGenerator(model_cfg, generator=gen)
    d = PatchDiscriminator(model_cfg, generator=gen)
    feat = FeatureExtractor(model_cfg, generator=gen)
    rng = torch.Generator().manual_seed(
        int(torch.randint(0, 2**62, (1,), generator=gen))
    )
    return make_train_state(train_cfg, g, d, feat, rng, device)


def make_train_state(
    train_cfg: TrainConfig, g: CascadedGenerator, d: PatchDiscriminator,
    feat: FeatureExtractor, rng: torch.Generator, device: torch.device,
) -> TrainState:
    """A step-0 state around given modules (moved to ``device``): fresh
    optimizers and, when ``ema_decay > 0``, an EMA copy of ``g``."""
    g, d, feat = g.to(device), d.to(device), feat.to(device)
    g_opt, g_sched = _adam(g.parameters(), train_cfg.lr_g, train_cfg)
    d_opt, d_sched = _adam(d.parameters(), train_cfg.lr_d, train_cfg)
    g_ema = None
    if train_cfg.ema_decay > 0:
        g_ema = copy.deepcopy(g).requires_grad_(False)
    return TrainState(
        step=0, g=g, d=d, feat=feat, g_opt=g_opt, d_opt=d_opt,
        g_sched=g_sched, d_sched=d_sched, rng=rng, g_ema=g_ema,
    )
