"""The adversarial train step: the D update, then the G update, on one
device, or on each rank of a data-parallel mesh.

Batch format (``data.synthetic.make_train_batch``, on the device):
  stacks: (B, 2, H, W, T*C) temporal stacks for two consecutive time
          steps (for the temporal loss)
  stable: (B, 2, H, W, C) ground-truth stable frames
as uint8 (the transport format, normalized on the device) or as float32
in [-1, 1].  The pair axis is folded into the batch for every network
forward and unfolded only for the temporal term.

The generator runs forward ONCE.  The D update takes its detached last
warp; ``d_opt.step()`` runs before the G loss's D forward, so G is
scored against the updated D; the G loss then backpropagates through
the same generator graph, with D's parameters frozen so they receive no
gradient from it.  The warps are ``ops.warp.warp_image_fused``: the f32
sample kernel forward, the d/dgrid kernel backward.

A step updates the state in place and returns its metrics as device
tensors (no host sync).

Data parallel (``parallel.mesh.data_parallel_step``): each rank runs
the step on its shard of the global batch with a ``grad_sync``, called
with D after D's backward and with G after G's (after each phase's
micro-batches under gradient accumulation, which splits the rank's own
shard), before the grad norm and the optimizer step; the metrics are
averaged over the ranks before the step returns them.  G and D are not
wrapped in ``DistributedDataParallel``: the step runs G forward once for
two backward passes and freezes D during the G update, and DDP's reducer
expects one forward per backward.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import torch

from pwstablenet_tpu_torch.config import ModelConfig, TrainConfig
from pwstablenet_tpu_torch.ops.pixels import to_unit
from pwstablenet_tpu_torch.ops.warp import warp_image_fused
from pwstablenet_tpu_torch.train import losses
from pwstablenet_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]
TERMS = ("adv", "pixel", "feature", "temporal", "warp_reg")


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(B, 2, ...) -> (2B, ...)"""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _center(stack: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    c0 = cfg.center_index * cfg.in_channels
    return stack[..., c0 : c0 + cfg.in_channels]


def _temporal_term(train_cfg: TrainConfig, w_s, stable) -> torch.Tensor:
    pair = w_s.reshape((-1, 2) + tuple(w_s.shape[1:]))
    if train_cfg.temporal_mode == "compensated":
        gt_pair = stable.reshape((-1, 2) + tuple(stable.shape[1:]))
        return losses.temporal_loss_compensated(pair, gt_pair)
    return losses.temporal_loss(pair)


def optax_global_norm(tensors: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``);
    a missing gradient counts as zero."""
    sq = [torch.sum(t.to(torch.float32).square()) for t in tensors if t is not None]
    return torch.sqrt(torch.stack(sq).sum())


def _grads(module: torch.nn.Module) -> List[Optional[torch.Tensor]]:
    return [p.grad for p in module.parameters()]


@torch.no_grad()
def _ema_update(train_cfg: TrainConfig, state: TrainState) -> None:
    """ema <- d * ema + (1 - d) * params (no-op when off)."""
    if train_cfg.ema_decay <= 0 or state.g_ema is None:
        return
    d = train_cfg.ema_decay
    ema = list(state.g_ema.parameters())
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, list(state.g.parameters()), alpha=1.0 - d)


@contextlib.contextmanager
def _frozen(module: torch.nn.Module) -> Iterator[None]:
    """Parameters of ``module`` take no gradient inside the block."""
    module.requires_grad_(False)
    try:
        yield
    finally:
        module.requires_grad_(True)


def _dropout_seed(state: TrainState, rank: int = 0) -> int:
    """Advance the state's generator once per step (the JAX step splits
    ``state.rng`` once); the data-parallel rank is added, so that ranks
    draw distinct masks while their generators stay equal."""
    return int(torch.randint(0, 2**62, (1,), generator=state.rng)) + rank


def make_train_step(
    model_cfg: ModelConfig, train_cfg: TrainConfig, grad_sync=None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Metrics]:
    """Build ``train_step(state, batch) -> metrics``.

    ``grad_sync`` (``parallel.mesh.GradSync``): the data-parallel
    gradient and metrics sync, and the rank folded into the dropout
    seed.  The step keeps its configurations as ``model_cfg`` and
    ``train_cfg`` attributes, from which ``data_parallel_step`` builds
    the synced step."""
    if train_cfg.temporal_mode not in ("raw", "compensated"):
        raise ValueError(
            f"unknown temporal_mode {train_cfg.temporal_mode!r} "
            "(raw | compensated)"
        )
    if train_cfg.pixel_loss_mode not in ("l1", "mean_matched", "gradient"):
        raise ValueError(
            f"unknown pixel_loss_mode {train_cfg.pixel_loss_mode!r} "
            "(l1 | mean_matched | gradient)"
        )

    def warp(center, flow):
        return warp_image_fused(
            center, flow, padding_mode=model_cfg.padding_mode,
            align_corners=model_cfg.align_corners,
        )

    def g_apply(state, stacks, seed):
        gen = None
        if model_cfg.use_dropout:
            # the same seed gives the same masks for the same shape, as
            # one JAX key does (the micro-batches of the accumulating
            # step see one mask in both phases)
            gen = torch.Generator(device=stacks.device).manual_seed(seed)
        return state.g(stacks, dropout_generator=gen)

    def d_loss_fn(state, center, stable, fake):
        real_logits = state.d(torch.cat([center, stable], dim=-1))
        fake_logits = state.d(torch.cat([center, fake], dim=-1))
        return losses.gan_loss_d(real_logits, fake_logits, train_cfg.gan_loss)

    def g_loss_fn(state, flows, center, stable):
        """Stage-weighted G loss against the (updated) D, and the last
        stage's terms."""
        with torch.no_grad():
            feats_target = state.feat(stable)
        per_stage, terms = [], {}
        for s, flow in enumerate(flows):
            w_s = warp(center, flow)
            fake_logits = state.d(torch.cat([center, w_s], dim=-1))
            adv = losses.gan_loss_g(fake_logits, train_cfg.gan_loss)
            pix = losses.pixel_loss_photometric(w_s, stable, train_cfg.pixel_loss_mode)
            per = losses.feature_loss(state.feat(w_s), feats_target)
            tmp = _temporal_term(train_cfg, w_s, stable)
            reg = losses.warp_smoothness_loss(flow)
            per_stage.append(
                adv
                + train_cfg.w_pixel * pix
                + train_cfg.w_feature * per
                + train_cfg.w_temporal * tmp
                + train_cfg.w_warp_reg * reg
            )
            terms = dict(zip(TERMS, (adv, pix, per, tmp, reg)))
        total = losses.stage_weighted(
            per_stage, train_cfg.stage_weights[: len(per_stage)]
        )
        return total, terms

    rank = grad_sync.rank if grad_sync is not None else 0

    def sync(module):
        if grad_sync is not None:
            grad_sync(module)

    def finish(state, d_loss, g_loss, d_norm, g_norm, terms) -> Metrics:
        _ema_update(train_cfg, state)
        state.step += 1
        metrics = {
            "loss_d": d_loss.detach(),
            "loss_g": g_loss.detach(),
            "grad_norm_g": g_norm,
            "grad_norm_d": d_norm,
            **{k: v.detach() for k, v in terms.items()},
        }
        return grad_sync.mean(metrics) if grad_sync is not None else metrics

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Metrics:
        stacks = to_unit(_fold(batch["stacks"]))  # (2B, H, W, T*C)
        stable = to_unit(_fold(batch["stable"]))  # (2B, H, W, C)
        center = _center(stacks, model_cfg)       # (2B, H, W, C) unstable
        flows = g_apply(state, stacks, _dropout_seed(state, rank))

        # ---------------- D update (fake detached) ----------------
        with torch.no_grad():
            fake = warp(center, flows[-1])
        d_loss = d_loss_fn(state, center, stable, fake)
        state.d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        sync(state.d)
        d_norm = optax_global_norm(_grads(state.d))
        state.d_opt.step()
        state.d_sched.step()

        # ---------------- G update (against the updated D) ----------
        with _frozen(state.d):
            g_loss, terms = g_loss_fn(state, flows, center, stable)
            state.g_opt.zero_grad(set_to_none=True)
            g_loss.backward()
        sync(state.g)
        g_norm = optax_global_norm(_grads(state.g))
        state.g_opt.step()
        state.g_sched.step()
        return finish(state, d_loss, g_loss, d_norm, g_norm, terms)

    train_step.model_cfg, train_step.train_cfg = model_cfg, train_cfg
    if train_cfg.grad_accum_steps <= 1:
        return train_step

    accum = train_cfg.grad_accum_steps

    def accum_train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Metrics:
        """Gradient accumulation: phase 1 accumulates D gradients over
        the micro-batches (G outputs detached) and applies ONE D update;
        phase 2 re-runs G per micro-batch against the UPDATED D,
        accumulates, and applies ONE G update.  Gradients and metrics are
        means over micro-batches; activation memory is one micro-batch's."""
        stacks = to_unit(_fold(batch["stacks"]))
        stable = to_unit(_fold(batch["stable"]))
        if stacks.shape[0] % accum:
            raise ValueError(
                f"grad_accum_steps ({accum}) must divide 2*batch_size "
                f"({stacks.shape[0]})"
            )
        m = stacks.shape[0] // accum
        micro = list(zip(torch.split(stacks, m), torch.split(stable, m)))
        seed = _dropout_seed(state, rank)

        # ---------------- phase 1: D gradient accumulation ----------
        state.d_opt.zero_grad(set_to_none=True)
        d_loss = torch.zeros((), dtype=torch.float32, device=stacks.device)
        for st, sb in micro:
            center = _center(st, model_cfg)
            with torch.no_grad():
                fake = warp(center, g_apply(state, st, seed)[-1])
            loss = d_loss_fn(state, center, sb, fake) / accum
            loss.backward()
            d_loss = d_loss + loss.detach()
        sync(state.d)
        d_norm = optax_global_norm(_grads(state.d))
        state.d_opt.step()
        state.d_sched.step()

        # ---------------- phase 2: G gradient accumulation ----------
        state.g_opt.zero_grad(set_to_none=True)
        g_loss = torch.zeros_like(d_loss)
        terms = {k: torch.zeros_like(d_loss) for k in TERMS}
        with _frozen(state.d):
            for st, sb in micro:
                center = _center(st, model_cfg)
                flows = g_apply(state, st, seed)
                loss, t = g_loss_fn(state, flows, center, sb)
                (loss / accum).backward()
                g_loss = g_loss + loss.detach() / accum
                terms = {k: terms[k] + t[k].detach() / accum for k in TERMS}
        sync(state.g)
        g_norm = optax_global_norm(_grads(state.g))
        state.g_opt.step()
        state.g_sched.step()
        return finish(state, d_loss, g_loss, d_norm, g_norm, terms)

    accum_train_step.model_cfg, accum_train_step.train_cfg = model_cfg, train_cfg
    return accum_train_step
