"""``Kinks``: the points where the train step is not differentiable,
recorded in the JAX step and followed in the port's (a helper of the
parity tests, not a test module).

An argument within rounding of a kink (``abs`` in the losses, the BCE's
``maximum(x, 0)``, a ReLU or leaky-ReLU input, a sample coordinate on a
cell edge of a warp's bilinear sampler) may fall on one side in JAX and
on the other in the port, depending on the host's rounding, and moves a
gradient by a whole branch.  ``tests/test_torch_port_train.py``
(docstring) says why the parity tests need this, and
``tests/torch_port_step_drift.py`` prints what it moves.
"""

import collections
import contextlib
import functools
import sys
import types

import numpy as np
import torch
import torch.nn.functional as F

import flax.linen as nn
import jax
import jax.numpy as jnp

from pwstablenet_tpu.models import CascadedGenerator as JaxCascadedGenerator
from pwstablenet_tpu.ops import warp as jax_warp
from pwstablenet_tpu.train import losses as jax_losses
from pwstablenet_tpu.train import make_train_step as jax_make_train_step

from pwstablenet_tpu_torch.ops import warp as port_warp
from pwstablenet_tpu_torch.ops.grid_sample import _unnormalize
from pwstablenet_tpu_torch.train import losses as port_losses

KINK_MARGIN = 1e-5
# the functions with a kink at 0; ``maximum`` is the BCE's
# ``maximum(x, 0)`` (torch: ``clamp(x, min=0)``), paired with its ``abs``
KINDS = ("abs", "relu", "leaky_relu", "maximum")


def grid_calls(accum=1, stages=2, interstage="both"):
    """The JAX step's sampler calls that match the port's, in the port's
    order, and the number of the JAX step's calls.  A generator forward
    warps between its stages (``stages - 1`` calls) in both packages
    when ``interstage`` feeds the next stage the warped frame
    (``warped``, ``both``), and not at all under ``features``.
    The D update warps every stage in JAX and keeps the last, the port
    warps the last only; the G loss warps every stage in both.  Under
    accumulation JAX's two scans run these per micro-batch, phase 1 (the
    D update's) for every micro-batch, then phase 2 (the G loss's)."""
    inter = stages - 1 if interstage in ("warped", "both") else 0
    if accum == 1:
        ours = list(range(inter)) + [inter + stages - 1]
        ours += range(inter + stages, inter + 2 * stages)
        return tuple(ours), inter + 2 * stages
    ours, n = [], 0
    for phase in (1, 2):
        for _ in range(accum):
            ours += range(n, n + inter)
            ours += [n + inter + stages - 1] if phase == 1 else range(n + inter, n + inter + stages)
            n += inter + stages
    return tuple(ours), n


class _View(types.ModuleType):
    """``base`` with some of its names replaced."""

    def __init__(self, base, **names):
        super().__init__(base.__name__)
        self._base = base
        self.__dict__.update(names)

    def __getattr__(self, name):
        return getattr(self._base, name)


def _branch(kind, x, slope, jax_side):
    """The factor that the backward of ``kind`` takes at each element of
    ``x``: ``jax.grad``'s (``jnp.abs``: +1 at 0; flax's leaky ReLU: 1 at
    0; ``jnp.maximum``: 0.5 at a tie) or torch's (``abs``: ``sign``, 0 at
    0; ``leaky_relu``: the slope at 0; ``clamp(min=0)``: 1 at 0).  Both
    ReLUs take 0 at 0."""
    one = torch.ones_like(x)
    if kind == "abs":
        return torch.where(x >= 0, one, -one) if jax_side else torch.sign(x)
    if kind == "relu":
        return (x > 0).to(x.dtype)
    if kind == "maximum":
        if jax_side:
            return torch.where(x > 0, one, torch.where(x == 0, 0.5 * one, 0 * one))
        return (x >= 0).to(x.dtype)
    return torch.where(x >= 0 if jax_side else x > 0, one, slope * one)


def _caller():
    """The last name of the module whose code called the tapped
    function (``blocks``, ``unet``, ``discriminator``, ``features``)."""
    return sys._getframe(2).f_globals["__name__"].rsplit(".", 1)[-1]


class Kinks:
    """The kinks of the train step in both packages, by stream: a kind
    and the module that calls it (``losses.abs``, ``losses.maximum``
    and ``losses.relu`` of the losses; ``blocks.leaky_relu``,
    ``blocks.relu`` and ``unet.relu`` of G; ``discriminator.leaky_relu``;
    ``features.relu``), and ``grid``, the warps' sampler.

    ``jax()`` swaps JAX's functions while its step runs: each records
    its argument, and the sampler its grid, through an ordered
    ``jax.debug.callback``, so that a stream's records come in the order
    the step executes them.  Each micro-batch of the accumulating step's
    two scans thus gets its own record, as each call of the port's
    micro-batch loop does.  A jitted step keeps the taps it was traced
    with and records into the ``Kinks`` it was traced under: trace it
    and run it under one ``Kinks``.  The step and the generator call the
    warp's body unjitted then, so that each warp is traced, and
    recorded, on its own.

    ``port()`` then swaps the port's for versions with the same forward
    whose backward takes JAX's branch wherever the port's argument lies
    within ``margin`` of the kink (``follow``: the kinds it does so
    for), and checks the rest: every argument farther away must already
    be on JAX's side, every sample coordinate of the warps that the port
    shares with JAX (``grid_calls``) must lie in the same cell of the
    sampler in both packages, and none on a clamp end, where the TPU
    kernel that the port follows and JAX's ``jnp.clip`` split the
    gradient differently.  The BCE's ``maximum`` and its ``abs`` take the
    same argument and are followed together: near 0 the port then takes
    JAX's whole derivative of ``_bce_with_logits`` (-t at 0, where
    torch's is 1 - t).  ``assert_all_matched`` then holds the port's
    call counts to JAX's.  On a host whose rounding breaks any of that,
    the step fails loudly before it is compared.
    """

    def __init__(self, align_corners=True, margin=KINK_MARGIN, follow=KINDS, strict=True,
                 accum=1, stages=2, interstage="both"):
        assert ("maximum" in follow) == ("abs" in follow), "the BCE's pair is followed together"
        self.values = collections.defaultdict(list)
        self.align_corners, self.margin = align_corners, margin
        self.follow, self.strict = follow, strict
        self.grid_calls, self.jax_grids = grid_calls(accum, stages, interstage)

    def _record(self, stream, v):
        self.values[stream].append(np.asarray(v))

    def _tap(self, kind, fn, owner=None):
        def tapped(x, *args, **kw):
            stream = kind if kind == "grid" else f"{owner or _caller()}.{kind}"
            jax.debug.callback(functools.partial(self._record, stream), x, ordered=True)
            return fn(x, *args, **kw)

        return tapped

    @contextlib.contextmanager
    def jax(self):
        self.values = collections.defaultdict(list)
        sample, warp = jax_warp.grid_sample, jax_warp.warp_image_fused
        callers = [sys.modules[f.__module__] for f in (jax_make_train_step, JaxCascadedGenerator)]
        saved = [(jax_losses, "jnp", jax_losses.jnp), (jax_losses, "jax", jax_losses.jax),
                 (nn, "relu", nn.relu), (nn, "leaky_relu", nn.leaky_relu),
                 (jax_warp, "grid_sample", sample)]
        saved += [(m, "warp_image_fused", warp) for m in callers]
        for m in callers:
            m.warp_image_fused = warp.__wrapped__
        jax_losses.jnp = _View(jnp, abs=self._tap("abs", jnp.abs, "losses"),
                               maximum=self._tap("maximum", jnp.maximum, "losses"))
        jax_losses.jax = _View(jax, nn=_View(jax.nn, relu=self._tap("relu", jax.nn.relu,
                                                                     "losses")))
        nn.relu = self._tap("relu", nn.relu)
        nn.leaky_relu = self._tap("leaky_relu", nn.leaky_relu)
        grid_tap = self._tap("grid", lambda g: g)
        jax_warp.grid_sample = lambda image, grid, **kw: sample(image, grid_tap(grid), **kw)
        try:
            yield
            jax.effects_barrier()
        finally:
            for owner, name, value in saved:
                setattr(owner, name, value)

    def _kinked(self, kind, fn, owner=None):
        def kinked(x, *args, **kw):
            stream = f"{owner or _caller()}.{kind}"
            i = self.calls[stream]
            self.calls[stream] += 1
            records = self.values[stream]
            assert i < len(records), (
                f"{stream} #{i}: the port's step calls it more often than JAX's "
                f"({len(records)} calls)")
            ref = torch.from_numpy(np.array(records[i]))
            if not stream.startswith("losses.") and ref.dim() == 4:  # flax's NHWC, the port's NCHW
                ref = ref.permute(0, 3, 1, 2)
            assert ref.shape == x.shape, f"{stream} #{i}: {tuple(ref.shape)} != {tuple(x.shape)}"
            slope = args[0] if args else kw.get("negative_slope", 0.01)
            xd = x.detach()
            ours, theirs = _branch(kind, xd, slope, False), _branch(kind, ref, slope, True)
            near = xd.abs() < self.margin
            far = (ours != theirs) & ~near
            assert not (self.strict and far.any()), (
                f"{stream} #{i}: {int(far.sum())} arguments at least {self.margin} from "
                f"the kink take another branch than JAX's (port {xd[far][:4].tolist()}, "
                f"JAX {ref[far][:4].tolist()})")
            self.seen[stream].append((xd, ref))
            if kind not in self.follow:
                return fn(x, *args, **kw)
            self.moved[stream] += int(((ours != theirs) & near).sum())
            s = torch.where(near, theirs, ours)
            return fn(x, *args, **kw).detach() + (x * s - (x * s).detach())

        return kinked

    def _cells(self, i, grid):
        ref = torch.from_numpy(np.array(self.values["grid"][self.grid_calls[i]]))
        assert ref.shape == grid.shape, f"grid #{i}: {tuple(ref.shape)} != {tuple(grid.shape)}"
        for axis, size in ((0, grid.shape[2]), (1, grid.shape[1])):
            ours, theirs = (_unnormalize(g[..., axis], size, self.align_corners)
                            for g in (grid, ref))
            cell = [torch.floor(u.clamp(0, size - 1)) for u in (ours, theirs)]
            out = [(u < 0) | (u > size - 1) for u in (ours, theirs)]
            tie = [(u == 0) | (u == size - 1) for u in (ours, theirs)]
            bad = (cell[0] != cell[1]) | (out[0] != out[1]) | tie[0] | tie[1]
            self.seen["grid"].append(int(bad.sum()))
            assert not (self.strict and bad.any()), (
                f"warp #{i}, axis {axis}: {int(bad.sum())} sample coordinates lie in "
                f"another cell of the sampler than JAX's, or on a clamp end (port "
                f"{ours[bad][:4].tolist()}, JAX {theirs[bad][:4].tolist()})")

    @contextlib.contextmanager
    def port(self):
        self.calls = collections.Counter()
        self.seen = collections.defaultdict(list)
        self.moved = collections.Counter()
        kernels = port_warp.kernels

        def sample(image, grid, *args):
            assert self.calls["grid"] < len(self.grid_calls), "the port's step warps more often"
            self._cells(self.calls["grid"], grid)
            self.calls["grid"] += 1
            return kernels.grid_sample_f32(image, grid, *args)

        bce_max = self._kinked("maximum", torch.clamp, "losses")

        def clamp(x, *args, **kw):
            # the BCE's clamp(x, min=0) is the kink; the mean-matched
            # gain's clamp(g, 0.5, 2.0) is detached
            return bce_max(x, **kw) if not args and kw == {"min": 0.0} else torch.clamp(x, *args, **kw)

        saved = [(port_losses, "torch", port_losses.torch), (F, "relu", F.relu),
                 (F, "leaky_relu", F.leaky_relu), (port_warp, "kernels", kernels)]
        port_losses.torch = _View(torch, abs=self._kinked("abs", torch.abs, "losses"),
                                  clamp=clamp)
        F.relu = self._kinked("relu", F.relu)
        F.leaky_relu = self._kinked("leaky_relu", F.leaky_relu)
        port_warp.kernels = _View(kernels, grid_sample_f32=sample)
        try:
            yield self
        finally:
            for owner, name, value in saved:
                setattr(owner, name, value)

    def assert_all_matched(self):
        """The port's step made as many calls of each stream as JAX's."""
        expect = {s: len(v) for s, v in self.values.items() if s != "grid" and v}
        made = {s: n for s, n in self.calls.items() if s != "grid"}
        assert made == expect, f"calls of each stream: port {made}, JAX {expect}"
        grids = (self.calls["grid"], len(self.values["grid"]))
        assert grids == (len(self.grid_calls), self.jax_grids), f"warps: port, JAX {grids}"
