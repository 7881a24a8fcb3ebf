"""The train step under the JAX package's non-default settings, the
combinations of ``chip_smoke.CONFIGS``, against the JAX step on the CPU,
and under ``interstage="features"`` alone.

Each case is ``tests/test_torch_port_train.py``'s comparison (its
docstring gives the tolerances and why the steps run through ``Kinks``)
at ``TINY`` with the combination's model and train overrides: two steps
from one state, each held to JAX's.  C runs without dropout: the two
packages draw different masks.

Under ``features`` neither package warps between the generator's
stages; ``Kinks`` once paired the warps as if both did, and failed the
step at its first warp (1646 of its sample coordinates in another cell
of the sampler than JAX's, on one host) before anything was compared."""

import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import CONFIGS
from pwstablenet_tpu_torch.data.synthetic import make_train_batch
from pwstablenet_tpu_torch.train.loop import batch_to_device

from test_torch_port_train import (
    SEEDS, TCFG, TINY, _assert_step_close, _pair, _run_pair, _sync_from_jax,
)
from torch_port_kinks import Kinks

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_step_matches_jax(name):
    combo = CONFIGS[name]
    model = {k: v for k, v in combo["model"].items() if k != "use_dropout"}
    _run_pair(combo["train"], model_over=model, hinge_at_scale=True)


def test_train_step_under_features_matches_jax_and_kinks_pairs_its_warps():
    """``interstage="features"`` alone: the two steps against JAX's; at
    the first, the pairing of the warps that ``Kinks`` used before its
    repair (``stages - 1`` inter-stage warps, as under ``warped``) fails
    the port's step at its first warp, and the step then passes with the
    pairing that counts none."""
    model = {**TINY, "interstage": "features"}
    jstep, jstate, step, state = _pair(model, TCFG)
    taps = Kinks(interstage="features")
    lr = TCFG["lr_g"]
    for n, seed in enumerate(SEEDS, start=1):
        batch = make_train_batch(2, 32, 32, TINY["temporal_window"], seed=seed)
        with taps.jax():
            jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        if n == 1:
            old = Kinks(interstage="warped")
            old.values = taps.values  # the JAX step's records
            with pytest.raises(AssertionError, match=r"warp #0, axis 0: \d+ sample "
                                                     r"coordinates lie in another cell"):
                with old.port():
                    step(state, batch_to_device(batch, CPU))
            assert state.step == 0  # it failed before any update
        with taps.port():
            m = step(state, batch_to_device(batch, CPU))
        taps.assert_all_matched()
        assert state.step == int(jstate.step) == n
        _assert_step_close(m, jm, state, jstate, lr, n)
        _sync_from_jax(state, jstate, full=True)
