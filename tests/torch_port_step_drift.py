"""Why the vanilla GAN loss's second train step is compared on batch 5,
not 4 (a diagnostic, not a test; prints JSON lines).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_step_drift.py

1. ``readings``: the parity test's per-step readings (share of G's and
   D's elements within 1e-6 of JAX's, max |diff| / lr) for each GAN loss
   on batches (3, 4), and for vanilla on (3, 5).
2. ``kink``: the vanilla second step on batch 4 from ONE state (the
   port set to JAX's first-step parameters and Adam moments), on the D
   update's own inputs as the port's step makes them.  For each of D's
   leaky-ReLU inputs, the elements whose sign differs between the port
   and JAX, and D's gradient's max difference from ``jax.grad`` relative
   to its largest element: as the port computes it, and with the
   differing elements put on JAX's side of the kink (weights only:
   the norm-fed biases' gradients are rounding noise).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from pwstablenet_tpu.config import ModelConfig as JaxModelConfig
from pwstablenet_tpu.models import PatchDiscriminator as JaxPatchDiscriminator
from pwstablenet_tpu.train import losses as jax_losses

from pwstablenet_tpu_torch.config import ModelConfig
from pwstablenet_tpu_torch.interop.from_jax import tree_to_state_dict
from pwstablenet_tpu_torch.models import discriminator as port_disc
from pwstablenet_tpu_torch.train import losses as port_losses

from test_torch_port_train import (
    CPU, TCFG, TINY, _pair, _run_pair, _sync_from_jax, batch_to_device, make_train_batch,
)


def kink(gan="vanilla", seeds=(3, 4)):
    over = {**TCFG, "gan_loss": gan}
    jstep, jstate, step, state = _pair(TINY, over)
    batches = [make_train_batch(2, 32, 32, TINY["temporal_window"], seed=s) for s in seeds]
    jstate, _ = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batches[0]))
    step(state, batch_to_device(batches[0], CPU))
    _sync_from_jax(state, jstate, full=True)
    seen = []  # the D update's real and fake pairs come first
    hook = state.d.register_forward_pre_hook(lambda m, a: seen.append(a[0].detach().clone()))
    step(state, batch_to_device(batches[1], CPU))
    hook.remove()
    pairs = seen[:2]

    jd = JaxPatchDiscriminator(JaxModelConfig(**TINY))
    dp = jstate.d_params
    names = ["conv0"] + [f"norm{i}" for i in range(1, TINY["disc_num_layers"] + 1)]
    jax_pos = []  # flax's leaky ReLU keeps x >= 0
    for x in pairs:
        _, inter = jd.apply(dp, jnp.asarray(x.numpy()), capture_intermediates=True)
        for n in names:
            a = np.asarray(inter["intermediates"][n]["__call__"][0])
            jax_pos.append((n, torch.from_numpy(a).permute(0, 3, 1, 2) >= 0, a))

    def jloss(p):
        return jax_losses.gan_loss_d(jd.apply(p, jnp.asarray(pairs[0].numpy())),
                                     jd.apply(p, jnp.asarray(pairs[1].numpy())), gan)

    ref = tree_to_state_dict(jax.device_get(jax.grad(jloss)(dp)))
    d = port_disc.PatchDiscriminator(ModelConfig(**TINY))
    d.load_state_dict(tree_to_state_dict(jax.device_get(dp)))
    leaky = F.leaky_relu
    out = {"gan_loss": gan, "seeds": list(seeds)}
    for follow_jax in (False, True):
        calls, flips = iter(jax_pos), []

        def patched(x, slope):
            name, pos, a = next(calls)
            differ = (x.detach() > 0) != pos
            if differ.any():
                ours = x.detach().permute(0, 2, 3, 1).numpy()
                mask = differ.permute(0, 2, 3, 1).numpy()
                flips.append({"layer": name, "n": int(differ.sum()),
                              "jax": a[mask].tolist(), "port": ours[mask].tolist()})
            return torch.where(pos, x, slope * x) if follow_jax else leaky(x, slope)

        port_disc.F.leaky_relu = patched
        try:
            d.zero_grad()
            port_losses.gan_loss_d(d(pairs[0]), d(pairs[1]), gan).backward()
        finally:
            port_disc.F.leaky_relu = leaky
        rel = max(float((p.grad - ref[n]).abs().max() / ref[n].abs().max())
                  for n, p in d.named_parameters() if n.endswith("weight"))
        key = "on_jax_side" if follow_jax else "as_computed"
        out[key] = {"d_grad_max_rel_diff": rel}
        if not follow_jax:
            out["sign_differs"] = flips
    return out


if __name__ == "__main__":
    for gan, seeds in (("lsgan", (3, 4)), ("hinge", (3, 4)), ("vanilla", (3, 4)),
                       ("vanilla", (3, 5))):
        print(json.dumps({"readings": _run_pair({"gan_loss": gan, "seeds": seeds},
                                                check=False),
                          "gan_loss": gan, "seeds": list(seeds)}), flush=True)
    print(json.dumps({"kink": kink()}), flush=True)
