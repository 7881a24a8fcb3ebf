"""Flagship training recipe on the RICH synthetic distribution, the
counterpart of the JAX package's ``examples/train_rich_deepstab.py``:
12 rich pairs of 80 frames at 320x448, 1000 steps of batch 8, a
generator EMA of 0.995, the held-out hook every 250 steps with
best-step tracking, then ``EVAL[ema]`` and ``EVAL[best]`` on a fresh
clip (``examples.deepstab_recipe``).

    python -m pwstablenet_tpu_torch.examples.train_rich_deepstab [steps]

On the CPU, at a small model and size::

    run(steps=2, pairs=1, model_cfg=ModelConfig(...), device="cpu",
        frames=12, size=(64, 96), eval_every=1)
"""

from __future__ import annotations

import sys
from typing import Optional

from pwstablenet_tpu_torch.config import ModelConfig
from pwstablenet_tpu_torch.examples import deepstab_recipe


def run(steps: int = 1000, pairs: int = 12, work_dir: Optional[str] = None,
        model_cfg: Optional[ModelConfig] = None, device=None, **cuts) -> dict:
    """The recipe at the JAX script's settings; ``cuts`` (``frames``,
    ``size``, ``log_every``, ``eval_every``, ``checkpoint_every``,
    ``eval_frames``) go to ``deepstab_recipe.run``."""
    return deepstab_recipe.run("rich", model_cfg or ModelConfig(), steps, pairs,
                               work_dir, device, **cuts)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(steps=int(argv[0]) if argv else 1000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
