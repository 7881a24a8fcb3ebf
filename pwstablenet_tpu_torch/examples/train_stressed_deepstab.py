"""DeepStab-scale training recipe on the STRESSED rich distribution, the
counterpart of the JAX package's ``examples/train_stressed_deepstab.py``:
the rich recipe (``train_rich_deepstab``) on 61 pairs, DeepStab's size,
with dropout in the generator.  ``RICH`` includes motion blur on the
unstable view and auto-exposure steps; ``write_synthetic_deepstab``
draws per-pair shake and pan on top.

    python -m pwstablenet_tpu_torch.examples.train_stressed_deepstab [steps] [pairs]
"""

from __future__ import annotations

import sys
from typing import Optional

from pwstablenet_tpu_torch.config import ModelConfig
from pwstablenet_tpu_torch.examples import deepstab_recipe


def run(steps: int = 1000, pairs: int = 61, work_dir: Optional[str] = None,
        model_cfg: Optional[ModelConfig] = None, device=None, **cuts) -> dict:
    """The recipe at the JAX script's settings; ``cuts`` as in
    ``train_rich_deepstab.run``."""
    return deepstab_recipe.run("stressed", model_cfg or ModelConfig(use_dropout=True),
                               steps, pairs, work_dir, device, **cuts)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(steps=int(argv[0]) if argv else 1000, pairs=int(argv[1]) if len(argv) > 1 else 61)
    return 0


if __name__ == "__main__":
    sys.exit(main())
