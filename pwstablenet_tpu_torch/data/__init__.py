"""Synthetic training data and host-side prefetch."""

from pwstablenet_tpu_torch.data.synthetic import (  # noqa: F401
    make_train_batch,
    synthetic_pair_clip,
)
