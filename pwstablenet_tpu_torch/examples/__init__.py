"""Training recipes, the counterparts of the JAX package's ``examples/``.

Each recipe is a ``run(...)`` whose defaults are the JAX script's
settings, and a ``main()`` that takes the JAX script's positional
arguments::

    python -m pwstablenet_tpu_torch.examples.train_synthetic_demo [steps]
    python -m pwstablenet_tpu_torch.examples.train_rich_deepstab [steps]
    python -m pwstablenet_tpu_torch.examples.train_stressed_deepstab [steps] [pairs]

They run on the card unless ``run(device="cpu")`` is asked for, and
print the JAX scripts' lines with the same keys.
"""
