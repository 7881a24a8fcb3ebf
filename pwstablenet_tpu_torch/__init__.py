"""PyTorch/CUDA port of pwstablenet_tpu for NVIDIA Hopper (H100).

The JAX package ``pwstablenet_tpu`` is the reference; this package
mirrors its layout, module by module, and imports nothing of it (nor
JAX).  Public functions keep the reference's layout: NHWC images and
(x, y)-last grids and flows.

Layout
------
- ``config``    model and pipeline configuration (a copy of the reference's)
- ``ops``       pixels, plain grid sample (the kernels' oracle), warps
- ``kernels``   hand-written CUDA kernels (``csrc/``), wrappers, plain versions
- ``models``    the cascaded UNet generator, the PatchGAN discriminator
                and the frozen feature extractor (``nn.Module``s)
- ``interop``   weights from the JAX package's parameter trees
- ``pipeline``  streaming inference: clip in -> stabilized clip + warp fields
- ``data``      synthetic training batches, host-side prefetch
- ``train``     losses, state, the adversarial train step, checkpoints,
                the training loop
- ``parallel``  one process per GPU on ``torch.distributed``: the mesh,
                data-parallel training, clip-sharded inference, the
                row-sharded warp
- ``examples``  the JAX package's training recipes, as ``run()``s
"""

__version__ = "0.1.0"

from pwstablenet_tpu_torch.config import (  # noqa: F401
    DataConfig,
    MeshConfig,
    ModelConfig,
    PipelineConfig,
    TrainConfig,
)
