"""Generator, discriminator and feature-extractor modules."""

from pwstablenet_tpu_torch.models.blocks import DownBlock, UpBlock  # noqa: F401
from pwstablenet_tpu_torch.models.discriminator import PatchDiscriminator  # noqa: F401
from pwstablenet_tpu_torch.models.features import FeatureExtractor  # noqa: F401
from pwstablenet_tpu_torch.models.generator import CascadedGenerator  # noqa: F401
from pwstablenet_tpu_torch.models.unet import StageUNet  # noqa: F401
