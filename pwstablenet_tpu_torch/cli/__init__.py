"""Command-line interface: ``python -m pwstablenet_tpu_torch.cli``."""

from pwstablenet_tpu_torch.cli.main import main  # noqa: F401
