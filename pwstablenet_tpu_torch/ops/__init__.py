"""Pixel conversion, plain grid sample and warps."""
