"""Model code for all six families of the reference (dense, MoE, SSM,
hybrid, encoder-decoder and VLM), serving and training."""

from .model import Model  # noqa: F401
