"""Model code for the dense decoder family (serving and training) and the
SSM family (Mamba2, serving)."""

from .model import Model  # noqa: F401
