"""Model code for the dense decoder family (the serving path)."""

from .model import Model  # noqa: F401
