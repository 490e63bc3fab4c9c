"""Models of the port (the paper's FCN so far)."""
from . import convnets  # noqa: F401
