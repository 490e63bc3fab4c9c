"""Deterministic synthetic datasets (numpy)."""
from .synthetic import ImageDataset, procedural_images  # noqa: F401
