"""Deterministic synthetic datasets (numpy) and the host prefetch pipeline."""
from .pipeline import Prefetcher  # noqa: F401
from .synthetic import BigramLM, ImageDataset, procedural_images  # noqa: F401
