"""Checkpoints in the JAX package's layout v4 (port of ``repro.checkpoint``)."""
from .ckpt import latest_step, read_manifest, restore, save  # noqa: F401
