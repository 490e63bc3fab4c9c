"""Distribution substrate of the port: sharding rules and local shards,
the int8 compressed all-reduce, fault handling, and the process-group
runtime that stands in for JAX's multi-device programs."""
from . import compression, fault, runtime, sharding  # noqa: F401
