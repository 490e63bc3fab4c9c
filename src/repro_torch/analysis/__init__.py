"""Static-analysis layer of the port: graph contracts over the operation
stream of a step, and an AST linter.

Port of the JAX package's ``analysis/``. Two passes, both driven by
``python -m repro_torch.analysis.check_graphs``:

* **Pass 1 -- graph contracts** (``contracts.py`` + ``graph_contracts.py``):
  every entrypoint the port's perf story depends on (the grouped and
  fused ``train_step``, ``begin_step``, serving ``prefill_commit`` /
  ``prefill_commit_batch`` / ``serve_step_lanes`` / its GDC form) runs
  once under ``roofline.op_cost.OpTrace`` and its stream of ATen
  operations is held to a declarative ``GraphContract``: zero restacks,
  the pools written in place, no device-to-host read, counted uploads, a
  dtype allowlist (never float64), and ceilings on collective and memory
  bytes.
* **Pass 2 -- AST lint** (``astlint.py``): the port's torch pitfalls in
  the source itself: host and global RNG, PRNGKey literal reuse, host
  syncs in hot paths, scalar divisions that round unlike the kernels,
  mutable defaults in config dataclasses, tensors made at import.
"""
from .astlint import LintFinding, run_lint
from .contracts import ContractResult, GraphContract, check_trace

__all__ = ["GraphContract", "ContractResult", "check_trace", "LintFinding",
           "run_lint"]
