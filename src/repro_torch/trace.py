"""Named spans on the training path, for ``torch.profiler``.

``with span("train/update"):`` opens ``torch.profiler.record_function``
only while a profiler records. Otherwise it returns one shared no-op, so
with tracing off a span calls no dispatcher op and allocates nothing: the
profiler being on is the switch. A span is one of the profiler's own host
events, on the clock of its device trace; nothing here reads a clock or
exports anything.

The spans and where they open:

* ``train/step`` (args: the step index) around ``AnalogTrainer._step``,
  and inside it its phases ``train/begin`` (``begin_step`` of every
  tile), ``train/merge`` (the effective weights), ``train/fwd_bwd`` (every
  microbatch's value and gradients), ``train/digital`` (the digital
  optimizer with clipping) and ``train/update`` (the analog gradients
  stacked, the pulse updates and the ``tile/*`` metrics);
* ``model/attn``, ``model/ssm`` and ``model/mlp`` around a layer's mixer
  and MLP in mode ``fwd`` (``models.blocks.apply_layer``), opened again by
  the recompute of ``cfg.remat`` on the thread that runs backward, and
  ``model/head_loss`` around ``LM.loss``'s final norm, logits and loss;
* ``prng/split`` and ``prng/fold_in``: the host key chain (the trainer's
  path-keyed folds go through ``fold_in``);
* ``data/wait`` and ``data/place``: ``data.Prefetcher.__next__``'s queue
  get and its copy to the device.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Union

import torch

_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[Union[str, Callable[[], str]]] = None):
    """A context manager: ``record_function(name, args)`` while a profiler
    records, else a shared no-op. ``args`` may be a callable, called only
    while a profiler records (a host read kept off the untraced path)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if callable(args):
        args = args()
    return torch.profiler.record_function(name, args)
