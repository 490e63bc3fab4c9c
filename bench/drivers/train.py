"""The training loop the benchmark's training mixes drive.

It is the training CLI's loop (``repro_torch.launch.train.main``): the
CLI's trainer (``launch.train.make_trainer``: E-RIDER on every analog
leaf, bf16 tile state, hash noise, device parameters redrawn from seeds,
SGD-momentum with clipping on the digital leaves), its donated step
``AnalogTrainer.jit_step()``, batches through ``repro_torch.data.
Prefetcher``, and a ``torch.cuda.synchronize`` after every step. Nothing
is logged or checkpointed. It is a closed loop: a step starts when the last
one has ended.

Set-up makes the weights and the key from the seed (``bench.weights``),
builds the trainer and its state, and runs the first two steps through
the window's own call and feed. Those warm every shape the window uses,
and the benchmark reads from them what ``bench.checks`` compares. The
window then runs steps for ``seconds``; with ``trace``, ``trace_steps``
more steps run under ``torch.profiler`` once it has closed, so the window
is the same in both kinds of run. Afterwards the peak
memory is read, the program's state is freed and the plain reference
(``bench.reference.follow``) runs the same two steps from the same seed.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict

import torch

from .. import checks, generate, trace as btrace, weights

CHECKED_STEPS = 2


def cut_depth(cfg, layers: int):
    """``cfg`` with its depth cut to ``layers``: one repeated period, no
    prefix or tail, cut by its periods."""
    if layers == cfg.n_layers:
        return cfg
    if cfg.tail or cfg.first_dense_layers or layers % len(cfg.pattern):
        raise ValueError(f"cannot cut {cfg.name} to {layers} layers")
    return dataclasses.replace(cfg, n_layers=layers,
                               n_periods=layers // len(cfg.pattern))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, path + "/"))
        elif v is not None:
            out[path] = v
    return out


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().to(torch.float32),
                                          dtype=torch.float64))


def _program(config: Dict, device):
    """(model, trainer) of the configuration, as the training CLI builds
    them."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.lm import LM

    plan = config["plan"]
    cfg = cut_depth(get_config(config["arch"], smoke=config.get("smoke", False)),
                    config["model"]["n_layers"])
    model = LM(cfg)
    trainer = train.make_trainer(model, plan["algorithm"],
                                 plan["tiles"] == "smoke",
                                 plan["schedule_steps"], plan["lr"])
    return model, trainer


def _first_norms(state) -> Dict[str, float]:
    """Per leaf, the norm of what its optimizer holds after step 1."""
    mu = _flat(state["opt"]["mu"])
    tiles = state["tiles"]
    return {**{p: _norm(m) for p, m in mu.items()},
            **{p: _norm(tiles[p]["P"]) for p in tiles}}


def _change_norms(state, config: Dict, seed: int, device) -> Dict[str, float]:
    """Per leaf, the norm of its change since the weights of the seed: a
    digital parameter's, or a tile's P, W, Q and Q~ together (its W from
    the start worked out from the seed and the tile's scale). One leaf's
    start is made at a time."""
    index = {leaf["path"]: (i, leaf) for i, leaf in enumerate(config["params"])}
    out = {}
    for p, t in _flat(state["params"]).items():
        i, leaf = index[p]
        out[p] = _norm(t.to(torch.float32)
                       - weights.make_leaf(leaf, i, seed, device).float())
    tiles = state["tiles"]
    for p in tiles:
        ts = tiles[p]
        i, leaf = index[p]
        w0 = weights.make_leaf(leaf, i, seed, device)
        start = (w0.to(torch.float32) / ts["scale"]).to(ts["W"].dtype)
        del w0
        parts = [ts["P"], ts["W"].float() - start.float(), ts["Qd"], ts["Qt"]]
        out[p] = math.sqrt(sum(_norm(a) ** 2 for a in parts))
    return out


def run(ctx) -> Dict:
    """One run of a training cell; see the module docstring. ``ctx``:
    ``config``, ``mix``, ``cell``, ``seed``, ``seconds``, ``trace``,
    ``device`` and ``t0`` (the run's start, ``time.perf_counter``)."""
    from repro_torch.data import Prefetcher

    from ..reference import follow

    config, mix, seed, device = ctx.config, ctx.mix, ctx.seed, ctx.device
    cuda = torch.device(device).type == "cuda"
    vocab = config["model"]["vocab"]
    model, trainer = _program(config, device)
    key = torch.tensor(weights.key_words(seed), dtype=torch.int64)
    params = weights.nest(weights.make(config, seed, device))
    state = trainer.init(key, params)
    del params
    step_fn = trainer.jit_step()

    def producer(step):
        return generate.train_batch(mix, vocab, seed, step)

    prefetch = Prefetcher(producer, device=device)
    it = iter(prefetch)
    prog = {"loss": []}
    waits, steps, window_s, rec_trace, recorder = [], 0, 0.0, None, None

    def one_step():
        nonlocal state
        tw = time.perf_counter()
        with torch.profiler.record_function("bench/next_batch"):
            batch = next(it)
        waits.append(time.perf_counter() - tw)
        with torch.profiler.record_function("bench/step"):
            state, metrics = step_fn(state, batch)
        if cuda:
            with torch.profiler.record_function("bench/synchronize"):
                torch.cuda.synchronize()
        return metrics

    try:
        for k in range(CHECKED_STEPS):
            metrics = one_step()
            prog["loss"].append(float(metrics["loss"]))
            if k == 0:
                prog["first"] = _first_norms(state)
        prog["change"] = _change_norms(state, config, seed, device)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - ctx.t0
        waits.clear()
        start = time.perf_counter()
        while time.perf_counter() - start < ctx.seconds or steps == 0:
            one_step()
            steps += 1
        window_s = time.perf_counter() - start
        window_waits = list(waits)
        recorder = btrace.Recorder(cuda) if ctx.trace else None
        if recorder is not None:
            with recorder:
                for _ in range(mix["trace_steps"]):
                    one_step()
    finally:
        prefetch.close()
    if recorder is not None:
        rec_trace = recorder.summary(mix["trace_steps"])
        del recorder
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    analog = set(state["tiles"].paths())
    del state, trainer, model, step_fn, it, prefetch
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = follow.follow(config, mix, seed, device, steps=CHECKED_STEPS)
    reference_s = time.perf_counter() - t_ref
    worst = {}
    values = checks.gaps(prog, ref, analog, worst)
    tokens = mix["batch"] * mix["seq"]
    return {
        "attempted": steps, "failed": 0,
        "e2e": {"train_tokens_per_s": steps * tokens / window_s,
                "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        "peak_bytes": peak,
        "record": {"trace": rec_trace, "data_wait_s": window_waits,
                   "steps": steps, "window_s": window_s},
        "values": values,
        "info": {"setup_s": setup_s, "reference_s": reference_s,
                 "worst_leaf": worst},
    }

