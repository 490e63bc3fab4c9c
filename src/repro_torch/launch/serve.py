"""Serving driver CLI: continuous-batching decode over analog weights.

Port of the JAX package's ``launch/serve.py``, with the same flags and the
same ``[serve] ...`` lines, plus
  ``--device``      default ``cuda``; ``cpu`` serves on the host;
  ``--data-vocab``  the token ids the synthetic prompts are drawn from
                    (default: the model's vocab). ``BigramLM`` draws a
                    (V, V) float64 table, 185 GB at Qwen2's 151936 ids, so
                    a full-width run takes a smaller stream (8192 ids).

Two engines over the same workload:

  --engine continuous (default) — the ``repro_torch.serving`` engine:
      paged KV cache (fixed-size pages, per-request alloc/free,
      scratch-page lanes), per-step admission of waiting prefills into
      freed decode lanes, per-request TTFT/TPOT latency percentiles,
      structured JSON logs and a shutdown run manifest.
  --engine fixed — the fixed-decode-batch loop (the baseline): batches of
      ``--batch`` requests prefill together and decode in lockstep for the
      longest generation in the batch.

With ``--ckpt-dir`` the CLI restores an analog training state written
by ``repro_torch.launch.train`` (or the JAX package's CLI: the layout is
shared; ``--algorithm`` must name the same plan) and serves the effective
analog weights, optionally aged (``--age``) and drift-compensated
(``--gdc on``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --smoke --requests 16 --prompt-len 32 --gen 32 --device cpu \\
      [--ckpt-dir /tmp/ckpt --algorithm erider --age 1yr --gdc on] \\
      [--log-json serve_log.jsonl --manifest serve_manifest.json]
"""
from __future__ import annotations

import argparse
import json
import re
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import prng
from ..configs import ARCHS, get_config
from ..configs.serving import serve_defaults
from ..data import BigramLM
from ..models.lm import LM
from ..serving import (EngineConfig, FeedBuilder, ServeEngine, ServeRequest,
                       Telemetry, load_effective_params, sample_greedy)

# --age suffixes, in seconds (month = Julian year / 12)
AGE_UNITS = {"s": 1.0, "min": 60.0, "h": 3600.0, "d": 86400.0,
             "mo": 2629800.0, "yr": 31557600.0}


def parse_age(text: str) -> float:
    """'0', '90', '5min', '1h', '1d', '1mo', '1yr' -> seconds since the
    checkpoint was programmed (t0)."""
    m = re.fullmatch(r"\s*([0-9]*\.?[0-9]+)\s*([a-z]*)\s*", str(text))
    if not m or (m.group(2) and m.group(2) not in AGE_UNITS):
        raise ValueError(
            f"bad --age {text!r}: expected <number>[{'|'.join(AGE_UNITS)}]")
    return float(m.group(1)) * AGE_UNITS.get(m.group(2) or "s")


def build_workload(cfg, requests: int, prompt_len: int, gen: int, seed: int = 3,
                   gen_spread: int = 0, arrival_every: int = 0,
                   prefix_len: int = 0, data_vocab: int = 0) -> List[ServeRequest]:
    """Deterministic request trace: both engines consume the same prompts.

    ``gen_spread`` alternates short/long generations around ``--gen``
    (mixed-length trace); ``arrival_every`` staggers arrivals one request
    every N engine steps (mixed-arrival trace — the fixed driver ignores
    arrivals, an oracle assumption in its favor); ``prefix_len`` gives every
    prompt a common leading run of that many tokens (shared-prefix trace —
    a system prompt — which ``--prefix-share`` turns into CoW page hits);
    ``data_vocab`` draws the prompts from the first N token ids (0: the
    model's vocab, the reference's trace)."""
    vocab = data_vocab or cfg.vocab
    if not 0 < vocab <= cfg.vocab:
        raise ValueError(f"--data-vocab {vocab} outside (0, {cfg.vocab}]")
    data = BigramLM(vocab=vocab, seed=seed)
    prefix = None
    if prefix_len:
        if prefix_len >= prompt_len:
            raise ValueError(f"prefix_len={prefix_len} must be < prompt_len={prompt_len}")
        prefix = data.batch(10_000, 1, prefix_len)["tokens"][0].astype(np.int32)
    out = []
    for i in range(requests):
        tail_len = prompt_len - (prefix_len if prefix is not None else 0)
        prompt = data.batch(i, 1, tail_len)["tokens"][0].astype(np.int32)
        if prefix is not None:
            prompt = np.concatenate([prefix, prompt])
        n = gen if not gen_spread else max(1, gen + (gen_spread if i % 2 else -gen_spread))
        out.append(ServeRequest(request_id=f"req{i:04d}", prompt=prompt,
                                max_new_tokens=n,
                                arrival_step=i * arrival_every, seed=i))
    return out


def make_fixed_fns(model: LM):
    """The (prefill, step) pair of ``run_fixed``: the reference jits them;
    the port calls the model's methods."""
    return model.prefill, model.serve_step


def run_fixed(model: LM, params, workload: List[ServeRequest], batch: int,
              telemetry: Optional[Telemetry] = None,
              fns=None) -> Dict[str, np.ndarray]:
    """The fixed-decode-batch loop: FIFO groups of ``batch`` requests
    prefill together and decode in lockstep until the longest generation in
    the group completes (shorter requests ride along as dead lanes). Runs
    on the device of ``params``; reads the tokens back once per step."""
    cfg = model.cfg
    device = params["embed"].device
    telemetry = telemetry or Telemetry()
    feed_builder = FeedBuilder(cfg, device)
    prefill, step = fns or make_fixed_fns(model)

    for req in workload:
        telemetry.request_submitted(req.request_id, req.prompt_len,
                                    req.max_new_tokens, req.arrival_step)
    results: Dict[str, np.ndarray] = {}
    for start in range(0, len(workload), batch):
        group = workload[start:start + batch]
        pad = batch - len(group)
        prompts = np.stack([r.prompt for r in group] + [group[0].prompt] * pad)
        S = prompts.shape[1]
        gen = max(r.max_new_tokens for r in group)
        cache = model.init_cache(batch, S + gen,
                                 enc_len=S if cfg.is_encdec else 0,
                                 device=device)
        logits, cache = prefill(params, feed_builder(prompts), cache)
        tok = sample_greedy(logits)
        out = [tok.cpu().numpy()]
        for r in group:
            telemetry.first_token(r.request_id)
        for i in range(gen - 1):
            tok, cache = step(params, tok, cache, S + i)
            out.append(tok.cpu().numpy())
            for r in group:
                if i + 2 <= r.max_new_tokens:
                    telemetry.token(r.request_id)
        seq = np.concatenate(out, axis=1)
        for lane, r in enumerate(group):
            results[r.request_id] = seq[lane, :r.max_new_tokens].astype(np.int32)
            telemetry.request_finished(r.request_id, lane, start // batch)
    return results


def main(argv=None):
    """Serve; returns ``(results, summary, engine)``: {request_id: tokens},
    the run summary line and the ``ServeEngine`` (None under ``--engine
    fixed``), for callers that drive the CLI in process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", choices=("continuous", "fixed"), default="continuous")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8,
                    help="decode batch of the fixed engine")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--gen-spread", type=int, default=0,
                    help="alternate gen +/- spread (mixed-length trace)")
    ap.add_argument("--arrival-every", type=int, default=0,
                    help="stagger arrivals every N engine steps")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="common prompt prefix length (shared-prefix trace)")
    ap.add_argument("--prefill-chunk", type=int, default=-1,
                    help="prefill chunk tokens (-1 = per-arch default, 0 = off)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="max prefill tokens per engine step (0 = unlimited; "
                         "chunked mode only — caps decode jitter)")
    ap.add_argument("--prefix-share", action="store_true",
                    help="copy-on-write prompt-prefix KV page sharing")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k filter for temperature sampling (0 = off)")
    ap.add_argument("--lanes", type=int, default=0,
                    help="decode lanes (0 = per-arch serving default)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV page size in tokens (0 = per-arch default)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="KV pool pages per layer (0 = sized from workload)")
    ap.add_argument("--ckpt-dir", default="",
                    help="serve effective analog weights from this "
                         "training checkpoint")
    ap.add_argument("--algorithm", default="erider",
                    help="plan of the checkpoint (see repro_torch.launch.train)")
    ap.add_argument("--age", default="0",
                    help="serve the checkpoint aged this long past t0 "
                         "(conductance drift + read noise): seconds or "
                         "<n>{s,min,h,d,mo,yr}, e.g. --age 1yr")
    ap.add_argument("--gdc", choices=("on", "off"), default="off",
                    help="Global Drift Compensation against the manifest's "
                         "t0 weight signatures")
    ap.add_argument("--log-json", default="", help="JSON log lines path")
    ap.add_argument("--manifest", default="", help="run manifest path")
    ap.add_argument("--dump-tokens", default="",
                    help="write {request_id: tokens} JSON (regression tests)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-vocab", type=int, default=0,
                    help="token ids of the prompt stream (default: the "
                         "model's vocab; its table takes 8 * V^2 host bytes)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = LM(cfg)
    age_s = parse_age(args.age)
    gdc_on = args.gdc == "on"
    lifetime = None
    if args.ckpt_dir:
        params, report = load_effective_params(
            model, args.ckpt_dir, args.algorithm, args.smoke,
            age_s=age_s, gdc=gdc_on, with_report=True, device=device)
        if age_s > 0 or gdc_on:
            lifetime = report
            print(f"[serve] lifetime: age={age_s:.0f}s gdc={args.gdc} "
                  f"t0_signature={report['t0_signature']}")
    else:
        if age_s > 0 or gdc_on:
            raise SystemExit("--age/--gdc require --ckpt-dir (lifetime "
                             "applies to deployed analog weights)")
        params = model.init(prng.PRNGKey(0), device)

    workload = build_workload(cfg, args.requests, args.prompt_len, args.gen,
                              gen_spread=args.gen_spread,
                              arrival_every=args.arrival_every,
                              prefix_len=args.prefix_len,
                              data_vocab=args.data_vocab)
    max_gen = max(r.max_new_tokens for r in workload)
    engine_mode = args.engine
    engine = None
    if engine_mode == "continuous" and cfg.is_encdec:
        print("[serve] enc-dec arch: falling back to the fixed-batch engine")
        engine_mode = "fixed"

    defaults = serve_defaults(cfg)
    t0 = time.monotonic()
    if engine_mode == "continuous":
        lanes = args.lanes or defaults.lanes
        page_size = args.page_size or defaults.page_size
        max_len = args.prompt_len + max_gen
        table_width = -(-max_len // page_size)
        num_pages = args.num_pages or (lanes * table_width + 1)
        chunk = (defaults.prefill_chunk if args.prefill_chunk < 0
                 else args.prefill_chunk)
        share = args.prefix_share or defaults.prefix_share
        ecfg = EngineConfig(lanes=lanes, page_size=page_size,
                            num_pages=num_pages, max_len=max_len,
                            log_path=args.log_json,
                            manifest_path=args.manifest,
                            prefill_chunk=chunk,
                            prefill_budget=args.prefill_budget,
                            prefix_share=share,
                            temperature=args.temperature, top_k=args.top_k)
        engine = ServeEngine(model, params, ecfg, arch=cfg.name,
                             checkpoint={"restored": bool(args.ckpt_dir),
                                         "dir": args.ckpt_dir,
                                         "algorithm": args.algorithm},
                             lifetime=lifetime)
        results, summary = engine.run(workload)
        lat = engine.telemetry.latency_summary()
        print(f"[serve] continuous: {summary['generated_tokens']} tokens in "
              f"{summary['wall_s']:.2f}s -> {summary['tokens_per_s']:.1f} tok/s | "
              f"ttft p50/p99 {lat['ttft']['p50'] * 1e3:.1f}/{lat['ttft']['p99'] * 1e3:.1f} ms | "
              f"tpot p50/p99 {lat['tpot']['p50'] * 1e3:.1f}/{lat['tpot']['p99'] * 1e3:.1f} ms")
    else:
        telemetry = Telemetry(log_path=args.log_json)
        results = run_fixed(model, params, workload, args.batch, telemetry)
        wall = time.monotonic() - t0
        summary = telemetry.run_summary(wall)
        if args.manifest:
            telemetry.write_manifest(
                args.manifest, arch=cfg.name,
                engine={"mode": "fixed", "lanes": args.batch,
                        "page_size": args.prompt_len + max_gen, "num_pages": 2,
                        "table_width": 1},
                checkpoint={"restored": bool(args.ckpt_dir),
                            "dir": args.ckpt_dir, "algorithm": args.algorithm},
                wall_s=wall, lifetime=lifetime)
        telemetry.close()
        print(f"[serve] fixed: {summary['generated_tokens']} tokens in "
              f"{summary['wall_s']:.2f}s -> {summary['tokens_per_s']:.1f} tok/s")

    if args.dump_tokens:
        with open(args.dump_tokens, "w") as f:
            json.dump({k: np.asarray(v).tolist() for k, v in results.items()},
                      f, sort_keys=True)
    first = workload[0].request_id
    print(f"[serve] {first} first tokens: {np.asarray(results[first])[:12]}")
    return results, summary, engine


if __name__ == "__main__":
    main()
