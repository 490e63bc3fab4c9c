"""ServeEngine: continuous batching over the paged analog decode caches.

Port of the JAX package's ``serving/engine.py``. Admissions are grouped
into power-of-two length buckets and run through one
``prefill_commit_batch`` call per bucket per step: a multi-lane masked
prefill that scatters each row's K/V straight into its pages. Long prompts
are split into ``prefill_chunk``-sized chunks interleaved with decode
steps. With ``prefix_share`` on, admissions whose leading full prompt pages
hash-hit the ``PrefixCache`` map those table-row entries at shared
(refcounted, read-only) pages and only prefill the unshared tail.

Decode runs one ``serve_step_lanes`` per engine step across all lanes,
every lane at its own position, free and mid-chunk lanes pointed at the
scratch page, so a freed lane admits the oldest waiting prefill on the next
step without reshaping anything.

Where the reference jits two closures (the bucketed prefill and the decode
step), the port runs them as plain methods (``_prefill_call``,
``_step_call``) on the device of the served parameters. The paged pools are
updated in place. The host reads the device at the reference's points
only: once per prefill bucket and once per decode step (one ``.cpu()``
each, for the sampled tokens), so TTFT and TPOT time the card. The packed
lane state, (lanes, T+4) int32 (``[table row | pos | last | seed |
live]``), stays on the device between admissions and is advanced there in
place.

The engine serves the *effective* analog weights: ``load_effective_params``
restores a training checkpoint into an abstract template and merges tile
state per TilePolicy, then optionally ages the conductances and applies
Global Drift Compensation (the paper's deployment story).

Every decoder-only arch is served: page-pool attention layers, MLA
latent rows and RG-LRU / SSD state, each family with the reference's
gates (no padding or chunking of rec rows, SSD chunks aligned to
``ssm_chunk``, prefix sharing only for page-pool models). An
encoder-decoder raises, as in the reference: the fixed-batch driver
serves it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .kv_pages import PageAllocator, PrefixCache, SCRATCH_PAGE, needed_pages
from .sampling import lane_keys, sample_greedy, sample_topk
from .scheduler import ContinuousScheduler, DECODE, ServeRequest
from .telemetry import Telemetry


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    lanes: int = 8
    page_size: int = 16
    num_pages: int = 128          # shared pool per attention layer (incl. scratch)
    max_len: int = 256            # per-request prompt + generation bound
    stats_every: int = 0          # emit engine_stats every N steps (0 = off)
    log_path: str = ""            # JSON log lines (one object per line)
    manifest_path: str = ""       # run-artifact manifest written at shutdown
    prefill_chunk: int = 0        # split prompts into chunks of this many
                                  # tokens (0 = whole-prompt; page-size multiple)
    prefill_budget: int = 0       # max prefill tokens dispatched per step
                                  # (0 = unlimited) — caps decode jitter when
                                  # many lanes are mid-chunk at once
    prefix_share: bool = False    # CoW prompt-prefix page sharing
    temperature: float = 0.0      # 0 = greedy (the identity-test default)
    top_k: int = 0                # 0 = no top-k filter

    @property
    def table_width(self) -> int:
        return needed_pages(self.max_len, self.page_size)


# the per-deployment lifetime RNG: drift exponents / read noise are frozen
# physical facts of one programmed array, so the key is a constant — two
# loads of the same checkpoint at the same age see the same conductances
_LIFETIME_KEY_SEED = 0xD81F7


def _drift_scale_summary(tiles, scales: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Per-scan-class min/mean/max of the per-matrix GDC scales — the
    compact form the serve manifest records."""
    pidx = dict(tiles.index)
    out: Dict[str, Dict[str, float]] = {}
    for cname, gnames in tiles.class_index:
        vals = [scales[p] for g in gnames for p in pidx[g] if p in scales]
        if vals:
            out[cname] = {"min": min(vals), "mean": sum(vals) / len(vals),
                          "max": max(vals)}
    return out


def load_effective_params(model, ckpt_dir: str, algorithm: str, smoke: bool,
                          *, age_s: float = 0.0, gdc: bool = False,
                          with_report: bool = False, device="cuda"):
    """Rebuild the training-time plan, restore the checkpoint into an
    abstract template on ``device`` (``AnalogTrainer.abstract_state``: no
    throwaway tile or optimizer state is allocated) and merge the effective
    analog weights.

    Lifetime: ``age_s`` ages every analog leaf to ``drift_t0 + age_s``
    under its own stack's ``device_w`` preset (``age_s == 0`` is
    bit-exact); ``gdc=True`` then applies Global Drift Compensation against
    the t0 signatures stored in the checkpoint manifest (recomputed from
    the unaged restore when the checkpoint predates them). With
    ``with_report=True`` returns ``(params, report)``, the manifest-shaped
    lifetime block."""
    from .. import prng
    from ..checkpoint import ckpt
    from ..core.digital_opt import DigitalOptConfig, ScheduleConfig
    from ..core.trainer import AnalogTrainer, TrainerConfig, merge_effective
    from ..launch.train import make_plan
    from ..lifetime import drift as ldrift
    from ..lifetime import gdc as lgdc

    plan = make_plan(algorithm, smoke)
    trainer = AnalogTrainer(
        model.loss,
        TrainerConfig(digital=DigitalOptConfig(kind="sgdm"),
                      schedule=ScheduleConfig(kind="constant", base_lr=0.0)),
        plan=plan)
    aparams = model.abstract_params(device)
    template = trainer.abstract_state(aparams, device)
    state = ckpt.restore(template, ckpt_dir)
    print(f"[serve] restored step {int(state['step'])} from "
          f"{ckpt_dir} | {trainer.describe_plan(aparams)}", flush=True)
    params = merge_effective(state["params"], state["tiles"], trainer.cfg.tile)
    report: Dict[str, Any] = {"age_s": float(age_s), "gdc": bool(gdc),
                              "t0_signature": "none", "drift_scale": {}}
    if age_s > 0.0 or gdc:
        tiles = state["tiles"]
        cfg_map = ldrift.lifetime_cfg_map(params, tiles,
                                          trainer.cfg.tile.device_w)
        sig0 = None
        if gdc:
            manifest = ckpt.read_manifest(ckpt_dir)
            sig0 = manifest.get("gdc_signatures")
            report["t0_signature"] = "checkpoint"
            if sig0:
                sig0 = {p: v for p, v in sig0.items() if p in cfg_map}
            if not sig0:
                # pre-lifetime checkpoint: the unaged restore IS the t0
                # state, so its signatures are the reference
                report["t0_signature"] = "recomputed"
                sig0 = {p: float(v) for p, v in lgdc.signature_tree(
                    params, tuple(sorted(cfg_map))).items()}
        if age_s > 0.0:
            params = ldrift.age_params(params, cfg_map, age_s,
                                       prng.PRNGKey(_LIFETIME_KEY_SEED))
        if gdc:
            params, scales = lgdc.correct_params(params, sig0)
            report["drift_scale"] = _drift_scale_summary(tiles, scales)
    if with_report:
        return params, report
    return params


def _pow2_ceil(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass
class _Segment:
    """One prefill work item: ``req``'s prompt tokens [start, start+length)
    going to ``lane``.  ``fresh`` marks the request's first segment (zero
    prior recurrent state)."""
    req: ServeRequest
    lane: int
    start: int
    length: int
    fresh: bool

    @property
    def final(self) -> bool:
        return self.start + self.length >= self.req.prompt_len


class ServeEngine:
    def __init__(self, model, params, ecfg: EngineConfig,
                 telemetry: Optional[Telemetry] = None, arch: str = "",
                 checkpoint: Optional[Dict[str, Any]] = None,
                 lifetime: Optional[Dict[str, Any]] = None):
        if model.cfg.is_encdec:
            raise NotImplementedError(
                "continuous batching supports decoder-only models; use the "
                "fixed-batch driver for enc-dec archs")
        self.model = model
        self.params = params
        self.ecfg = ecfg
        self.device = params["embed"].device
        self.arch = arch or model.cfg.name
        self.checkpoint = checkpoint or {"restored": False, "dir": "", "algorithm": ""}
        self.lifetime = lifetime          # load_effective_params report
        self.telemetry = telemetry or Telemetry(log_path=ecfg.log_path)

        # per-family capability gates (all off -> exact-length fresh batches)
        kinds = set(model.cfg.layer_kinds)
        # padding a rec row would re-associate the RG-LRU associative scan
        self._pad_ok = "rec" not in kinds
        chunk = int(ecfg.prefill_chunk)
        chunk_ok = (chunk > 0 and self._pad_ok
                    and chunk % ecfg.page_size == 0
                    and ("ssm" not in kinds or chunk % model.cfg.ssm_chunk == 0))
        self._chunk = chunk if chunk_ok else 0
        # shared pages only make sense for page-pool layers; MLA latents and
        # recurrent state are per lane and cannot be mapped read-only
        self._share = bool(ecfg.prefix_share) and kinds <= {"attn", "attn_local"}

        self.allocator = PageAllocator(ecfg.num_pages, reserved=1)
        self.prefix_cache = (PrefixCache(self.allocator, ecfg.page_size)
                             if self._share else None)
        self.scheduler = ContinuousScheduler(
            ecfg.lanes, self.allocator, ecfg.page_size, ecfg.table_width,
            prefix_cache=self.prefix_cache)

        self._paged = model.init_paged_cache(
            ecfg.lanes, ecfg.num_pages, ecfg.page_size, ecfg.max_len,
            device=self.device)
        self._temp, self._top_k = float(ecfg.temperature), int(ecfg.top_k)
        self.prefill_signatures: set = set()

        # host-side lane state, mirrored on the device between admissions so
        # steady-state decode re-uses the device block instead of
        # re-uploading; the named mirrors are views of one packed int32 block
        T = ecfg.table_width
        self._ls = np.zeros((ecfg.lanes, T + 4), np.int32)
        self._ls[:, :T] = SCRATCH_PAGE
        self._table = self._ls[:, :T]
        self._pos = self._ls[:, T]
        self._last = self._ls[:, T + 1:T + 2]
        self._seeds = self._ls[:, T + 2]
        self._live = self._ls[:, T + 3]
        self._dev: Optional[torch.Tensor] = None   # packed lane-state mirror
        self._dirty = True        # lane state changed since last upload
        self._cont: Dict[int, _Segment] = {}   # lane -> next pending chunk

    # ------------------------------------------------------- device calls
    def _prefill_call(self, packed: torch.Tensor, tw: int) -> torch.Tensor:
        """One bucketed prefill. ``packed`` (B, Cb+tw+5) int32 on the device,
        one host upload per call: [chunk tokens | table row | lane | start |
        length | fresh | seed]. ``tw`` is the pow2 page-span bucket: only
        the table columns the chunk can reach ride along, so the paged
        attention gathers tw*page_size rows instead of the full width.
        Returns the sampled tokens (B, 1) on the device."""
        Cb = packed.shape[1] - tw - 5
        tokens = packed[:, :Cb]
        tables = packed[:, Cb:Cb + tw]
        lanes, starts = packed[:, Cb + tw], packed[:, Cb + tw + 1]
        lengths = packed[:, Cb + tw + 2]
        fresh = packed[:, Cb + tw + 3] != 0
        seeds = packed[:, Cb + tw + 4]
        logits, _ = self.model.prefill_commit_batch(
            self.params, tokens, self._paged, tables, lanes, starts, lengths,
            fresh)
        if self._temp > 0.0:
            return sample_topk(logits, self._temp, self._top_k,
                               lane_keys(seeds, starts + lengths))
        return sample_greedy(logits)

    def _step_call(self, state: torch.Tensor) -> torch.Tensor:
        """One decode step over every lane; ``state`` (lanes, T+4) int32 on
        the device is advanced in place (pos + 1, last = the sampled token).
        Free and mid-chunk lanes drift past their all-scratch table rows,
        which is harmless: their page writes land on the scratch page,
        ``live`` keeps their latent and state rows, and their outputs are
        discarded."""
        T = self.ecfg.table_width
        table, pos = state[:, :T], state[:, T]
        last, seeds = state[:, T + 1:T + 2], state[:, T + 2]
        live = state[:, T + 3] != 0
        if self._temp > 0.0:
            logits, _ = self.model.decode_step_lanes(
                self.params, last, self._paged, table, pos, live)
            toks = sample_topk(logits, self._temp, self._top_k,
                               lane_keys(seeds, pos + 1))
        else:
            toks, _ = self.model.serve_step_lanes(
                self.params, last, self._paged, table, pos, live)
        state[:, T] += 1
        state[:, T + 1] = toks[:, 0]
        return toks

    # ----------------------------------------------------------------- run
    def submit(self, req: ServeRequest) -> None:
        self.scheduler.submit(req)
        self.telemetry.request_submitted(req.request_id, req.prompt_len,
                                         req.max_new_tokens, req.arrival_step)

    def _finish(self, lane: int, step: int) -> None:
        req = self.scheduler.release(lane)
        self.telemetry.request_finished(req.request_id, lane, step)
        self._table[lane] = SCRATCH_PAGE
        self._pos[lane] = 0
        self._last[lane] = 0
        self._seeds[lane] = 0
        self._live[lane] = False
        self._dirty = True

    # ------------------------------------------------------------- prefill
    def _len_bucket(self, n: int) -> int:
        return _pow2_ceil(n) if self._pad_ok else n

    def _segment(self, req: ServeRequest, lane: int, start: int,
                 fresh: bool) -> _Segment:
        remaining = req.prompt_len - start
        seg = min(self._chunk, remaining) if self._chunk else remaining
        return _Segment(req, lane, start, seg, fresh)

    def _gather_segments(self, step: int) -> List[_Segment]:
        """This step's prefill work: pending chunk continuations first (one
        chunk per lane per step), then fresh admissions.  A prefill token
        budget (``ecfg.prefill_budget``) bounds the work batched into one
        step — continuations past it wait, admissions past it defer — so a
        pile-up of mid-chunk lanes cannot stretch every decode interval."""
        budget = (self.ecfg.prefill_budget or None) if self._chunk else None
        work: List[_Segment] = []
        for lane in sorted(self._cont):
            seg = self._cont[lane]
            if budget is not None and work and budget < seg.length:
                break
            del self._cont[lane]
            if budget is not None:
                budget -= seg.length
            work.append(seg)
        limit = None
        if budget is not None:
            limit = max(0, budget) // self._chunk
            if not work and limit == 0:
                limit = 1      # keep making progress even on a tiny budget
            if limit == 0:
                return work
        for adm in self.scheduler.admit(step, limit):
            req, lane = adm.request, adm.lane
            n_chunks = (1 if not self._chunk else
                        -(-(req.prompt_len - len(adm.shared_pages)
                            * self.ecfg.page_size) // self._chunk))
            self.telemetry.request_admitted(
                req.request_id, lane, len(adm.pages), step,
                shared_pages=len(adm.shared_pages), chunks=n_chunks)
            start = len(adm.shared_pages) * self.ecfg.page_size
            work.append(self._segment(req, lane, start, True))
        return work

    def _dispatch_group(self, Cb: int, items: List[_Segment], step: int):
        """Pad ``items`` to a power-of-two batch by repeating item 0 (the
        repeated rows compute and scatter the same values into the same
        slots) and run one prefill call."""
        Bb = _pow2_ceil(len(items))
        rows = items + [items[0]] * (Bb - len(items))
        ps, T = self.ecfg.page_size, self.ecfg.table_width
        span = max(-(-(seg.start + seg.length) // ps) for seg in items)
        tw = min(T, _pow2_ceil(span))
        packed = np.zeros((Bb, Cb + tw + 5), np.int32)
        for i, seg in enumerate(rows):
            packed[i, :seg.length] = seg.req.prompt[seg.start:seg.start + seg.length]
            packed[i, Cb:Cb + tw] = self.scheduler.table_row(seg.req)[:tw]
            packed[i, Cb + tw] = seg.lane
            packed[i, Cb + tw + 1] = seg.start
            packed[i, Cb + tw + 2] = seg.length
            packed[i, Cb + tw + 3] = int(seg.fresh)
            packed[i, Cb + tw + 4] = seg.req.seed
        sig = (Cb, Bb, tw)
        if sig not in self.prefill_signatures:
            self.prefill_signatures.add(sig)
            self.telemetry.retraces += 1
        tok = self._prefill_call(torch.from_numpy(packed).to(self.device), tw)
        self.telemetry.prefill_batches += 1
        self.telemetry.prefill_batch(step, Cb, len(items))
        return tok

    def _admit_and_prefill(self, step: int) -> None:
        work = self._gather_segments(step)
        if not work:
            return
        groups: Dict[int, List[_Segment]] = {}
        for seg in work:
            groups.setdefault(self._len_bucket(seg.length), []).append(seg)
        # dispatch every bucket, then read the tokens back once per bucket
        pending = [(Cb, items, self._dispatch_group(Cb, items, step))
                   for Cb, items in sorted(groups.items())]
        for _, items, tok in pending:
            host = tok.cpu().numpy()
            for i, seg in enumerate(items):
                self.telemetry.chunks += 1
                req, lane = seg.req, seg.lane
                if not seg.final:
                    self._cont[lane] = self._segment(
                        req, lane, seg.start + seg.length, False)
                    continue
                first = int(host[i, 0])
                req.tokens.append(first)
                req.state = DECODE
                self.telemetry.prefills += 1
                self.telemetry.first_token(req.request_id)
                if self._share:
                    self.scheduler.publish_prefix(req)
                self._table[lane] = self.scheduler.table_row(req)
                self._pos[lane] = req.prompt_len
                self._last[lane, 0] = first
                self._seeds[lane] = req.seed
                self._live[lane] = True
                self._dirty = True
                if len(req.tokens) >= req.max_new_tokens:
                    self._finish(lane, step)

    # -------------------------------------------------------------- decode
    def _decode_once(self, step: int) -> None:
        active = self.scheduler.active()
        decoding = {l: r for l, r in active.items() if r.state == DECODE}
        if not decoding:
            return
        if self._dirty:
            self._dev = torch.from_numpy(self._ls.copy()).to(self.device)
            self._dirty = False
        toks = self._step_call(self._dev)
        host_toks = toks.cpu().numpy()
        self.telemetry.steps += 1
        for lane, req in decoding.items():
            tok = int(host_toks[lane, 0])
            req.tokens.append(tok)
            self.telemetry.token(req.request_id)
            self._pos[lane] += 1
            self._last[lane, 0] = tok
            if len(req.tokens) >= req.max_new_tokens:
                self._finish(lane, step)

    @torch.no_grad()
    def run(self, requests: List[ServeRequest]) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Serve ``requests`` to completion; returns ({request_id: generated
        tokens}, run summary).  Writes the manifest at shutdown when
        configured."""
        t0 = time.monotonic()
        for req in requests:
            self.submit(req)
        step = 0
        while self.scheduler.has_work():
            self._admit_and_prefill(step)
            self._decode_once(step)
            if self.ecfg.stats_every and step % self.ecfg.stats_every == 0:
                self.telemetry.engine_stats(step, self.scheduler.n_active,
                                            self.scheduler.n_waiting,
                                            self.allocator.free_pages)
            step += 1
        wall = time.monotonic() - t0
        summary = self.telemetry.run_summary(wall, extras=self._run_extras())
        self.shutdown(wall)
        return ({r.request_id: np.asarray(r.tokens, np.int32) for r in requests},
                summary)

    def _run_extras(self) -> Dict[str, Any]:
        ex: Dict[str, Any] = {
            "prefill_batches": self.telemetry.prefill_batches,
            "prefill_chunks": self.telemetry.chunks,
            "retraces": self.telemetry.retraces,
        }
        if self.prefix_cache is not None:
            probes = self.prefix_cache.hits + self.prefix_cache.misses
            ex["prefix_hit_rate"] = (self.prefix_cache.hits / probes
                                     if probes else 0.0)
        return ex

    # ------------------------------------------------------------ shutdown
    def manifest_meta(self) -> Dict[str, Any]:
        e = self.ecfg
        return {"mode": "continuous", "lanes": e.lanes, "page_size": e.page_size,
                "num_pages": e.num_pages, "table_width": e.table_width,
                "prefill_chunk": self._chunk,
                "prefill_budget": int(e.prefill_budget) if self._chunk else 0,
                "prefix_share": self._share,
                "temperature": float(e.temperature), "top_k": int(e.top_k)}

    def shutdown(self, wall_s: float, status: str = "completed") -> Optional[Dict]:
        if self.prefix_cache is not None:
            self.prefix_cache.check_consistent()
        manifest = None
        if self.ecfg.manifest_path:
            manifest = self.telemetry.write_manifest(
                self.ecfg.manifest_path, arch=self.arch,
                engine=self.manifest_meta(), checkpoint=self.checkpoint,
                wall_s=wall_s, status=status, lifetime=self.lifetime)
        self.telemetry.close()
        return manifest
