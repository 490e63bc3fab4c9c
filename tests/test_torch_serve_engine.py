"""The port's continuous-batching engine, fixed driver and sampling, on the
CPU, against themselves and against the JAX package.

* The reference's ``tests/test_serving_engine.py`` replayed on the port
  for the page-pool attention families (qwen2-0.5b, qwen3-14b, gemma3-4b,
  qwen2-vl-2b, mixtral-8x7b): the continuous engine gives the fixed
  driver's tokens, with lane reuse, prefix sharing and chunked prefill;
  the prefill signatures stay within log2(max_len); ``sample_greedy``,
  ``sample_topk`` and ``FeedBuilder`` keep their contracts.
* Against JAX, on the same parameters (``convert.params``): the port's
  fixed driver gives the JAX fixed driver's tokens; the port's engine
  with temperature / top-k sampling gives the JAX engine's tokens;
  ``lane_keys`` is bit-equal; ``prng.gumbel`` is within 2 float32 ULPs of
  ``max(|g|, 1)`` (the two ``log`` calls: XLA-CPU's differ from torch's by
  a few ULP, ROADMAP queue 3); ``sample_topk`` and ``prng.categorical``
  draw JAX's tokens on a seeded set of lanes.
* The engine raises ``NotImplementedError`` naming ROADMAP item 14b for
  the MLA, RG-LRU and SSD archs, and raises for the encoder-decoder.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch.serve import build_workload as jbuild  # noqa: E402
from repro.launch.serve import run_fixed as jrun_fixed  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.serving import lane_keys as jlane_keys  # noqa: E402
from repro.serving import sample_topk as jsample_topk  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import build_workload, run_fixed  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serving import (EngineConfig, FeedBuilder, ServeEngine,  # noqa: E402
                                 ServeRequest, lane_keys, sample_greedy,
                                 sample_topk)

PAGE_POOL = ["qwen2-0.5b", "qwen3-14b", "gemma3-4b", "qwen2-vl-2b",
             "mixtral-8x7b"]
SHARE = dict(requests=5, prompt_len=10, gen=4, gen_spread=2, lanes=2,
             page_size=4, prefix_len=8, extra_pages=4, prefill_chunk=8,
             prefix_share=True)


def _params(arch, jax_params=False):
    cfg = get_config(arch, smoke=True)
    model = LM(cfg)
    if not jax_params:
        return model, model.init(prng.PRNGKey(0), "cpu")
    jm = JLM(jget(arch, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    return model, convert.params(jax.tree.map(np.asarray, jp), "cpu"), jm, jp


def _ecfg(workload, lanes, page_size, extra_pages, prompt_len, **kw):
    max_len = prompt_len + max(r.max_new_tokens for r in workload)
    tw = -(-max_len // page_size)
    return dict(lanes=lanes, page_size=page_size,
                num_pages=lanes * tw + 1 + extra_pages, max_len=max_len, **kw)


def _serve_both(arch, requests=4, prompt_len=6, gen=4, gen_spread=0,
                lanes=2, page_size=4, prefix_len=0, extra_pages=0,
                **engine_kw):
    model, params = _params(arch)
    workload = build_workload(model.cfg, requests, prompt_len, gen,
                              gen_spread=gen_spread, prefix_len=prefix_len)
    fixed = run_fixed(model, params, [r.clone() for r in workload],
                      batch=requests)
    ecfg = EngineConfig(**_ecfg(workload, lanes, page_size, extra_pages,
                                prompt_len, **engine_kw))
    engine = ServeEngine(model, params, ecfg)
    cont, _ = engine.run(workload)
    return fixed, cont


def _assert_identical(fixed, cont):
    assert set(fixed) == set(cont)
    for rid in fixed:
        np.testing.assert_array_equal(fixed[rid], cont[rid], err_msg=rid)


def test_continuous_matches_fixed_dense_attn():
    _assert_identical(*_serve_both("qwen2-0.5b"))


def test_continuous_matches_fixed_mixed_gen_lane_reuse():
    fixed, cont = _serve_both("qwen2-0.5b", requests=6, gen=5, gen_spread=3,
                              lanes=2)
    lens = sorted(len(v) for v in cont.values())
    assert lens == [2, 2, 2, 8, 8, 8]
    _assert_identical(fixed, cont)


@pytest.mark.parametrize("arch", PAGE_POOL)
def test_continuous_matches_fixed_sharing_and_chunking(arch):
    _assert_identical(*_serve_both(arch, **SHARE))


def test_continuous_matches_fixed_past_the_window():
    """gemma3's 16-token window, prompts of 24 in 3 chunks of 8: the fixed
    driver's ring-buffer cache against the paged pools."""
    _assert_identical(*_serve_both("gemma3-4b", **dict(SHARE, prompt_len=24)))


def test_prefill_signature_count_bounded():
    model, params = _params("qwen2-0.5b")
    rng = np.random.RandomState(7)
    reqs = [ServeRequest(request_id=f"r{n:02d}",
                         prompt=rng.randint(0, model.cfg.vocab, size=n).astype(np.int32),
                         max_new_tokens=2, arrival_step=n - 1)
            for n in range(1, 33)]
    max_len = 64
    tw = -(-max_len // 4)
    engine = ServeEngine(model, params, EngineConfig(
        lanes=2, page_size=4, num_pages=2 * tw + 1, max_len=max_len))
    engine.run(reqs)
    assert len(engine.prefill_signatures) <= math.log2(max_len)


def test_engine_rejects_encdec():
    model = LM(get_config("seamless-m4t-large-v2", smoke=True))
    params = model.abstract_params("cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServeEngine(model, params, EngineConfig(lanes=2, num_pages=4, max_len=8))


@pytest.mark.parametrize("arch", ["minicpm3-4b", "mamba2-2.7b",
                                  "recurrentgemma-9b", "deepseek-v2-236b"])
def test_engine_raises_for_item_14b(arch):
    model = LM(get_config(arch, smoke=True))
    params = model.abstract_params("cpu")
    with pytest.raises(NotImplementedError, match="item 14b"):
        ServeEngine(model, params, EngineConfig(lanes=2, num_pages=4, max_len=8))
    with pytest.raises(NotImplementedError, match="item 14b"):
        model.init_paged_cache(2, 4, 4, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="item 14b"):
        model.init_cache(2, 8, device="cpu")


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PAGE_POOL)
def test_port_fixed_matches_jax_fixed(arch):
    model, params, jm, jp = _params(arch, jax_params=True)
    kw = dict(gen_spread=2, prefix_len=8)
    workload = build_workload(model.cfg, 5, 10, 4, **kw)
    jworkload = jbuild(jm.cfg, 5, 10, 4, **kw)
    want = jrun_fixed(jm, jp, jworkload, batch=5)
    got = run_fixed(model, params, workload, batch=5)
    _assert_identical(want, got)


def test_moe_prefill_dispatch_matches_jax():
    """mixtral's MoE past the gather path's 256 tokens: the fixed driver's
    5 x 64-token prefill and the engine's 64-token chunks over 5 lanes
    (padded to a batch of 8: 512 tokens) take the einsum dispatch, whose
    capacity slots see the padded rows; decode (5 tokens) takes the gather
    path. Both drivers give the JAX package's tokens."""
    model, params, jm, jp = _params("mixtral-8x7b", jax_params=True)
    assert model.cfg.moe_impl == "einsum"
    kw = dict(lanes=5, page_size=4, extra_pages=0, prompt_len=64,
              prefill_chunk=64)
    workload = build_workload(model.cfg, 5, 64, 3)
    jworkload = jbuild(jm.cfg, 5, 64, 3)
    _assert_identical(jrun_fixed(jm, jp, [r.clone() for r in jworkload], 5),
                      run_fixed(model, params, [r.clone() for r in workload], 5))
    want, _ = JServeEngine(jm, jp, JEngineConfig(**_ecfg(jworkload, **kw))).run(jworkload)
    got, _ = ServeEngine(model, params, EngineConfig(**_ecfg(workload, **kw))).run(workload)
    _assert_identical(want, got)


def test_sampling_engine_matches_jax_engine():
    """Temperature 5, top-k 20: every token drawn per lane from
    (seed, position) keys, through prefill and decode, both engines."""
    model, params, jm, jp = _params("qwen2-0.5b", jax_params=True)
    kw = dict(lanes=2, page_size=4, extra_pages=4, prompt_len=10,
              prefill_chunk=8, prefix_share=True, temperature=5.0, top_k=20)
    workload = build_workload(model.cfg, 5, 10, 6, gen_spread=2, prefix_len=8)
    jworkload = jbuild(jm.cfg, 5, 10, 6, gen_spread=2, prefix_len=8)
    want, _ = JServeEngine(jm, jp, JEngineConfig(**_ecfg(jworkload, **kw))).run(jworkload)
    got, _ = ServeEngine(model, params, EngineConfig(**_ecfg(workload, **kw))).run(workload)
    _assert_identical(want, got)
    # sampled, not greedy: some token differs from the greedy engine's
    greedy, _ = ServeEngine(model, params, EngineConfig(**_ecfg(
        workload, **dict(kw, temperature=0.0)))).run(
            [r.clone() for r in workload])
    assert any(not np.array_equal(greedy[k], got[k]) for k in got)


def test_lane_keys_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    seeds = rng.integers(-2 ** 31, 2 ** 31, size=64).astype(np.int32)
    pos = rng.integers(0, 1 << 20, size=64).astype(np.int32)
    want = np.asarray(jlane_keys(jnp.asarray(seeds), jnp.asarray(pos)))
    got = lane_keys(torch.from_numpy(seeds), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_gumbel_within_log_ulps_of_jax():
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (50000,)))(keys))
    got = prng.gumbel(prng.wrap_key_data(np.asarray(keys)), (50000,)).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert float((np.abs(got - want) / ulp).max()) <= 2.0
    assert (got == want).mean() > 0.5


@pytest.mark.parametrize("temperature, k", [(1.0, 0), (0.7, 5), (1.3, 50)])
def test_sample_topk_draws_jax_tokens(temperature, k):
    rng = np.random.default_rng(int(temperature * 10) + k)
    logits = (2.0 * rng.standard_normal((16, 3, 512))).astype(np.float32)
    seeds = np.arange(16, dtype=np.int32)
    pos = rng.integers(0, 100, size=16).astype(np.int32)
    want = np.asarray(jsample_topk(jnp.asarray(logits), temperature, k,
                                   jlane_keys(jnp.asarray(seeds),
                                              jnp.asarray(pos))))
    got = sample_topk(torch.from_numpy(logits), temperature, k,
                      lane_keys(torch.from_numpy(seeds), torch.from_numpy(pos)))
    assert got.dtype == torch.int32 and got.shape == (16, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    # categorical alone, on the scaled rows
    jk = jlane_keys(jnp.asarray(seeds), jnp.asarray(pos))
    want_c = np.asarray(jax.vmap(jax.random.categorical)(jk, logits[:, -1]))
    got_c = prng.categorical(lane_keys(torch.from_numpy(seeds),
                                       torch.from_numpy(pos)),
                             torch.from_numpy(logits[:, -1]))
    np.testing.assert_array_equal(got_c.numpy(), want_c)


# ---------------------------------------------------------------------------
# sampling / feed helpers (the reference's cases)
# ---------------------------------------------------------------------------


def test_sample_greedy_last_position_argmax():
    logits = torch.zeros((2, 3, 5))
    logits[0, -1, 4] = 9.0
    logits[1, -1, 2] = 9.0
    logits[0, 0, 1] = 99.0            # earlier positions must not matter
    tok = sample_greedy(logits)
    assert tok.shape == (2, 1)
    assert tok.dtype == torch.int32
    assert tok.tolist() == [[4], [2]]
    # ties go to the first maximal index, as jnp.argmax
    assert sample_greedy(torch.ones((1, 1, 7))).tolist() == [[0]]


def test_sample_topk_zero_temperature_is_greedy():
    logits = torch.zeros((2, 2, 8))
    logits[0, -1, 3] = 5.0
    logits[1, -1, 6] = 5.0
    logits[0, 0, 1] = 99.0
    keys = lane_keys(torch.tensor([0, 1]), torch.tensor([0, 0]))
    tok = sample_topk(logits, 0.0, 0, keys)
    assert tok.shape == (2, 1)
    assert tok.dtype == torch.int32
    assert tok.tolist() == [[3], [6]]


def test_sample_topk_support_and_determinism():
    logits = torch.tensor([[[0.0, 5.0, 4.9, 3.0, -2.0]]]).repeat(4, 1, 1)
    seeds = torch.arange(4)
    draws = [sample_topk(logits, 1.5, 2, lane_keys(seeds, torch.full((4,), p)))
             for p in range(50)]
    flat = torch.cat(draws).ravel().tolist()
    assert set(flat) == {1, 2}
    again = sample_topk(logits, 1.5, 2, lane_keys(seeds, torch.full((4,), 7)))
    assert torch.equal(again, draws[7])
    per_lane = torch.cat(draws, dim=1)                 # (4, 50)
    assert any(not torch.equal(per_lane[0], per_lane[i]) for i in (1, 2, 3))


def test_feed_builder_caches_frames_per_shape():
    cfg = get_config("seamless-m4t-large-v2", smoke=True)
    assert cfg.frontend
    fb = FeedBuilder(cfg, "cpu")
    toks = np.zeros((2, 4), np.int32)
    f1, f2 = fb(toks), fb(toks)
    assert f1["frames"] is f2["frames"]                # cached, not rebuilt
    assert tuple(f1["frames"].shape) == (2, 4, cfg.d_model)
    f3 = fb(np.zeros((1, 4), np.int32))
    assert f3["frames"].shape[0] == 1                  # new shape, new buffer
    assert f1["tokens"].dtype == torch.int32


def test_feed_builder_tokens_only_for_text_models():
    fb = FeedBuilder(get_config("qwen2-0.5b", smoke=True), "cpu")
    assert set(fb(np.zeros((1, 3), np.int32))) == {"tokens"}
