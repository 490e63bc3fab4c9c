"""The port's continuous engine over every decoder-only arch against its
fixed driver and the JAX package's, on the CPU.

The reference's ``tests/test_serving_engine.py`` cases replayed on the
port: the continuous engine gives the fixed driver's tokens for the
other families (minicpm3-4b's MLA latent rows, mamba2-2.7b's SSD state,
recurrentgemma-9b's RG-LRU state beside sliding-window attention), and on
all 9 decoder-only smoke archs, with prefix sharing and chunked prefill
requested, the port's continuous engine == the port's fixed driver ==
the JAX fixed driver, token for token, on the JAX package's parameters
(``convert.params``). Also: SSD prompts chunked at ``ssm_chunk`` (the
state carried across a chunk), and the gates that keep RG-LRU rows
unpadded and unchunked.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.launch.serve import build_workload as jbuild  # noqa: E402
from repro.launch.serve import run_fixed as jrun_fixed  # noqa: E402
from test_torch_serve_engine import (SHARE, _assert_identical, _ecfg,  # noqa: E402
                                     _params, _serve_both)

from repro_torch.launch.serve import build_workload, run_fixed  # noqa: E402
from repro_torch.serving import EngineConfig, ServeEngine  # noqa: E402

DECODER_ARCHS = ["qwen2-0.5b", "qwen3-14b", "gemma3-4b", "minicpm3-4b",
                 "mixtral-8x7b", "deepseek-v2-236b", "mamba2-2.7b",
                 "recurrentgemma-9b", "qwen2-vl-2b"]
PS = 4


@pytest.mark.parametrize("arch", ["minicpm3-4b", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
def test_continuous_matches_fixed_other_families(arch):
    _assert_identical(*_serve_both(arch))


def _three_ways(arch, requests, prompt_len, gen, gen_spread=0, prefix_len=0,
                **engine_kw):
    """(port continuous, port fixed, JAX fixed) tokens on the JAX package's
    parameters, and the engine."""
    model, params, jm, jp = _params(arch, jax_params=True)
    kw = dict(gen_spread=gen_spread, prefix_len=prefix_len)
    workload = build_workload(model.cfg, requests, prompt_len, gen, **kw)
    want = jrun_fixed(jm, jp, jbuild(jm.cfg, requests, prompt_len, gen, **kw),
                      batch=requests)
    fixed = run_fixed(model, params, [r.clone() for r in workload],
                      batch=requests)
    engine = ServeEngine(model, params, EngineConfig(**_ecfg(
        workload, prompt_len=prompt_len, **engine_kw)))
    cont, _ = engine.run(workload)
    return cont, fixed, want, engine


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_continuous_matches_fixed_and_jax_fixed(arch):
    """The reference's sharing-and-chunking case on every decoder-only
    arch: the engine gates each feature to the families where it is exact,
    and the streams stay identical either way."""
    kw = dict(SHARE)
    cont, fixed, want, engine = _three_ways(arch, **kw)
    _assert_identical(fixed, cont)
    _assert_identical(want, fixed)
    kinds = set(engine.model.cfg.layer_kinds)
    assert engine._share == (kinds <= {"attn", "attn_local"})
    assert engine._pad_ok == ("rec" not in kinds)


def test_ssm_chunked_prefill_carries_the_state():
    """mamba2 with 24-token prompts in chunks of 16 (= ``ssm_chunk``, a
    multiple of the page): the engine chunks, and its streams equal both
    fixed drivers'."""
    cont, fixed, want, engine = _three_ways(
        "mamba2-2.7b", requests=5, prompt_len=24, gen=4, gen_spread=2,
        lanes=2, page_size=PS, extra_pages=0, prefill_chunk=16)
    assert engine._chunk == 16
    assert engine.telemetry.chunks > engine.telemetry.prefills
    _assert_identical(fixed, cont)
    _assert_identical(want, fixed)


def test_rec_rows_are_neither_padded_nor_chunked():
    """recurrentgemma with chunking requested: every prefill bucket is an
    exact prompt length, no prompt is split."""
    cont, fixed, want, engine = _three_ways(
        "recurrentgemma-9b", requests=4, prompt_len=7, gen=3, gen_spread=1,
        lanes=2, page_size=PS, extra_pages=0, prefill_chunk=8)
    assert engine._chunk == 0 and not engine._pad_ok
    assert {cb for cb, _, _ in engine.prefill_signatures} == {7}
    _assert_identical(fixed, cont)
    _assert_identical(want, fixed)
