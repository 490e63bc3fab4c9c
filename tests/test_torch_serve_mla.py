"""The serve caches of the port's multi-head latent attention (MLA)
against the JAX package's, on the CPU.

The smoke configs of minicpm3-4b and deepseek-v2-236b, the MLA parameters
drawn by the JAX package (``init_mla``) and carried across with
``repro_torch.convert.params``, inputs and cache contents drawn from a
numpy seed. The same inputs feed both packages at every call.

* The fixed driver's dense latent cache: ``mla_prefill`` of a 10-token
  prompt, then 3 ``mla_decode`` steps.
* The engine's per-lane latent rows: ``mla_decode_lanes`` over three lanes
  whose rows hold earlier tokens, one of them at the row's last slot and
  one free lane at ``pos >= max_len`` (JAX drops its out-of-range write;
  the port writes the old value back at the clamped slot), with and
  without the idle-lane hold of ``blocks.apply_layer`` (``live``).
* ``commit_prefill_mla`` of a batch-1 dense cache into a lane, stacked
  (a leading period axis) and not.
* ``mla_chunk_lanes``, absorbed and expanded (the expanded also with an
  attention chunk shorter than the row): a first chunk into a reused lane
  whose row holds a previous occupant's stale slots, a chunk continuation,
  a padded tail clipped to the row's last slot, and a batch padded by
  repeating its row 0.

Outputs and float cache leaves within 2e-6 of the JAX array's largest
magnitude (float32; XLA-CPU and torch sum in other orders), the position
rows bit-equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from test_torch_models import _close, _t  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention  # noqa: E402

MLA = ["minicpm3-4b", "deepseek-v2-236b"]
REL = 2e-6


def _setup(arch, **kw):
    jcfg = dataclasses.replace(jget(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    jp = jattn.init_mla(jax.random.PRNGKey(4), jcfg)
    return jcfg, tcfg, jp, convert.params(jax.tree.map(np.asarray, jp), "cpu")


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def _cache_close(got, want, err=""):
    assert sorted(got) == sorted(want), err
    for n, w in want.items():
        w = np.asarray(w)
        if n == "pos":
            np.testing.assert_array_equal(got[n].numpy(), w, err_msg=f"{err} pos")
        else:
            _close(got[n], w, REL, f"{err} {n}")


def _lane_cache(cfg, lanes, L, seed, filled):
    """Lane rows holding ``filled[b]`` earlier tokens (positions 0..n-1,
    the rest -1) over random latents, as numpy arrays."""
    rng = np.random.default_rng(seed)
    pos = np.full((lanes, L), -1, np.int32)
    for b, n in enumerate(filled):
        pos[b, :n] = np.arange(n)
    return {"ckv": rng.standard_normal((lanes, L, cfg.kv_lora)).astype(np.float32),
            "kpe": rng.standard_normal((lanes, L, cfg.qk_rope)).astype(np.float32),
            "pos": pos}


@pytest.mark.parametrize("arch", MLA)
def test_mla_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    S, gen, B = 10, 3, 2
    jc = jattn.make_mla_cache(jcfg, B, S + gen)
    tc = attention.make_mla_cache(tcfg, B, S + gen, device="cpu")
    _cache_close(tc, jc, "make_mla_cache")
    x = _x(tcfg, (B, S), 0)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jy, jc = jax.jit(lambda x, c: jattn.mla_prefill(
        jp, x, jcfg, positions=jnp.asarray(positions), cache=c))(jnp.asarray(x), jc)
    with torch.no_grad():
        ty, tc2 = attention.mla_prefill(tp, _t(x), tcfg,
                                        positions=_t(positions), cache=tc)
    assert tc2 is tc                                  # written in place
    _close(ty, jy, REL, "prefill")
    _cache_close(tc, jc, "prefill")
    jdec = jax.jit(lambda x, c, pos: jattn.mla_decode(jp, x, jcfg, pos=pos,
                                                      cache=c))
    for i in range(gen):
        xt = _x(tcfg, (B, 1), 10 + i)
        jy, jc = jdec(jnp.asarray(xt), jc, jnp.int32(S + i))
        with torch.no_grad():
            ty, _ = attention.mla_decode(tp, _t(xt), tcfg, pos=S + i, cache=tc)
        _close(ty, jy, REL, f"decode {i}")
        _cache_close(tc, jc, f"decode {i}")


@pytest.mark.parametrize("hold", [False, True], ids=["no-hold", "hold-idle"])
@pytest.mark.parametrize("arch", MLA)
def test_mla_decode_lanes_matches_jax(arch, hold):
    """Lanes at positions 5, 11 (the row's last slot) and 14 > L - 1 = 11,
    the last one free: JAX drops its write, and with the hold every idle
    lane's row ends as it began."""
    jcfg, tcfg, jp, tp = _setup(arch)
    L = 12
    cache = _lane_cache(tcfg, 3, L, 1, [5, 11, 12])
    pos = np.array([5, 11, 14], np.int32)
    live = np.array([True, True, False]) if hold else None
    x = _x(tcfg, (3, 1), 2)

    def jstep(x, c, pos):
        y, new = jattn.mla_decode_lanes(jp, x, jcfg, pos=pos, cache=c)
        if hold:   # blocks.apply_layer's hold_idle
            new = jax.tree.map(lambda n, o: jnp.where(
                live.reshape((-1,) + (1,) * (n.ndim - 1)), n, o), new, c)
        return y, new

    jy, jc = jax.jit(jstep)(jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
                            jnp.asarray(pos))
    tc = convert.params(cache, "cpu")
    with torch.no_grad():
        ty, _ = attention.mla_decode_lanes(
            tp, _t(x), tcfg, pos=_t(pos), cache=tc,
            live=None if live is None else _t(live))
    _close(ty, jy, REL, "out")
    _cache_close(tc, jc, "cache")
    # the free lane's row is untouched: its write was dropped (and held)
    for n in ("ckv", "kpe", "pos"):
        np.testing.assert_array_equal(tc[n][2].numpy(), cache[n][2], err_msg=n)
    assert int(tc["pos"][1, L - 1]) == 11            # the last slot written


@pytest.mark.parametrize("stacked", [False, True], ids=["unstacked", "stacked"])
def test_commit_prefill_mla_matches_jax(stacked):
    _, tcfg, _, _ = _setup("minicpm3-4b")
    rng = np.random.default_rng(5)
    L, S, n = 12, 7, 3
    lead = (n,) if stacked else ()
    cache = _lane_cache(tcfg, 2, L, 6, [12, 3])
    cache = {k: np.broadcast_to(v, lead + v.shape).copy() for k, v in cache.items()}
    dense = {"ckv": rng.standard_normal(lead + (1, S, tcfg.kv_lora)).astype(np.float32),
             "kpe": rng.standard_normal(lead + (1, S, tcfg.qk_rope)).astype(np.float32),
             "pos": np.broadcast_to(np.arange(S, dtype=np.int32), lead + (S,)).copy()}
    want = jattn.commit_prefill_mla(jax.tree.map(jnp.asarray, cache),
                                    jax.tree.map(jnp.asarray, dense), 0,
                                    stacked=stacked)
    got = convert.params(cache, "cpu")
    out = attention.commit_prefill_mla(got, convert.params(dense, "cpu"), 0,
                                       stacked=stacked)
    assert out is got
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the reused lane's stale slots past the prompt are invalidated
    assert (got["pos"][..., 0, S:] == -1).all()


@pytest.mark.parametrize("absorbed, attn_chunk", [(False, 32), (True, 32),
                                                   (False, 8)],
                         ids=["expanded", "absorbed", "expanded-chunk8"])
@pytest.mark.parametrize("arch", MLA)
def test_mla_chunk_lanes_matches_jax(arch, absorbed, attn_chunk):
    """Call 1: lane 2 (a reused lane: its row holds a previous occupant's
    14 stale slots) takes a first chunk of 5 tokens, lane 0 a first chunk
    of 8, and row 2 repeats row 0 (the engine's batch padding). Call 2:
    lane 0 continues at position 8 with 4 tokens in a bucket of 8, whose
    padded positions 14 and 15 clip to the row's last slot 13."""
    jcfg, tcfg, jp, tp = _setup(arch, mla_absorbed=absorbed,
                                attn_chunk=attn_chunk)
    L, Cb = 14, 8
    cache = _lane_cache(tcfg, 3, L, 7, [0, 0, 14])
    jc = jax.tree.map(jnp.asarray, cache)
    tc = convert.params(cache, "cpu")
    jchunk = jax.jit(lambda x, c, positions, lengths, lanes: jattn.mla_chunk_lanes(
        jp, x, jcfg, positions=positions, lengths=lengths, lanes=lanes, cache=c))
    calls = [(np.array([2, 0, 2], np.int32), np.array([0, 0, 0], np.int32),
              np.array([5, 8, 5], np.int32), 1),
             (np.array([0], np.int32), np.array([8], np.int32),
              np.array([4], np.int32), 2)]
    for i, (lanes, starts, lengths, seed) in enumerate(calls):
        x = _x(tcfg, (len(lanes), Cb), seed)
        if len(lanes) == 3:
            x[2] = x[0]                       # the batch padding
        positions = (starts[:, None] + np.arange(Cb, dtype=np.int32)[None])
        jy, jc = jchunk(jnp.asarray(x), jc, jnp.asarray(positions),
                        jnp.asarray(lengths), jnp.asarray(lanes))
        with torch.no_grad():
            ty, out = attention.mla_chunk_lanes(
                tp, _t(x), tcfg, positions=_t(positions), lengths=_t(lengths),
                lanes=_t(lanes), cache=tc)
        assert out is tc
        _close(ty, jy, REL, f"call {i} out")
        _cache_close(tc, jc, f"call {i}")
    # lane 2's stale slots past its 5 tokens are invalidated, their values kept
    assert (tc["pos"][2, 5:] == -1).all() and (tc["pos"][2, :5] == torch.arange(5)).all()
    np.testing.assert_array_equal(tc["ckv"][2, 5:].numpy(), cache["ckv"][2, 5:])
    # lane 0 holds 12 tokens; its clipped padded slot 13 kept its old value
    assert (tc["pos"][0, :12] == torch.arange(12)).all()
    np.testing.assert_array_equal(tc["ckv"][0, 12:].numpy(), cache["ckv"][0, 12:])
