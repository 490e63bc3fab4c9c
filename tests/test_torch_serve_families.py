"""The serve modes of the port's MLA, RG-LRU, SSD and encoder-decoder LMs
against the JAX package's, on the CPU.

For the smoke configs of minicpm3-4b and deepseek-v2-236b (MLA latent
rows), recurrentgemma-9b (RG-LRU state beside sliding-window attention)
and mamba2-2.7b (SSD state), from the JAX package's parameters carried
across with ``repro_torch.convert.params``:

* ``LM.prefill`` and 4 ``decode_step``s of the fixed driver's dense cache;
* ``prefill_commit_batch`` and 3 ``decode_step_lanes``, then a free lane
  whose position has drifted past its row (JAX drops its MLA write; its
  latent and state rows are held by ``live``), then for the MLA and SSD
  archs a chunk continuation (a second chunk of two rows, one padded,
  seeded by the first's latents and state);
* ``commit_prefill`` of a batch-1 dense prefill into the paged cache;
* seamless-m4t-large-v2: ``prefill`` (the encoder over random frames, the
  cross K/V cached) and 4 ``decode_step``s over the cached cross K/V.

Logits within ``test_torch_serve_models``' tolerance (``rtol=1e-5`` plus
``atol=1e-6`` times the array's largest magnitude); float cache leaves within 1e-5 of their
largest magnitude for SSD state and 2e-6 for every other leaf (the
RG-LRU's fused multiply-add and SSD's einsum order, ROADMAP queue 3);
integer leaves bit-equal.

The engine over these families is in ``test_torch_serve_families_engine.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_serve_models import _both, _close, _models, _np, _tokens  # noqa: E402

from repro_torch.core.paths import flatten_with_path  # noqa: E402

FAMILIES = ["minicpm3-4b", "deepseek-v2-236b", "recurrentgemma-9b",
            "mamba2-2.7b"]
PS = 4


def _leaf_close(path, g, w, err):
    """2e-6 of the largest magnitude, 1e-5 for SSD state leaves."""
    rel = 1e-5 if "state" in path and ("/h" in path or "/conv/" in path) else 2e-6
    scale = max(float(np.abs(w).max()), 1e-30) if w.size else 1.0
    diff = float(np.abs(g - w).max()) if w.size else 0.0
    assert diff <= rel * scale, (err, path, diff, scale)


def _same_tree(port, ref, err=""):
    got = dict(flatten_with_path(port))
    want = dict(flatten_with_path(jax.tree.map(np.asarray, ref)))
    assert sorted(got) == sorted(want), err
    for path, w in want.items():
        g = _np(got[path])
        assert g.shape == w.shape, (err, path)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{err} {path}")
        else:
            _leaf_close(path, g, w, err)


def _argmax_tok(jl):
    return np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]


@pytest.mark.parametrize("arch", FAMILIES)
def test_dense_prefill_and_decode_match_jax(arch):
    jm, jp, fns, m, p = _models(arch)
    S, B, gen = 10, 2, 4
    toks = _tokens(m.cfg, (B, S), 0)
    jc = jm.init_cache(B, S + gen)
    tc = m.init_cache(B, S + gen, device="cpu")
    _same_tree(tc, jc, "init_cache")
    jl, jc = fns["prefill"](jp, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc2 = m.prefill(p, {"tokens": torch.from_numpy(toks)}, tc)
    assert tc2 is tc
    _close(tl, jl)
    _same_tree(tc, jc, "prefill")
    for i in range(gen):
        tok = _argmax_tok(jl)
        jl, jc = fns["decode"](jp, jnp.asarray(tok), jc, jnp.int32(S + i))
        tl, tc = m.decode_step(p, torch.from_numpy(tok), tc, S + i)
        _close(tl, jl, str(i))
    _same_tree(tc, jc, "decode")


def _lane_rows(paged, lane):
    """Copies of one lane's rows of the per-lane leaves (MLA latents and
    positions, recurrent state)."""
    out = {}
    for path, t in flatten_with_path(paged):
        if "/kv/kp" in path or "/kv/vp" in path:
            continue
        out[path] = (t[:, lane] if path.startswith("body") else t[lane]).clone()
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_paged_prefill_and_decode_lanes_match_jax(arch):
    jm, jp, fns, m, p = _models(arch)
    S = 10
    pad = "rec" not in m.cfg.layer_kinds     # the engine never pads rec rows
    lens = np.array([S, S - 3 if pad else S], np.int32)
    Cb = 16 if pad else S
    T = -(-(S + 8) // PS)
    P = 2 * T + 1
    tables = np.stack([np.arange(1, T + 1), np.arange(T + 1, 2 * T + 1)]
                      ).astype(np.int32)
    toks = np.zeros((2, Cb), np.int32)
    toks[0, :lens[0]] = _tokens(m.cfg, lens[0], 1)
    toks[1, :lens[1]] = _tokens(m.cfg, lens[1], 2)
    jpaged = jm.init_paged_cache(2, P, PS, S + 8)
    tpaged = m.init_paged_cache(2, P, PS, S + 8, device="cpu")
    _same_tree(tpaged, jpaged, "init_paged_cache")
    lanes = np.arange(2, dtype=np.int32)
    (jl, jpaged), (tl, tpaged2) = _both(
        lambda *a: fns["batch"](jp, a[0], jpaged, *a[1:]),
        lambda *a: m.prefill_commit_batch(p, a[0], tpaged, *a[1:]),
        toks, tables, lanes, np.zeros(2, np.int32), lens, np.ones(2, bool))
    assert tpaged2 is tpaged
    _close(tl, jl)
    _same_tree(tpaged, jpaged, "prefill_commit_batch")

    pos = lens.copy()
    live = np.ones(2, bool)
    for i in range(3):
        (jl, jpaged), (tl, _) = _both(
            lambda *a: fns["lanes"](jp, a[0], jpaged, *a[1:]),
            lambda *a: m.decode_step_lanes(p, a[0], tpaged, *a[1:]),
            _argmax_tok(jl), tables, pos, live)
        _close(tl, jl, str(i))
        pos = pos + 1
    _same_tree(tpaged, jpaged, "decode_step_lanes")

    # lane 1 is free: an all-scratch table row, its position past the MLA
    # row's end (S + 8); its latent and state rows are held
    before = _lane_rows(tpaged, 1)
    tables[1] = 0
    pos[1] = 2 * T * PS + 3
    live[1] = False
    (jl, jpaged), (tl, _) = _both(
        lambda *a: fns["lanes"](jp, a[0], jpaged, *a[1:]),
        lambda *a: m.decode_step_lanes(p, a[0], tpaged, *a[1:]),
        _argmax_tok(jl), tables, pos, live)
    _close(tl, jl)
    _same_tree(tpaged, jpaged, "free lane past its row")
    after = _lane_rows(tpaged, 1)
    assert before and all(torch.equal(before[k], after[k]) for k in before)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-236b",
                                  "mamba2-2.7b"])
def test_chunk_continuation_matches_jax(arch):
    """A 24-token prompt in lane 0 and a 21-token one in lane 1 as a first
    chunk of 16 and a second of 8 (lane 1's padded): the second chunk reads
    the first's latent rows (MLA) or continues from its state (SSD, chunk
    16 = ``ssm_chunk``)."""
    jm, jp, fns, m, p = _models(arch)
    T = -(-32 // PS)
    P = 2 * T + 1
    tables = np.stack([np.arange(1, T + 1), np.arange(T + 1, 2 * T + 1)]
                      ).astype(np.int32)
    prompts = _tokens(m.cfg, (2, 24), 6)
    jpaged = jm.init_paged_cache(2, P, PS, 32)
    tpaged = m.init_paged_cache(2, P, PS, 32, device="cpu")
    lanes = np.arange(2, dtype=np.int32)
    for start, lens, fresh in ((0, [16, 16], True), (16, [8, 5], False)):
        lens = np.array(lens, np.int32)
        toks = np.zeros((2, lens.max()), np.int32)
        for b, n in enumerate(lens):
            toks[b, :n] = prompts[b, start:start + n]
        (jl, jpaged), (tl, _) = _both(
            lambda *a: fns["batch"](jp, a[0], jpaged, *a[1:]),
            lambda *a: m.prefill_commit_batch(p, a[0], tpaged, *a[1:]),
            toks, tables, lanes, np.full(2, start, np.int32), lens,
            np.full(2, fresh))
        _close(tl, jl, f"chunk at {start}")
        _same_tree(tpaged, jpaged, f"chunk at {start}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_commit_prefill_matches_jax(arch):
    jm, jp, fns, m, p = _models(arch)
    S, gen = 10, 4
    T = -(-(S + gen) // PS)
    P = T + 3
    row = np.array([4, 1, 6, 2, 5, 3, 7][:T], np.int32)
    toks = _tokens(m.cfg, (1, S), 4)
    _, jdense = fns["prefill"](jp, {"tokens": jnp.asarray(toks)},
                               jm.init_cache(1, S + gen))
    _, tdense = m.prefill(p, {"tokens": torch.from_numpy(toks)},
                          m.init_cache(1, S + gen, device="cpu"))
    jpaged = jm.commit_prefill(jm.init_paged_cache(2, P, PS, S + gen), jdense,
                               jnp.asarray(row), 1, prompt_len=S, page_size=PS)
    tpaged = m.commit_prefill(m.init_paged_cache(2, P, PS, S + gen,
                                                 device="cpu"), tdense,
                              torch.from_numpy(row), 1, prompt_len=S,
                              page_size=PS)
    _same_tree(tpaged, jpaged, "commit_prefill")


def test_encdec_prefill_and_decode_match_jax():
    """seamless-m4t-large-v2: 10 prompt tokens, 7 encoder frames."""
    jm, jp, fns, m, p = _models("seamless-m4t-large-v2")
    S, Se, B, gen = 10, 7, 2, 4
    toks = _tokens(m.cfg, (B, S), 8)
    frames = np.random.default_rng(9).standard_normal(
        (B, Se, m.cfg.d_model)).astype(np.float32)
    jc = jm.init_cache(B, S + gen, enc_len=Se)
    tc = m.init_cache(B, S + gen, enc_len=Se, device="cpu")
    _same_tree(tc, jc, "init_cache")
    jl, jc = fns["prefill"](jp, {"tokens": jnp.asarray(toks),
                                 "frames": jnp.asarray(frames)}, jc)
    tl, _ = m.prefill(p, {"tokens": torch.from_numpy(toks),
                          "frames": torch.from_numpy(frames)}, tc)
    _close(tl, jl)
    _same_tree(tc, jc, "prefill")
    assert float(tc["body"]["p0"]["ck"].abs().max()) > 0
    for i in range(gen):
        tok = _argmax_tok(jl)
        jl, jc = fns["decode"](jp, jnp.asarray(tok), jc, jnp.int32(S + i))
        tl, tc = m.decode_step(p, torch.from_numpy(tok), tc, S + i)
        _close(tl, jl, str(i))
    _same_tree(tc, jc, "decode")
