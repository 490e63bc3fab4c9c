"""The serve modes of the port's page-pool attention LMs against the JAX
package's, on the CPU.

For the smoke configs of qwen2-0.5b, qwen3-14b, gemma3-4b (its prompt
longer than the 16-token window, so the dense cache is a ring buffer),
qwen2-vl-2b (M-RoPE) and mixtral-8x7b (MoE, sliding window), from the JAX
package's parameters carried across with ``repro_torch.convert.params``:

* ``LM.prefill`` and 4 ``decode_step``s of the fixed-batch driver's dense
  cache (``init_cache`` / ``make_attn_cache``);
* ``prefill_commit_batch`` (two rows of different lengths, right-padded to
  a power-of-two bucket) and 3 ``decode_step_lanes`` into the paged pools;
  then a free lane whose position has drifted past its all-scratch table
  row (JAX clamps the read of its page column to the row's last);
* a bucketed chunk whose padded tail reaches past the table's width (JAX
  reads INT_MIN there and masks it to the scratch slot);
* ``commit_prefill`` of a batch-1 dense prefill into the pools.

Logits within ``rtol=1e-5`` plus ``atol=1e-6`` times the array's largest
magnitude (float32 smoke; XLA-CPU and torch sum the products in other
orders, so an element near 0 of logits near 20 is a few 1e-6 off, as in
``test_torch_models``), float cache leaves within the same, integer
leaves (``pos``) bit-equal. The same token ids feed both packages
at every step.

Inside the port, bit for bit: ``_chunk_attention`` over one chunk against
``_flash_fwd_impl`` (the identity the engine's prefill rides on), and the
paged decode against the dense decode on the same keys and values.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.paths import flatten_with_path  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

ARCHS = ["qwen2-0.5b", "qwen3-14b", "gemma3-4b", "qwen2-vl-2b", "mixtral-8x7b"]
PROMPT = {"gemma3-4b": 24}
PS = 4


def _close(got, want, err=""):
    """rtol 1e-5 plus atol 1e-6 of the largest magnitude of ``want``."""
    want = np.asarray(want)
    amax = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(_np(got), want, rtol=1e-5,
                               atol=1e-6 * max(amax, 1.0), err_msg=err)


@functools.lru_cache(maxsize=None)
def _models(arch: str):
    """(JAX LM, its params, jitted serve entry points, port LM, params)."""
    jm = JLM(jget(arch, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    fns = dict(prefill=jax.jit(jm.prefill), decode=jax.jit(jm.decode_step),
               batch=jax.jit(jm.prefill_commit_batch),
               lanes=jax.jit(jm.decode_step_lanes))
    m = LM(get_config(arch, smoke=True))
    return jm, jp, fns, m, convert.params(jax.tree.map(np.asarray, jp), "cpu")


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


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
            _close(g, w, f"{err} {path}")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_prefill_and_decode_match_jax(arch):
    jm, jp, fns, m, p = _models(arch)
    S, B, gen = PROMPT.get(arch, 10), 2, 4
    toks = _tokens(m.cfg, (B, S), 0)
    jc = jm.init_cache(B, S + gen)
    tc = m.init_cache(B, S + gen, device="cpu")
    _same_tree(tc, jc, "init_cache")
    jl, jc = fns["prefill"](jp, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl)
    _same_tree(tc, jc, "prefill")
    for i in range(gen):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        jl, jc = fns["decode"](jp, jnp.asarray(tok), jc, jnp.int32(S + i))
        tl, tc = m.decode_step(p, torch.from_numpy(tok), tc, S + i)
        _close(tl, jl, str(i))
    _same_tree(tc, jc, "decode")
    if arch == "gemma3-4b":    # the window's ring buffer is in use
        assert jc["body"]["p0"]["kv"]["pos"].shape[-1] == m.cfg.window < S


def _both(fn_j, fn_t, *args):
    """Call the JAX and the port function on the same numpy inputs."""
    ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    ta = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args]
    return fn_j(*ja), fn_t(*ta)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_and_decode_lanes_match_jax(arch):
    jm, jp, fns, m, p = _models(arch)
    S = PROMPT.get(arch, 10)
    lens = np.array([S, S - 3], np.int32)
    T = -(-(S + 8) // PS)
    P = 2 * T + 1
    tables = np.stack([np.arange(1, T + 1), np.arange(T + 1, 2 * T + 1)]
                      ).astype(np.int32)
    Cb = 1 << (S - 1).bit_length()
    toks = np.zeros((2, Cb), np.int32)
    toks[0, :S] = _tokens(m.cfg, S, 1)
    toks[1, :S - 3] = _tokens(m.cfg, S - 3, 2)
    jpaged = jm.init_paged_cache(2, P, PS, S + 8)
    tpaged = m.init_paged_cache(2, P, PS, S + 8, device="cpu")
    _same_tree(tpaged, jpaged, "init_paged_cache")
    lanes = np.arange(2, dtype=np.int32)
    starts = np.zeros(2, np.int32)
    fresh = np.ones(2, bool)
    (jl, jpaged), (tl, tpaged2) = _both(
        lambda *a: fns["batch"](jp, a[0], jpaged, *a[1:]),
        lambda *a: m.prefill_commit_batch(p, a[0], tpaged, *a[1:]),
        toks, tables, lanes, starts, lens, fresh)
    assert tpaged2 is tpaged                     # written in place
    _close(tl, jl)
    _same_tree(tpaged, jpaged, "prefill_commit_batch")

    pos = lens.copy()
    live = np.ones(2, bool)
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        (jl, jpaged), (tl, _) = _both(
            lambda *a: fns["lanes"](jp, a[0], jpaged, *a[1:]),
            lambda *a: m.decode_step_lanes(p, a[0], tpaged, *a[1:]),
            tok, tables, pos, live)
        _close(tl, jl, str(i))
        pos = pos + 1
    _same_tree(tpaged, jpaged, "decode_step_lanes")

    # lane 1 is free: an all-scratch row, its position drifted past the row
    # (page column 2T > T - 1); the read clamps, the write hits scratch
    tables[1] = 0
    pos[1] = 2 * T * PS + 3
    live[1] = False
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    (jl, jpaged), (tl, _) = _both(
        lambda *a: fns["lanes"](jp, a[0], jpaged, *a[1:]),
        lambda *a: m.decode_step_lanes(p, a[0], tpaged, *a[1:]),
        tok, tables, pos, live)
    _close(tl, jl)
    _same_tree(tpaged, jpaged, "free lane past its row")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-4b"])
def test_chunk_padded_past_the_table_width_matches_jax(arch):
    """A 6-token chunk bucketed to 16 over a 2-page (8-slot) table span:
    its padded positions 8-15 reach page columns 2-3 of a 2-column table."""
    jm, jp, fns, m, p = _models(arch)
    P, tw, Cb = 9, 2, 16
    tables = np.array([[3, 5], [7, 2]], np.int32)
    toks = np.zeros((2, Cb), np.int32)
    toks[:, :6] = _tokens(m.cfg, (2, 6), 3)
    jpaged = jm.init_paged_cache(2, P, PS, 8)
    tpaged = m.init_paged_cache(2, P, PS, 8, device="cpu")
    (jl, jpaged), (tl, _) = _both(
        lambda *a: fns["batch"](jp, a[0], jpaged, *a[1:]),
        lambda *a: m.prefill_commit_batch(p, a[0], tpaged, *a[1:]),
        toks, tables, np.array([0, 1], np.int32), np.zeros(2, np.int32),
        np.array([6, 5], np.int32), np.ones(2, bool))
    _close(tl, jl)
    _same_tree(tpaged, jpaged, "padded chunk")
    # the written slots are the rows' own; the padded tail wrote only the
    # scratch page (page 0), no other page
    kp = tpaged["body"]["p0"]["kv"]["kp"]
    untouched = [q for q in range(1, P) if q not in (3, 5, 7, 2)]
    assert not kp[:, untouched].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_commit_prefill_matches_jax(arch):
    jm, jp, fns, m, p = _models(arch)
    S, gen = PROMPT.get(arch, 10), 4
    T = -(-(S + gen) // PS)
    P = T + 3
    row = np.array([4, 1, 6, 2, 5, 3, 7][:T] + [0] * max(0, T - 7), np.int32)
    toks = _tokens(m.cfg, (1, S), 4)
    jd, jdense = fns["prefill"](jp, {"tokens": jnp.asarray(toks)},
                                jm.init_cache(1, S + gen))
    td, tdense = m.prefill(p, {"tokens": torch.from_numpy(toks)},
                           m.init_cache(1, S + gen, device="cpu"))
    jpaged = jm.commit_prefill(jm.init_paged_cache(1, P, PS, S + gen), jdense,
                               jnp.asarray(row), 0, prompt_len=S, page_size=PS)
    tpaged = m.commit_prefill(m.init_paged_cache(1, P, PS, S + gen,
                                                 device="cpu"), tdense,
                              torch.from_numpy(row), 0, prompt_len=S,
                              page_size=PS)
    _same_tree(tpaged, jpaged, "commit_prefill")


# ---------------------------------------------------------------------------
# bit identities inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 5])
def test_chunk_attention_one_chunk_is_the_flash_forward(dtype, window):
    g = torch.Generator().manual_seed(0)
    B, S, H, KV, D = 2, 12, 4, 2, 16
    q, k, v = (torch.randn(B, S, h, D, generator=g).to(dtype)
               for h in (H, KV, KV))
    pos = torch.arange(S)[None].expand(B, S)
    got = attention._chunk_attention(q, k, v, q_pos=pos, k_pos=pos,
                                     window=window, chunk=32)
    want, _ = attention._flash_fwd_impl(q, k, v, True, window, S, 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-14b", "qwen2-vl-2b"])
def test_paged_decode_is_the_dense_decode(arch):
    """The same prompt prefilled into a dense cache of T * page_size slots
    and committed into a lane's pages: 3 decode steps give bit-equal
    logits through ``decode_step`` and ``decode_step_lanes``."""
    _, _, _, m, p = _models(arch)
    S, T = 10, 5
    row = torch.tensor([3, 1, 5, 2, 4], dtype=torch.int32)
    toks = torch.from_numpy(_tokens(m.cfg, (1, S), 5))
    logits, dense = m.prefill(p, {"tokens": toks},
                              m.init_cache(1, T * PS, device="cpu"))
    paged = m.commit_prefill(m.init_paged_cache(1, T + 1, PS, T * PS,
                                                device="cpu"),
                             dense, row, 0, prompt_len=S, page_size=PS)
    lp = logits
    for i in range(3):
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        logits, dense = m.decode_step(p, tok, dense, S + i)
        lp, paged = m.decode_step_lanes(
            p, tok, paged, row[None], torch.tensor([S + i], dtype=torch.int32),
            torch.ones(1, dtype=torch.bool))
        assert torch.equal(lp, logits), i
