"""A one-row serve as ranks of a mesh whose data axes cannot split the
batch (the dry run's ``long_500k`` cells): every data rank computes the
row, as the reference's one program does, and meets caches split on
their sequence or on their period axis (``distributed.sharding.
CacheShards``).

(a) ``attention.decode_attention`` on each data rank's block of a cache's
slots (and of ``head_dim`` over the model axis), the partial softmax
merged by log-sum-exp over the data group, against the JAX package's
``decode_attention`` on the same seeded float32 inputs, within 2e-6 of
the output's amax: a wrapped ring, a window and empty (-1) slots that
mask every slot of one rank. (b) ``launch.serve.fixed_generate`` at batch
1 of the smoke gemma3-4b (a ring split on its sequence), mixtral-8x7b
(two periods on two data ranks), recurrentgemma-9b (states whole on
every data rank) and mamba2-2.7b cut to 4 layers (four periods), a
prompt past the 16-token window, on the JAX package's weights
(``convert.params``): greedy tokens equal to one process's and to the
JAX package's ``prefill`` + ``serve_step``, the caches gathered back from
the blocks within 2e-6 of their amax (SSD state 1e-5). One gloo world
per mesh, (2, 1) and (2, 2), every case inside.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch import convert
from repro_torch.benchmarks.step_profile import cut_depth
from repro_torch.configs import get_config
from repro_torch.core.paths import flatten_with_path
from repro_torch.launch.serve import fixed_generate
from repro_torch.models.lm import LM

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models.attention import decode_attention as jdecode  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402

MESHES = {"2x1": (2, 1), "2x2": (2, 2)}
ARCHS = ("gemma3-4b", "mixtral-8x7b", "recurrentgemma-9b", "mamba2-2.7b")
LAYERS = {"mamba2-2.7b": 4}
PROMPT, GEN = 21, 4
CASES = sorted(torch_ranks.SEQ_DECODE_CASES)


def _jax_cfg(arch):
    cfg = jget(arch, smoke=True)
    n = LAYERS.get(arch)
    if n:
        cfg = dataclasses.replace(cfg, n_layers=n,
                                  n_periods=n // len(cfg.pattern))
    return cfg


def _jax_generate(jm, jp, tokens):
    """The JAX package's fixed driver at batch 1: prefill, then ``GEN - 1``
    greedy ``serve_step``s (jitted)."""
    cache = jm.init_cache(1, PROMPT + GEN)
    logits, cache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens)},
                                        cache)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    out = [np.asarray(tok)]
    step = jax.jit(jm.serve_step)
    for i in range(GEN - 1):
        tok, cache = step(jp, tok, cache, jnp.int32(PROMPT + i))
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gloo worlds, started first; the JAX package's and one
    process's runs in this process meanwhile."""
    work = str(tmp_path_factory.mktemp("serve_long"))
    weights, jax_side = {}, {}
    rng = np.random.default_rng(17)
    for arch in ARCHS:
        jm = JLM(_jax_cfg(arch))
        jp = jm.init(jax.random.PRNGKey(3))
        tokens = rng.integers(0, jm.cfg.vocab, (1, PROMPT)).astype(np.int32)
        weights[arch] = {
            "params": convert.params(jax.tree.map(np.asarray, jp), "cpu"),
            "tokens": torch.from_numpy(tokens)}
        jax_side[arch] = (jm, jp, tokens)
    params_file = f"{work}/weights.pt"
    torch.save(weights, params_file)
    worlds = {name: torch_ranks.start(
        "serve_long", d * m, work, 300, data=d, model=m,
        params_file=params_file, archs=list(ARCHS), layers=LAYERS,
        prompt=PROMPT, gen=GEN) for name, (d, m) in MESHES.items()}
    want = {}
    for case in CASES:
        q, k, v, k_pos, pos, window = torch_ranks.seq_decode_inputs(case)
        want[case] = np.asarray(jdecode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            k_pos=jnp.asarray(k_pos), pos=jnp.int32(pos), window=window))
    ref, jtok = {}, {}
    for arch in ARCHS:
        model = LM(cut_depth(get_config(arch, smoke=True),
                             LAYERS.get(arch, 0)))
        ref[arch] = fixed_generate(model, weights[arch]["params"],
                                   weights[arch]["tokens"], GEN)
        jtok[arch] = _jax_generate(*jax_side[arch])
    got = {name: w.wait() for name, w in worlds.items()}
    return want, ref, jtok, got


@pytest.mark.parametrize("mesh,case", [(m, c) for m in MESHES for c in CASES])
def test_split_decode_matches_jax(runs, mesh, case):
    """Rank 0's merged output against JAX's ``decode_attention`` on the
    whole cache; every rank's bit-equal to rank 0's."""
    want, _, _, got = runs
    want = want[case]
    out = got[mesh][0]["split"][case]
    amax = float(np.abs(want).max())
    err = float(np.abs(out["out"].numpy() - want).max())
    assert err <= 2e-6 * amax, (err, amax)
    for r, res in enumerate(got[mesh][1:], 1):
        assert torch.equal(res["split"][case]["out"], out["out"]), r
    merge = out["stats"]["attn/seq_merge"]
    assert merge["calls"] == 1
    # (m, l, p.v) of every (kv head, group) of the rank's head_dim slice
    d = 8 // MESHES[mesh][1]
    assert merge["bytes"] == 4 * 2 * 2 * (d + 2)


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in MESHES for a in ARCHS])
def test_one_row_gives_one_process_and_jax_tokens(runs, mesh, arch):
    _, ref, jtok, got = runs
    toks = got[mesh][0]["serve"][arch]["tokens"]
    assert torch.equal(toks, ref[arch][0]), (toks, ref[arch][0])
    assert np.array_equal(toks.numpy(), jtok[arch]), (toks, jtok[arch])
    for r, res in enumerate(got[mesh][1:], 1):
        assert torch.equal(res["serve"][arch]["tokens"], toks), r


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in MESHES for a in ARCHS])
def test_one_row_gathered_cache_matches_one_process(runs, mesh, arch):
    _, ref, _, got = runs
    want = dict(flatten_with_path(ref[arch][1]))
    for p, t in flatten_with_path(got[mesh][0]["serve"][arch]["cache"]):
        w = want[p]
        assert t.shape == w.shape and t.dtype == w.dtype, p
        if not w.is_floating_point():
            assert torch.equal(t, w), p
            continue
        tol = 1e-5 if (p.endswith("state/h") and arch.startswith("mamba")) \
            else 2e-6
        amax = float(w.abs().max())
        err = float((t.float() - w.float()).abs().max())
        assert err <= tol * amax, (p, err, amax)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_one_row_layouts_and_moves(runs, mesh):
    """gemma3-4b's tail rings split their sequence over the data axes and
    its decode merges over them; mixtral-8x7b's and mamba2-2.7b's body
    caches split their period axis and move by broadcast in decode only;
    recurrentgemma-9b's states stay whole and move nothing."""
    _, _, _, got = runs
    r = got[mesh][0]["serve"]
    tail = {p: lay[0] for p, lay in r["gemma3-4b"]["layout"].items()
            if p.startswith("tail/") and not p.endswith("/pos")}
    assert tail and set(tail.values()) == {"sequence"}, tail
    pre, post = r["gemma3-4b"]["stats"]
    assert "attn/seq_merge" not in pre and "cache/reshard" not in post
    assert post["attn/seq_merge"]["calls"] == len(tail) // 2 * (GEN - 1)
    for arch in ("mixtral-8x7b", "mamba2-2.7b"):
        body = {lay[0] for p, lay in r[arch]["layout"].items()
                if p.startswith("body/") and not p.endswith("/pos")}
        assert body == {"period"}, (arch, body)
        pre, post = r[arch]["stats"]
        assert "cache/reshard" not in pre, arch
        n_layers = LAYERS.get(arch) or get_config(arch, smoke=True).n_layers
        assert post["cache/reshard"]["calls"] == (
            (GEN - 1) * n_layers * len([p for p in r[arch]["layout"]
                                        if p.startswith("body/p0/")
                                        and not p.endswith("/pos")])), arch
    pre, post = r["recurrentgemma-9b"]["stats"]
    assert "cache/reshard" not in post


def test_other_sequence_splits_raise():
    """At batch 1 on two data ranks the smoke deepseek-v2-236b's dense
    prefix layer would split MLA's latent cache on its sequence:
    ``CacheShards`` meets only attention k/v so, and refuses the rest
    rather than read a block of slots as the whole."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(2, 1)
    cache = LM(get_config("deepseek-v2-236b", smoke=True)).init_cache(
        1, 32, abstract=True, device="meta")
    lay = sharding.cache_layout(cache, mesh)
    assert lay["prefix/l0/kv/ckv"].data == "sequence"
    with pytest.raises(NotImplementedError, match="prefix/l0/kv/ckv"):
        sharding.CacheShards(sharding.cache_shardings(cache, mesh), 1)
