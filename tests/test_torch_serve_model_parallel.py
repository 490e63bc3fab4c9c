"""The fixed serve paths as ranks of a mesh (``launch.serve.fixed_generate``:
``LM.prefill`` and ``LM.serve_step`` on each rank's blocks of the weights
and of the cache, ``distributed.sharding.CacheShards``).

Every arch's smoke config (dense, sliding-window and M-RoPE attention,
MLA, MoE, RG-LRU, SSD and the encoder-decoder) runs on gloo ranks of a
(1, 2) and a (2, 2) mesh, one world each with every case inside, against
one process: greedy tokens identical, the caches gathered back from the
blocks within 2e-6 of their amax (SSD state 1e-5). The cache splits
``head_dim`` (or MLA's latent and rope dims, SSD's state dim) over the
model axis while the compute splits heads, so decode sums partial scores
over the model group; on (2, 2) the body caches of the archs with two
periods put the data axes on their period axis, and the recurrent states
of one- and three-period stacks are whole on every data rank (the
reference's ``cache_shardings`` takes a body leaf's period axis for its
batch; held to the JAX package spec for spec on the production meshes)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import torch_ranks
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.core.paths import flatten_with_path
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.serve import fixed_generate
from repro_torch.models.lm import LM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
B, S, GEN = 4, 12, 4
SERVE_SHAPES = ("prefill_32k", "decode_32k")
# the serve cells held to the JAX package spec for spec: these and the
# long_500k cells of the archs that decode it
SPEC_SHAPES = SERVE_SHAPES + ("long_500k",)
# the reference's fault, by cell: (arch, shape, mesh) whose body caches
# put the data axes on the period axis, or keep a state whole on every
# data rank
FINDING_2 = {(a, s, m) for a in ("mamba2-2.7b", "mixtral-8x7b",
                                 "recurrentgemma-9b")
             for s in SERVE_SHAPES for m in ("pod16x16", "pod2x16x16")}

JAX_SPECS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from repro.configs import SHAPES, get_config
    from repro.core.paths import path_str
    from repro.distributed import sharding
    from repro.launch.mesh import make_mesh
    from repro.models.lm import LM

    def entry(e):
        return list(e) if isinstance(e, tuple) else e

    out = {}
    for mname, (shape, axes) in json.loads(sys.argv[1]).items():
        mesh = make_mesh(tuple(shape), tuple(axes))
        for arch in json.loads(sys.argv[2]):
            cfg = get_config(arch)
            for sn in json.loads(sys.argv[3]):
                spec = SHAPES[sn]
                enc = 0
                if cfg.is_encdec:
                    enc = (spec.seq_len if spec.kind == "prefill"
                           else min(spec.seq_len, 32768))
                cache = LM(cfg).init_cache(spec.global_batch, spec.seq_len,
                                           enc_len=enc, abstract=True)
                flat = jax.tree_util.tree_flatten_with_path(
                    sharding.cache_shardings(cache, mesh),
                    is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))[0]
                out[f"{mname}/{arch}/{sn}"] = {
                    path_str(kp): [entry(e) for e in sh.spec]
                    for kp, sh in flat}
    print("SPECS " + json.dumps(out))
""")
PROD = {"pod16x16": ((16, 16), ("data", "model")),
        "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _abstract_cache(arch, shape_name):
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    enc = 0
    if cfg.is_encdec:
        enc = (spec.seq_len if spec.kind == "prefill"
               else min(spec.seq_len, 32768))
    return LM(cfg).init_cache(spec.global_batch, spec.seq_len, enc_len=enc,
                              abstract=True, device="meta")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gloo worlds and the JAX subprocess, started together; the
    one-process runs in this process meanwhile."""
    work = str(tmp_path_factory.mktemp("serve_mp"))
    archs = sorted(ARCHS)
    worlds = {name: torch_ranks.start(
        "serve_fixed", d * m, work, 300, data=d, model=m, archs=archs,
        batch=B, prompt=S, gen=GEN) for name, (d, m) in MESHES.items()}
    jax_proc = None
    if _has_jax():
        jax_proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SPECS, json.dumps(PROD),
             json.dumps(archs), json.dumps(SPEC_SHAPES)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu",
                               PYTHONPATH=os.path.join(ROOT, "src")))
    try:
        ref = {}
        for a in archs:
            model, params, tokens, frames = torch_ranks.serve_inputs(a, B, S)
            ref[a] = fixed_generate(model, params, tokens, GEN, frames=frames)
        got = {name: w.wait()[0] for name, w in worlds.items()}
        jspecs = None
        if jax_proc is not None:
            out, err = jax_proc.communicate(timeout=300)
            assert jax_proc.returncode == 0, out[-2000:] + err[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("SPECS ")]
            jspecs = json.loads(line[-1][len("SPECS "):])
    finally:
        if jax_proc is not None and jax_proc.poll() is None:
            jax_proc.kill()
    return ref, got, jspecs


def _has_jax() -> bool:
    try:
        import jax  # noqa: F401
    except ImportError:
        return False
    return True


CASES = [(m, a) for m in MESHES for a in sorted(ARCHS)]


@pytest.mark.parametrize("mesh,arch", CASES)
def test_ranks_give_one_process_tokens(runs, mesh, arch):
    ref, got, _ = runs
    assert torch.equal(got[mesh][arch]["tokens"], ref[arch][0]), (
        got[mesh][arch]["tokens"], ref[arch][0])


@pytest.mark.parametrize("mesh,arch", CASES)
def test_gathered_cache_matches_one_process(runs, mesh, arch):
    ref, got, _ = runs
    want = dict(flatten_with_path(ref[arch][1]))
    for p, t in flatten_with_path(got[mesh][arch]["cache"]):
        w = want[p]
        assert t.shape == w.shape and t.dtype == w.dtype, p
        if not w.is_floating_point():
            assert torch.equal(t, w), p
            continue
        tol = 1e-5 if (p.endswith("state/h") and "ssm" in _kinds(arch)) \
            else 2e-6
        amax = float(w.abs().max())
        err = float((t.float() - w.float()).abs().max())
        assert err <= tol * amax, (p, err, amax)


def _kinds(arch):
    return set(get_config(arch, smoke=True).layer_kinds)


@pytest.mark.parametrize("arch", [
    pytest.param(a, id=f"1x2-head_dim-{a}")
    for a in ("qwen2-0.5b", "minicpm3-4b", "mamba2-2.7b")])
def test_model_axis_splits_last_dim(runs, arch):
    """On (1, 2) every cache leaf but ``pos`` splits its last dim (head_dim,
    MLA's latent and rope dims, SSD's state dim) over the model axis, and
    decode sums partial scores or state products over the model group."""
    _, got, _ = runs
    r = got["1x2"][arch]
    for p, (data, model_dim) in r["layout"].items():
        assert data is None
        assert model_dim == (None if p.endswith("/pos") else -1), p
    label = ("model/all_reduce/partial/ssd" if arch.startswith("mamba")
             else "model/all_reduce/partial/scores")
    assert r["stats"][label]["calls"] > 0
    assert torch.equal(r["tokens"], runs[0][arch][0])


@pytest.mark.parametrize("arch", [
    pytest.param(a, id=f"2x2-period-{a}")
    for a in ("qwen2-0.5b", "mixtral-8x7b", "seamless-m4t-large-v2")])
def test_period_axis_on_data(runs, arch):
    """Two periods on two data ranks: the body caches put the data axes on
    their period axis; each layer's rows move through ``cache/reshard``."""
    ref, got, _ = runs
    r = got["2x2"][arch]
    body = {p: lay for p, lay in r["layout"].items()
            if p.startswith("body/") and not p.endswith("/pos")}
    assert body and all(lay[0] == "period" for lay in body.values()), body
    assert r["stats"]["cache/reshard"]["bytes"] > 0
    assert torch.equal(r["tokens"], ref[arch][0])


@pytest.mark.parametrize("arch", [
    pytest.param(a, id=f"2x2-data-replicated-{a}")
    for a in ("recurrentgemma-9b", "mamba2-2.7b")])
def test_body_state_whole_on_data(runs, arch):
    """One or three periods on two data ranks: the body's recurrent states
    split over no data axis (every data rank holds every row); each rank
    computes its rows and the rows written are gathered back."""
    ref, got, _ = runs
    r = got["2x2"][arch]
    states = {p: lay for p, lay in r["layout"].items()
              if p.startswith("body/") and "/state/" in p}
    assert states and all(lay[0] is None for lay in states.values()), states
    assert r["stats"]["cache/reshard"]["bytes"] > 0
    assert torch.equal(r["tokens"], ref[arch][0])


@pytest.mark.parametrize("mesh", sorted(PROD))
def test_cache_shardings_match_jax_spec_for_spec(runs, mesh):
    """The port's ``cache_shardings`` on the production meshes, every leaf
    of every serve cell (the eight ``long_500k`` cells included), against
    the JAX package's, fault included."""
    _, _, jspecs = runs
    if jspecs is None:
        pytest.skip("the JAX package's runtime is not installed")
    pmesh = make_production_mesh(multi_pod=mesh == "pod2x16x16")
    long = 0
    for arch in sorted(ARCHS):
        for sn in SPEC_SHAPES:
            if not shape_applicable(get_config(arch), sn)[0]:
                continue
            long += sn == "long_500k"
            want = jspecs[f"{mesh}/{arch}/{sn}"]
            got = sharding.cache_shardings(_abstract_cache(arch, sn), pmesh)
            got = {p: [list(e) if isinstance(e, tuple) else e
                       for e in s.spec] for p, s in flatten_with_path(got)}
            assert got.keys() == want.keys(), (arch, sn)
            for p, spec in want.items():
                pad = spec + [None] * (len(got[p]) - len(spec))
                assert got[p] == pad, (arch, sn, p, got[p], spec)
    assert long == 4


def test_reference_body_fault_cells():
    """The 12 serve cells of the production meshes whose body caches the
    reference's ``cache_shardings`` splits over the period axis
    (mamba2-2.7b's 64 and mixtral-8x7b's 32 periods) or over no data axis
    (recurrentgemma-9b's 12-period states): ``sharding.cache_layout``
    names them, and every other serve cell's body caches split their
    batch."""
    found = set()
    for mesh in ("pod16x16", "pod2x16x16"):
        pmesh = make_production_mesh(multi_pod=mesh == "pod2x16x16")
        for arch in sorted(ARCHS):
            for sn in SERVE_SHAPES:
                lay = sharding.cache_layout(_abstract_cache(arch, sn), pmesh)
                body = [v.data for p, v in lay.items()
                        if p.startswith("body/") and not p.endswith("/pos")]
                if any(d != "batch" for d in body):
                    found.add((arch, sn, mesh))
                    assert {d for d in body} <= {"period", None, "batch"}
    assert found == FINDING_2, sorted(found ^ FINDING_2)


def test_cache_block_names_each_rank_block():
    """``cache_block`` of a body k cache on the (2, 2) mesh of a one-rank
    abstract run: the period axis on data, head_dim on the model axis."""
    from repro_torch.distributed import runtime
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(2, 2)
    shape = (2, 4, 16, 2, 16)
    spec = sharding.P("data", None, None, None, "model")
    for rank in range(4):
        with runtime.abstract(mesh, rank):
            d, m = divmod(rank, 2)
            assert sharding.cache_block(shape, spec, mesh) == (
                (d, 1), (0, 4), (0, 16), (0, 2), (8 * m, 8))
