"""The port's graph contracts: per-rule units on synthetic records, then
the real entrypoints traced on ``meta``: clean on main, failing under
every planted mutation, the same verdicts as the JAX package's
``check_hlo`` on the rules both apply, and the train step's donation gap
pinned."""
import functools

import pytest
import torch

from repro_torch.analysis import GraphContract, check_trace
from repro_torch.analysis import graph_contracts as gc
from repro_torch.analysis.contracts import loosened
from repro_torch.roofline.op_common import OpRecord, TensorMeta


class _Trace:
    """Synthetic records in place of an OpTrace."""

    def __init__(self, records, flops=None, collectives=None):
        self.records = list(records)
        self.flops = flops or [0.0] * len(self.records)
        self.collectives = collectives or {}


def _t(shape, dtype="float32", device="meta"):
    return TensorMeta(tuple(shape), dtype, device)


ADD = OpRecord("aten.add.Tensor", (_t((4,)), _t((4,))), (_t((4,)),))


def _check(records, aliased=2, collectives=None, **kw):
    return check_trace(GraphContract(name="t", **kw),
                       _Trace(records, collectives=collectives), aliased)


def _rules(res):
    return sorted({v["rule"] for v in res.violations})


# ---------------------------------------------------------------------------
# per-rule units (records in, result out; nothing runs)
# ---------------------------------------------------------------------------


def test_clean_trace_passes():
    res = _check([ADD])
    assert res.ok, res.violations


def test_rank4_cat_is_a_restack():
    cat = OpRecord("aten.cat.default", (_t((1, 3, 8, 8)), _t((1, 3, 8, 8))),
                   (_t((2, 3, 8, 8)),))
    assert _rules(_check([cat, ADD])) == ["restack"]
    stack = cat._replace(name="aten.stack.default")
    assert _rules(_check([stack])) == ["restack"]
    # legitimate low-rank cats (grad stacking) don't count
    cat3 = cat._replace(inputs=(_t((1, 3, 8)),), outputs=(_t((2, 3, 8)),))
    assert _check([cat3]).ok
    # raising max_restacks admits it (and shows up as a loosenable knob)
    assert _check([cat], max_restacks=1).ok


def test_nothing_kept_in_place_violates_donation():
    assert _rules(_check([ADD], aliased=0)) == ["donation"]
    assert _check([ADD], aliased=0, require_donation=False).ok
    assert _rules(_check([ADD], aliased=1, min_aliased=2)) == ["donation"]


def test_kept_in_place_counts_written_state_leaves():
    state = {"a": torch.zeros(4), "b": torch.zeros(4), "c": torch.zeros(4)}
    written = {state["a"].untyped_storage()._cdata,
               state["b"].untyped_storage()._cdata}
    out = {"a": state["a"], "b": state["b"][:2], "c": torch.zeros(4)}
    assert gc.kept_in_place(state, out, written) == 2
    # a leaf passed through unwritten is not an in-place write
    assert gc.kept_in_place(state, {"c": state["c"]}, written) == 0


def test_oversized_copy_violates():
    big = OpRecord("aten.clone.default", (_t((1024,)),), (_t((1024,)),))
    res = _check([big, ADD], max_copy_bytes=1024)
    assert "copy" in _rules(res)
    assert res.stats["max_copy_bytes"] == 4096
    assert _check([big], max_copy_bytes=4096).ok
    # a cast is a new value, not a copy
    cast = OpRecord("aten._to_copy.default", (_t((1024,), "int64"),),
                    (_t((1024,)),))
    assert _check([cast], max_copy_bytes=8).ok


def test_host_reads_violate():
    read = OpRecord("aten._local_scalar_dense.default", (_t(()),), (),
                    host_read=True)
    assert "host-transfer" in _rules(_check([read, ADD]))
    down = OpRecord("aten._to_copy.default", (_t((4,), device="cuda"),),
                    (_t((4,), device="cpu"),), host_read=True)
    assert "host-transfer" in _rules(_check([down]))


def test_uploads_counted_under_their_ceiling():
    up = OpRecord("aten._to_copy.default", (_t((6, 2), "int64", "cpu"),),
                  (_t((6, 2), "int64"),), upload_bytes=96)
    res = _check([up, up])
    assert _rules(res) == ["upload"]
    assert (res.stats["uploads"], res.stats["upload_bytes"]) == (2, 192)
    assert _check([up, up], max_uploads=2).ok


def test_f64_violates_dtype_allowlist():
    rec = OpRecord("aten._to_copy.default", (_t((4,)),), (_t((4,), "float64"),))
    res = _check([rec, ADD])
    assert "dtype" in _rules(res)
    assert "float64" in res.stats["dtypes"]
    assert "dtype" in _rules(_check([ADD], allowed_dtypes=("bool",)))


def test_f64_cannot_be_allowlisted():
    with pytest.raises(ValueError, match="forbidden"):
        GraphContract(name="bad", allowed_dtypes=("float32", "float64"))
    with pytest.raises(ValueError, match="unknown"):
        GraphContract(name="bad", allowed_dtypes=("float32", "float99"))


def test_collective_bytes_ceiling():
    res = _check([ADD], collectives={"all_reduce": 1024.0})
    assert "collective-bytes" in _rules(res)  # default ceiling is 0
    assert _check([ADD], collectives={"all_reduce": 1024.0},
                  max_collective_bytes=1024.0).ok


def test_hbm_ceiling():
    res = _check([ADD], max_hbm_bytes=10.0)
    assert _rules(res) == ["hbm-bytes"]
    assert res.stats["hbm_bytes"] == 48.0
    res = check_trace(GraphContract(name="t", max_hbm_bytes=10.0),
                      _Trace([ADD]), 2, check_hbm=False)
    assert res.ok


def test_loosened_flags_raised_ceilings_and_grown_allowlists():
    base = GraphContract(name="t", max_hbm_bytes=1e6, max_copy_bytes=1024,
                         allowed_dtypes=("float32", "bool"),
                         min_aliased=4).limits_json()
    same = GraphContract(name="t", max_hbm_bytes=1e6, max_copy_bytes=1024,
                         allowed_dtypes=("float32", "bool"), min_aliased=4)
    assert loosened(same, base) == []
    looser = GraphContract(
        name="t", max_hbm_bytes=2e6, max_copy_bytes=4096,
        allowed_dtypes=("float32", "bool", "bfloat16"), min_aliased=1,
        require_donation=False, max_restacks=3, max_uploads=5)
    msgs = "\n".join(loosened(looser, base))
    for frag in ("max_hbm_bytes", "max_copy_bytes", "allowed_dtypes",
                 "min_aliased", "require_donation", "max_restacks",
                 "max_uploads"):
        assert frag in msgs, f"{frag} not flagged:\n{msgs}"
    tighter = GraphContract(name="t", max_hbm_bytes=5e5, max_copy_bytes=512,
                            allowed_dtypes=("float32",), min_aliased=8)
    assert loosened(tighter, base) == []


# ---------------------------------------------------------------------------
# the real entrypoints (traced on meta)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _run(name, mutant=None):
    return gc.run_contract(name, mutant)


def test_registry_covers_all_entrypoints():
    assert set(gc.CONTRACTS) == set(gc.ENTRYPOINTS)
    assert len(gc.CONTRACTS) == 7


@pytest.mark.parametrize("name", sorted(gc.ENTRYPOINTS))
def test_entrypoint_clean_on_main(name):
    res = _run(name)
    assert res.ok, res.violations


@pytest.mark.parametrize("mutant, rule", [
    ("restack", "restack"),
    ("host_transfer", "host-transfer"),
    ("f64", "dtype"),
    # the state copied whole trips the copy ceiling, and the step writes
    # the copy, so no leaf of the given state is kept: donation
    ("no_donate", "copy"),
])
def test_train_step_mutations_caught(mutant, rule):
    res = _run("train_step_fused", mutant)
    assert not res.ok
    assert rule in _rules(res), (mutant, res.violations)
    if mutant == "no_donate":
        assert "donation" in _rules(res), res.violations


@pytest.mark.parametrize("mutant, rule", [
    ("host_transfer", "host-transfer"),
    ("restack", "restack"),
    ("no_donate", "donation"),
])
def test_serve_step_mutations_caught(mutant, rule):
    res = _run("serve_step_lanes", mutant)
    assert not res.ok
    assert rule in _rules(res), (mutant, res.violations)


@pytest.mark.parametrize("name", sorted(gc.TRAIN_ENTRYPOINTS))
def test_train_entrypoints_write_out_of_place(name):
    """The train entrypoints no longer write out of place: they run the
    donated step, which returns the state it was given with every device
    leaf it changes written into its own storage (W, P, Q, t, prog, and c
    and Q~ on a flip), and touches no other device leaf. The serve
    entrypoints write their two page pools in place."""
    from repro_torch.core.paths import flatten_with_path
    from repro_torch.roofline.op_cost import OpTrace

    call, state_in = gc.ENTRYPOINTS[name](None, torch.device("meta"))
    before = {p: t.untyped_storage()._cdata
              for p, t in flatten_with_path(state_in)}
    with OpTrace() as tr:
        state_out = call()
    after = dict(flatten_with_path(state_out))
    assert set(after) == set(before)
    for p, t in after.items():
        assert t.untyped_storage()._cdata == before[p], p
    written = {p for p, t in after.items()
               if t.untyped_storage()._cdata in tr.written}
    slots = {p.rsplit("/", 1)[-1] for p in written}
    assert slots >= ({"prog", "Qt", "c"} if name == "begin_step" else
                     {"W", "P", "Qd", "t", "prog", "key", "step"}), slots
    assert not slots & {"scale", "gamma", "rho"}, slots
    assert gc.CONTRACTS[name].require_donation
    assert _run(name).stats["aliased_outputs"] == len(written) \
        == gc.CONTRACTS[name].min_aliased
    assert _run("serve_step_lanes").stats["aliased_outputs"] == 2


# the rules both packages apply: restacks (within each contract's own
# allowance), no float64, no host transfer. The JAX side leaves out what
# ROADMAP rule 7 lists as failing under jax 0.9.0 (the fused step and
# begin_step contracts, the f64 mutant).
SAME_VERDICT = [("serve_step_lanes", None), ("serve_step_lanes", "restack"),
                ("serve_step_lanes", "host_transfer"),
                ("prefill_commit_batch", None),
                ("train_step_scanned", None)]


def _verdict(res, f64_name):
    rules = _rules(res)
    return {"restack": "restack" in rules,
            "host-transfer": "host-transfer" in rules,
            "f64": f64_name in res.stats["dtypes"]}


@pytest.mark.parametrize("name, mutant", SAME_VERDICT)
def test_same_verdict_as_jax(name, mutant):
    jgc = pytest.importorskip("repro.analysis.graph_contracts")
    want = _verdict(jgc.run_contract(name, mutant), "f64")
    assert _verdict(_run(name, mutant), "float64") == want
    assert want["host-transfer"] == (mutant == "host_transfer")
    assert want["restack"] == (mutant == "restack")
    assert not want["f64"]
