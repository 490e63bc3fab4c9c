"""The port's distribution layer against the JAX package's, on the CPU.

* Specs: every spec function of ``repro_torch.distributed.sharding`` held
  against ``repro.distributed.sharding`` element for element, on the
  reference tests' fake meshes and, for the ten archs' full configs, on
  ``AbstractMesh`` (16, 16), (2, 16, 16) and (4, 2) against the port's
  ``make_production_mesh`` / ``make_mesh``: every parameter leaf, every
  leaf of an abstract trainer state (the JAX dry run's trainer) and every
  decode-cache leaf.
* Multi-rank cases (``tests/torch_ranks.py``): gloo ranks, one subprocess
  each, under a timeout: the compressed all-reduce bit-equal to the JAX
  function under ``jax.vmap`` (4 ranks); the reference's 2x2 sharded bank
  with its asserts, bit-equal to the port's one-process run and, from one
  state, within ``tests/test_torch_trainer.py``'s tolerance of the JAX
  run; a mixed bank under both backends and the looped engine, bit-equal
  to one process; the elastic restore onto other factorizations (4 ranks
  where the reference uses 8: (2, 2) -> (4, 1), (1, 4) and one process);
  the training CLI on 2 ranks against 1.
"""
import json
import os
import shutil
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.distributed.sharding as jsh  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.device import DeviceConfig as JDev  # noqa: E402
from repro.core.digital_opt import DigitalOptConfig as JOpt  # noqa: E402
from repro.core.digital_opt import ScheduleConfig as JSched  # noqa: E402
from repro.core.tile import TileConfig as JTile  # noqa: E402
from repro.core.trainer import AnalogTrainer as JTrainer  # noqa: E402
from repro.core.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.distributed.compression import compressed_psum_mean as jcpm  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.paths import flatten_with_path  # noqa: E402
from repro_torch.core.trainer import AnalogTrainer, TrainerConfig  # noqa: E402
from repro_torch.core.digital_opt import DigitalOptConfig, ScheduleConfig  # noqa: E402
from repro_torch.distributed import compression, sharding as sh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

import torch_ranks  # noqa: E402

P = sh.P


def _same(port_spec, jax_spec, ndim=None):
    """Element for element, trailing Nones padded to ``ndim``."""
    a, b = tuple(port_spec), tuple(jax_spec)
    n = max(len(a), len(b), ndim or 0)
    return a + (None,) * (n - len(a)) == b + (None,) * (n - len(b))


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 4, "model": 8}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 4, "model": 8}


# ---------------------------------------------------------------------------
# specs: the reference's cases
# ---------------------------------------------------------------------------


def test_mesh_axes_and_grid():
    m = tmesh.make_host_mesh(2, 1, pods=2)
    assert m.axis_names == ("pod", "data", "model") and m.size == 4
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).axis_names \
        == ("pod", "data", "model")
    m = tmesh.make_mesh((2, 3, 4), ("pod", "data", "model"))
    assert m.coords_of(23) == {"pod": 1, "data": 2, "model": 3}
    assert m.index(("pod", "data"), m.coords_of(23)) == 5
    with pytest.raises(RuntimeError, match="world size"):
        m.coords()   # no process group in this process


def test_param_spec_rules_and_fallback():
    spec = sh.param_spec("stack/body/p0/mlp/wi", (24, 896, 4864),
                         tmesh.make_host_mesh(1, 1))
    assert spec == P(None, None, None)
    cases = [("attn/wq", (30, 64), False, P(None, "model")),
             ("attn/wq", (30, 20), False, P(None, None)),
             ("mlp/wi", (32, 64), True, P("data", "model"))]
    for path, shape, zero, want in cases:
        got = sh.param_spec(path, shape, FakeMesh(), zero=zero)
        assert got == want
        assert _same(got, jsh.param_spec(path, shape, FakeMesh(), zero=zero))


def test_rule_template_tags_and_merge_specs():
    for path, nd in (("l0/attn/wq", 2), ("l0/attn/wo", 2),
                     ("stack/body/p0/mlp/wi", 3), ("unmatched", 2)):
        assert sh.rule_template(path, nd) == jsh.rule_template(path, nd)
        assert sh.template_tag(sh.rule_template(path, nd)) \
            == jsh.template_tag(jsh.rule_template(path, nd))
    assert sh.template_tag(()) == "s"
    for specs in ([("data", None, "model"), ("data", "model", None)],
                  [("data", None, "model")], [(("pod", "data"), None)]):
        got = sh.merge_specs([P(*s) for s in specs])
        assert _same(got, jsh.merge_specs([JP(*s) for s in specs]))
    assert sh.merge_specs([P("data", None, "model"), P("data", "model", None)]) \
        == P("data", None, None)


def test_grouped_tile_spec_stack_axis_and_multi_pod():
    cases = [(("attn/wq",), (8, 30, 64), True, P("data", None, "model")),
             (("attn/wq",), (3, 32, 64), True, P(None, "data", "model")),
             (("attn/wq",), (3, 30, 64), False, P(None, None, "model")),
             (("attn/wq", "mlp/wi"), (8, 30, 64), True,
              P("data", None, "model"))]
    for paths, shape, zero, want in cases:
        got = sh.grouped_tile_spec(paths, shape, FakeMesh(), zero=zero)
        assert got == want
        assert _same(got, jsh.grouped_tile_spec(paths, shape, FakeMesh(),
                                                zero=zero))
    got = sh.grouped_tile_spec(("attn/wq",), (16, 32, 64), FakePodMesh(),
                               zero=True)
    assert got == P(("pod", "data"), None, "model")
    assert _same(got, jsh.grouped_tile_spec(("attn/wq",), (16, 32, 64),
                                            FakePodMesh(), zero=True))


def test_grouped_tile_spec_warns_once_per_mixed_stack():
    sh._MIXED_RULE_WARNED.clear()
    with pytest.warns(UserWarning, match=r"attn/wo.*attn/wq"):
        spec = sh.grouped_tile_spec(("attn/wo", "attn/wq"), (8, 64, 64),
                                    FakeMesh(), zero=False)
    assert spec == P(None, None, None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sh.grouped_tile_spec(("attn/wo", "attn/wq"), (8, 64, 64), FakeMesh(),
                             zero=False)
    # another offending stack warns again
    with pytest.warns(UserWarning, match=r"mlp/wi.*mlp/wo"):
        sh.grouped_tile_spec(("mlp/wo", "mlp/wi"), (8, 64, 64), FakeMesh())


def test_cache_spec_long_context_and_batch_specs():
    tree = {"kv": {"k": torch.empty((1, 524288, 4, 256), device="meta"),
                   "pos": torch.empty((524288,), device="meta")}}
    jtree = {"kv": {"k": jax.ShapeDtypeStruct((1, 524288, 4, 256), jnp.bfloat16),
                    "pos": jax.ShapeDtypeStruct((524288,), jnp.int32)}}
    mesh = tmesh.make_production_mesh()
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    got = sh.cache_shardings(tree, mesh)
    want = jsh.cache_shardings(jtree, jmesh)
    assert got["kv"]["k"].spec == P(None, "data", None, "model")
    for k in ("k", "pos"):
        assert _same(got["kv"][k].spec, want["kv"][k].spec)
    batch = {"tokens": torch.empty((256, 4096)), "pos": torch.empty(())}
    jb = {"tokens": jax.ShapeDtypeStruct((256, 4096), jnp.int32),
          "pos": jax.ShapeDtypeStruct((), jnp.int32)}
    got, want = sh.batch_shardings(batch, mesh), jsh.batch_shardings(jb, jmesh)
    for k in batch:
        assert _same(got[k].spec, want[k].spec)
    assert sh.logical_rules(mesh)[1] == jsh.logical_rules(jmesh)[1]
    assert all(s.spec == P() for s in sh.replicated(batch, mesh).values())


def test_placements_nest_like_dtensor():
    from torch.distributed.tensor import Replicate, Shard

    m = tmesh.make_production_mesh(multi_pod=True)
    assert sh.placements(m, P(("pod", "data"), None, "model")) \
        == (Shard(0), Shard(0), Shard(2))
    assert sh.placements(m, P(None, "model")) \
        == (Replicate(), Replicate(), Shard(1))
    assert sh.local_shape((64, 32, 48), P(("pod", "data"), None, "model"),
                          m) == (2, 32, 3)


def test_model_hints_resolve_as_jax():
    from repro.models import common as jcommon

    mesh = tmesh.make_mesh((4, 8), ("data", "model"))
    rules = sh.logical_rules(mesh)
    jrules = (AbstractMesh((4, 8), ("data", "model")), rules[1])
    x = torch.zeros((8, 16, 24))
    assert common.constrain(x, "batch", None, "mlp") is x
    assert common.hint_spec(x.shape, ("batch", None, "mlp"), rules) \
        == ("data", None, "model")
    assert common.hint_spec((6, 16, 20), ("batch", None, "mlp"), rules) is None
    assert common.hint_spec(x.shape, ("batch",), None) is None
    q = torch.zeros((4, 5, 16, 8))
    assert common.constrain_attention_q(q) is q
    assert common.attention_q_spec(q.shape, rules) == ("data", None, "model",
                                                       None)
    assert common.attention_q_spec((4, 5, 12, 8), rules) is None
    # the JAX hints only install rules here; the resolution is the port's own
    jcommon.set_shard_rules(None)
    common.set_shard_rules(rules)
    try:
        assert common.hint_spec(x.shape, ("batch", None, "mlp")) \
            == ("data", None, "model")
    finally:
        common.set_shard_rules(None)
    assert jrules[1] == rules[1]


# ---------------------------------------------------------------------------
# specs: the ten archs' full configs on the production meshes
# ---------------------------------------------------------------------------

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model"))]


def _jax_trainer():
    """The JAX dry run's LM trainer (``repro.launch.dryrun.make_trainer``),
    built without importing that module (it pins XLA_FLAGS at import)."""
    dev = JDev(kind="softbounds", dw_min=1e-4, sigma_d2d=0.1, sigma_pm=0.3,
               sigma_c2c=0.05)
    dev_p = JDev(kind="softbounds", dw_min=1e-4, sigma_d2d=0.1, sigma_pm=0.3,
                 sigma_c2c=0.05, ref_mean=0.1, ref_std=0.1)

    def tile(a):
        return JTile(algorithm=a, device_p=dev_p, device_w=dev,
                     state_dtype=jnp.bfloat16, store_device=False, rng="hash",
                     lr_p=0.5, lr_w=0.05, gamma=0.1, eta=0.5, chopper_p=0.05)

    cfg = JTrainerConfig(digital=JOpt(kind="sgdm", clip_norm=0.0),
                         schedule=JSched(kind="cosine", base_lr=0.1,
                                         total_steps=10000))
    return JTrainer(lambda p, b, r: (0.0, {}), cfg,
                    plan=japi.plan_from_spec("erider", tile))


def _port_trainer():
    cfg = TrainerConfig(digital=DigitalOptConfig(kind="sgdm"),
                        schedule=ScheduleConfig(kind="cosine", base_lr=0.1,
                                                total_steps=10000))
    return AnalogTrainer(lambda p, b, r: (0.0, {}), cfg,
                         plan=api.plan_from_spec(
                             "erider", lambda a: train.make_tile_cfg(a, False)))


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    from repro.core.paths import path_str

    return {path_str(kp): s.spec for kp, s in flat}


def _check(port_tree, jax_tree, label):
    got = {p: s.spec for p, s in flatten_with_path(port_tree)}
    want = _jax_specs(jax_tree)
    assert list(got) == list(want), label
    for p in got:
        assert _same(got[p], want[p]), (label, p, got[p], want[p])
    return len(got)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_config_specs_match_jax(arch):
    """params_shardings, state_shardings (the abstract grouped state of the
    dry run's trainer) and cache_shardings (decode 32k; long 500k where the
    arch decodes it) on the 16x16, 2x16x16 and 4x2 meshes."""
    from repro.configs import shape_applicable

    jcfg, cfg = jget(arch), get_config(arch)
    jparams = JLM(jcfg).abstract_params()
    params = LM(cfg).abstract_params("meta")
    jst = _jax_trainer().abstract_state(jparams)
    st = _port_trainer().abstract_state(params, "meta")
    caches = []
    for name, (b, s) in (("decode_32k", (128, 32768)), ("long_500k", (1, 524288))):
        if not shape_applicable(jcfg, name)[0]:
            continue
        enc = min(s, 32768) if jcfg.is_encdec else 0
        caches.append((name,
                       LM(cfg).init_cache(b, s, enc_len=enc, abstract=True,
                                          device="meta"),
                       JLM(jcfg).init_cache(b, s, enc_len=enc, abstract=True)))
    n = 0
    for shape, axes in MESHES:
        jmesh, mesh = AbstractMesh(shape, axes), tmesh.make_mesh(shape, axes)
        label = f"{arch} {shape}"
        n += _check(sh.params_shardings(params, mesh),
                    jsh.params_shardings(jparams, jmesh), label + " params")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            n += _check(sh.state_shardings(st, mesh),
                        jsh.state_shardings(jst, jmesh), label + " state")
        for name, c, jc in caches:
            n += _check(sh.cache_shardings(c, mesh),
                        jsh.cache_shardings(jc, jmesh), f"{label} {name}")
    assert n > 0


def test_state_shardings_grouped_smoke():
    """A spec for every leaf of a grouped state (one rank: replicated)."""
    tr = _port_trainer()
    params = LM(get_config("qwen2-0.5b", smoke=True)).abstract_params("meta")
    st = tr.abstract_state(params, "meta")
    specs = sh.state_shardings(st, tmesh.make_host_mesh(1, 1))
    assert len(flatten_with_path(specs)) == len(flatten_with_path(st))
    assert all(all(e is None for e in s.spec)
               for _, s in flatten_with_path(specs))


# ---------------------------------------------------------------------------
# multi-rank cases (gloo, one subprocess per rank)
# ---------------------------------------------------------------------------


def test_compressed_allreduce_matches_jax_bit_for_bit(tmp_path):
    """Four ranks, a ragged length (1000 = 3 blocks of 256 + 232): the mean
    and the error feedback bit-equal to the JAX function's, with and
    without an error buffer; the reference's bounds hold."""
    rs = np.random.RandomState(0)
    g = rs.randn(4, 1000).astype(np.float32)
    e = (0.01 * rs.randn(4, 1000)).astype(np.float32)
    torch.save(torch.from_numpy(g), tmp_path / "x.pt")
    torch.save(torch.from_numpy(e), tmp_path / "e.pt")
    res = torch_ranks.run("compress", 4, str(tmp_path), timeout=120,
                          x_file=str(tmp_path / "x.pt"),
                          err_file=str(tmp_path / "e.pt"))
    f = jax.vmap(lambda x: jcpm(x, "data"), axis_name="data")
    m, err = f(jnp.asarray(g))
    m2, err2 = f(jnp.asarray(g + e))
    for r, out in enumerate(res):
        assert out["route"] == "direct"
        np.testing.assert_array_equal(out["mean"].numpy(), np.asarray(m[r]))
        np.testing.assert_array_equal(out["err"].numpy(), np.asarray(err[r]))
        np.testing.assert_array_equal(out["fb_mean"].numpy(), np.asarray(m2[r]))
        np.testing.assert_array_equal(out["fb_err"].numpy(), np.asarray(err2[r]))
    scale = float(np.abs(g).max()) / 127
    assert float(np.abs(res[0]["mean"].numpy() - g.mean(0)).max()) < 3 * scale
    assert float(np.abs(res[0]["err"].numpy()).max()) <= 1.01 * scale
    # one process: the int8 round trip of quantize/dequantize
    q, s, n = compression.quantize_int8(torch.from_numpy(g[0]))
    back = compression.dequantize_int8(q, s, n)
    assert float((back - torch.from_numpy(g[0])).abs().max()) <= float(s.max())


def _carried_ref_state(tmp_path):
    """The JAX package's init of the reference 2x2 bank, carried over."""
    jdev = JDev(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.05)
    cfg = JTrainerConfig(tile=JTile(algorithm="erider", device_p=jdev,
                                    device_w=jdev),
                         digital=JOpt(kind="sgd"),
                         schedule=JSched(kind="constant", base_lr=0.1))

    def loss(params, batch, rng):
        return sum(jnp.sum(v ** 2) for _, v in sorted(params.items())), {}

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtr = JTrainer(loss, cfg, analog_filter=lambda p, l: True)
    params = {}
    for i in range(2):
        params[f"l{i}/attn/wq"] = 0.1 * jnp.ones((8, 8))
        params[f"l{i}/attn/wo"] = 0.1 * jnp.ones((8, 8))
    js = jtr.init(jax.random.PRNGKey(0), params)
    bank = js["tiles"]
    from repro.core import plan as jplan

    ts = convert.train_state({
        "step": js["step"], "key": js["key"],
        "params": jax.tree.map(np.asarray, js["params"]),
        "opt": jax.tree.map(np.asarray, js["opt"]),
        "tiles": {"classes": {c: jax.tree.map(np.asarray, s)
                              for c, s in bank.classes.items()},
                  "index": bank.index, "class_index": bank.class_index,
                  "policies": {g: jplan.policy_to_json(p)
                               for g, p in (bank.policies or {}).items()}},
    }, "cpu")
    path = tmp_path / "carried.pt"
    torch.save(ts, path)
    step = jtr.jit_step(donate=False)
    jm = []
    for _ in range(2):
        js, m = step(js, jnp.zeros(()))
        jm.append(m)
    return str(path), js, jm


def test_sharded_tile_bank_2x2(tmp_path):
    """The reference's 2x2 (data, model) case on four ranks: the group and
    class names, the specs it asserts, tile bytes per rank <= total / 2 +
    1024; two steps from the JAX init, gathered, bit-equal to the port's
    one-process steps and within test_torch_trainer's tolerance of the JAX
    run (loss rtol 1e-5; W within 1e-5 but for <= 0.1 % flipped pulses)."""
    state_file, js, jm = _carried_ref_state(tmp_path)
    res = torch_ranks.run("bank", 4, str(tmp_path), timeout=150, data=2,
                          model=2, kind="ref", state_file=state_file)
    r0 = res[0]
    cname = "g8x8_float32_Mn+g8x8_float32_nM"
    assert set(r0["names"]) == {"g8x8_float32_nM", "g8x8_float32_Mn"}
    assert r0["classes"] == [cname]
    assert r0["specs"][f"tiles/{cname}/W"] == (None, "data", None, None)
    assert r0["specs"][f"tiles/{cname}/t"] == (None, None)
    assert r0["shapes_ok"]
    assert r0["per_rank"] <= r0["total"] / 2 + 1024, (r0["per_rank"],
                                                      r0["total"])
    got = dict(flatten_with_path(r0["state"]))
    for other in res[1:]:
        for p, v in flatten_with_path(other["state"]):
            assert torch.equal(v, got[p]), p
    for p, v in flatten_with_path(r0["one_state"]):
        assert torch.equal(got[p], v), p
    for a, b in zip(r0["metrics"], r0["one_metrics"]):
        assert {k: float(v) for k, v in a.items()} \
            == {k: float(v) for k, v in b.items()}
    assert np.isfinite(float(r0["metrics"][-1]["loss"]))
    np.testing.assert_allclose(float(r0["metrics"][-1]["loss"]),
                               float(jm[-1]["loss"]), rtol=1e-5)
    want = np.asarray(js["tiles"].classes[cname]["W"])
    diff = np.abs(got[f"tiles/{cname}/W"].numpy() - want)
    off = diff > 1e-5
    assert off.mean() <= 1e-3 and np.all(diff[off] >= 1e-3), diff.max()


@pytest.mark.parametrize("backend,engine", [("vmap", "grouped"),
                                            ("fused", "grouped"),
                                            ("vmap", "looped")])
def test_mixed_bank_sharded_steps_equal_one_process(tmp_path, backend, engine):
    """Stack rows with the model axis on a member dim (gathered whole for the
    update), a stack that does not divide (every rank updates it whole),
    a class that divides only flattened ('fused'), Adam moments ZeRO-
    sharded with clipping, a batch split over the data axis: two steps on
    a (2, 2) mesh, gathered, bit-equal to one process, metrics equal."""
    res = torch_ranks.run("bank", 4, str(tmp_path), timeout=150, data=2,
                          model=2, kind="mixed", backend=backend,
                          engine=engine)
    r0 = res[0]
    assert r0["shapes_ok"] and r0["per_rank"] < r0["total"] / 2
    if engine == "grouped":
        specs = r0["specs"]
        assert specs["tiles/g8x16_float32_nM/W"] == (None, "data", None, "model")
        assert specs["tiles/g8x12_float32_nM/W"] == (None, None, "data", "model")
        assert specs["opt/mu/embed"] == ("model", "data")
    got = dict(flatten_with_path(r0["state"]))
    for p, v in flatten_with_path(r0["one_state"]):
        assert torch.equal(got[p], v), p
    for a, b in zip(r0["metrics"], r0["one_metrics"]):
        assert {k: float(v) for k, v in a.items()} \
            == {k: float(v) for k, v in b.items()}


def test_elastic_restore_onto_other_meshes(tmp_path):
    """Saved from a (2, 2) mesh, restored onto (4, 1), (1, 4) and one
    process: bit-equal; the array files byte-equal to a one-process save
    of the same state, the manifests equal but for "time". On the same
    ranks, ``constrain_stacked`` and ``shard_stacked_call`` cut each
    rank's block."""
    state_file, _, _ = _carried_ref_state(tmp_path)
    res = torch_ranks.run("elastic", 4, str(tmp_path), timeout=150, data=2,
                          model=2, directory=str(tmp_path / "ck"),
                          state_file=state_file)
    x = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    whole = torch.load(state_file, weights_only=False)
    stack = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    for out in res:
        # constrain_stacked: the stack on "data", wq's columns on "model";
        # per-tile scalars whole. shard_stacked_call: this rank's rows.
        coords = out.pop("coords")
        d, m = coords["data"], coords["model"]
        c = out.pop("constrained")
        assert torch.equal(c["W"], stack[2 * d:2 * d + 2, :, 3 * m:3 * m + 3])
        assert torch.equal(c["t"], torch.arange(4))
        assert torch.equal(out.pop("rows"), 2 * stack[2 * d:2 * d + 2])
        assert out.pop("odd") is None
    for r, out in enumerate(res):
        for (data, model), got in out.items():
            assert got["x_local"] == (64 // data, 32 // model)
            assert torch.equal(got["x"], x)
            for p, v in flatten_with_path(whole):
                assert torch.equal(dict(flatten_with_path(got["state"]))[p],
                                   v), (data, model, p)
    one = _port_ref_trainer()
    template = one.abstract_state(torch_ranks.bank_params("ref", "meta"),
                                  "cpu")
    back = ckpt.restore(template, str(tmp_path / "ck" / "state"), verify=True)
    for p, v in flatten_with_path(whole):
        assert torch.equal(dict(flatten_with_path(back))[p], v), p
    ckpt.save(whole, str(tmp_path / "one"), step=1)
    a = tmp_path / "ck" / "state" / "step_000000001"
    b = tmp_path / "one" / "step_000000001"
    files = sorted(f for f in os.listdir(b) if f.endswith(".npz"))
    assert files and files == sorted(f for f in os.listdir(a)
                                     if f.endswith(".npz"))
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    assert ma.pop("time") and mb.pop("time") and ma == mb


def _port_ref_trainer():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return torch_ranks._bank_trainer(None)


CLI_ARGV = ["--smoke", "--steps", "3", "--batch", "4", "--seq", "16",
            "--device", "cpu", "--log-every", "1", "--ckpt-every", "3"]


def test_cli_data_parallel_matches_one_rank(tmp_path):
    """``--data-parallel 2`` on the smoke LM, two gloo ranks: loss and
    sp_err within rtol 1e-6 of the one-rank run at each of 3 steps (each
    rank's forward sums over its own rows: float32 ULPs); every float
    leaf within 1e-6. Its checkpoint restores bit-equal in the one-rank
    CLI."""
    res = torch_ranks.run("cli", 2, str(tmp_path), timeout=200,
                          argv=CLI_ARGV + ["--data-parallel", "2",
                                           "--ckpt-dir", str(tmp_path / "ck")])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # as the ranks run
    try:
        state, hist = train.main(CLI_ARGV + ["--ckpt-dir",
                                             str(tmp_path / "one")])
        shutil.copytree(tmp_path / "ck", tmp_path / "ck2", symlinks=True)
        back, h2 = train.main(CLI_ARGV + ["--ckpt-dir", str(tmp_path / "ck2")])
    finally:
        torch.set_num_threads(threads)
    assert len(res[0]["history"]) == len(hist) == 3 and h2 == []
    for a, b in zip(res[0]["history"], hist):
        for k in ("loss", "tile/sp_err", "tile/pulses"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    assert res[0]["history"][-1]["loss"] < res[0]["history"][0]["loss"]
    two = dict(flatten_with_path(res[0]["state"]))
    assert all(torch.equal(two[p], v)
               for p, v in flatten_with_path(res[1]["state"]))
    for p, v in flatten_with_path(state):
        if v.is_floating_point():
            assert float((two[p].float() - v.float()).abs().max()) <= 1e-6, p
    for p, v in flatten_with_path(back):
        assert torch.equal(two[p], v), p


MOE_ARGV = ["--arch", "mixtral-8x7b", "--smoke", "--steps", "3", "--batch",
            "4", "--seq", "128", "--device", "cpu", "--log-every", "1"]


def test_cli_data_parallel_moe_matches_one_rank(tmp_path):
    """``--data-parallel 2`` on the smoke MoE (mixtral), two gloo ranks, at
    a global batch of 512 tokens: the einsum dispatch with the global
    batch's groups and capacity (each rank's 256 tokens alone would take
    the gather path), and the load-balance loss of the global batch's
    router fractions (one all-reduce of them per MoE layer). Loss, moe_aux
    and sp_err within rtol 1e-6 of the one-rank run at each of 3 steps,
    every float leaf within 1e-6, as for the dense LM."""
    res = torch_ranks.run("cli", 2, str(tmp_path), timeout=200,
                          argv=MOE_ARGV + ["--data-parallel", "2"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # as the ranks run
    try:
        state, hist = train.main(MOE_ARGV)
    finally:
        torch.set_num_threads(threads)
    assert len(res[0]["history"]) == len(hist) == 3
    for a, b in zip(res[0]["history"], hist):
        for k in ("loss", "moe_aux", "tile/sp_err", "tile/pulses"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    two = dict(flatten_with_path(res[0]["state"]))
    for p, v in flatten_with_path(state):
        if v.is_floating_point():
            assert float((two[p].float() - v.float()).abs().max()) <= 1e-6, p


def test_moe_microbatches_over_data_ranks_match_one_process(tmp_path):
    """``microbatch=2`` under a data axis of 2 on the smoke MoE: each rank
    runs its share of every global microbatch (not its own rows cut in
    two), so each microbatch's router statistics are the one process's.
    Loss and moe_aux within rtol 1e-6 at both steps, every float leaf
    within 1e-6."""
    kw = dict(arch="mixtral-8x7b", batch=4, seq=128, microbatch=2, steps=2)
    res = torch_ranks.run("lm_micro", 2, str(tmp_path), timeout=200, **kw)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # as the ranks run
    try:
        one = torch_ranks.lm_micro(None, "cpu", **kw)
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(res[0]["history"], one["history"]):
        for k in ("loss", "moe_aux", "tile/sp_err"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    two = dict(flatten_with_path(res[0]["state"]))
    for p, v in flatten_with_path(one["state"]):
        if v.is_floating_point():
            assert float((two[p].float() - v.float()).abs().max()) <= 1e-6, p
