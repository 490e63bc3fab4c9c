"""The port's checkpoints against the JAX package's, on the CPU.

* The reference's ``tests/test_checkpoint.py`` (7 tests) and the checkpoint
  cases of ``tests/test_plan.py`` and ``tests/test_tile_engine.py``
  replayed on the port: round trips, the legacy per-tile restore, the
  (shape, dtype) and policy re-keys in both directions, v3 -> v4
  bit-identical, the consolidated policy-mismatch warning, and
  ``abstract_state`` against ``init`` (paths, shapes, dtypes, devices).
* Cross-restore, bit-exact on every leaf, for the grouped, looped and
  mixed-plan layouts and for tiles that keep device seeds: a JAX
  checkpoint restores into the port (held to ``convert.train_state`` of
  the JAX state) and a port checkpoint restores into the JAX package.
* The port's manifest.json equals JAX's except ``time``, and every npz
  member holds the same bytes.
* bfloat16 leaves: written as JAX writes them (raw 2-byte records, manifest
  dtype "bfloat16"), read back by the port whichever package wrote them.
* ``save(asynchronous=True)`` snapshots the state before it returns.
"""
import dataclasses
import json
import os
import warnings
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core.device import DeviceConfig as JDev  # noqa: E402
from repro.core.digital_opt import DigitalOptConfig as JOpt  # noqa: E402
from repro.core.digital_opt import ScheduleConfig as JSched  # noqa: E402
from repro.core.paths import path_str  # noqa: E402
from repro.core.tile import TileConfig as JTile  # noqa: E402
from repro.core.trainer import AnalogTrainer as JTrainer  # noqa: E402
from repro.core.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.device import PRESETS, DeviceConfig  # noqa: E402
from repro_torch.core.digital_opt import DigitalOptConfig, ScheduleConfig  # noqa: E402
from repro_torch.core.paths import TensorSpec, flatten_with_path, tree_map  # noqa: E402
from repro_torch.core.plan import (AnalogPlan, TilePolicy,  # noqa: E402
                                   _reset_legacy_warning, policy_from_json,
                                   policy_to_json)
from repro_torch.core.tile import TileBank, TileConfig, group_name  # noqa: E402
from repro_torch.core.trainer import (HOST_LEAVES, AnalogTrainer,  # noqa: E402
                                      TrainerConfig, merge_effective,
                                      partition_params)

LIFETIME_KEYS = ("drift_nu", "drift_nu_std", "drift_t0", "prog_noise",
                 "prog_noise_slope", "prog_rounds", "read_noise")


def _loss_fn(params, batch, rng):
    return sum(torch.sum(v ** 2) for _, v in sorted(params.items())), {}


def _jloss_fn(params, batch, rng):
    return sum(jnp.sum(v ** 2) for _, v in sorted(params.items())), {}


def _step(trainer, state):
    return trainer.train_step(state, None)[0]


def _flat(tree):
    return {p: v.detach().cpu() for p, v in flatten_with_path(tree)}


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    for p in fa:
        assert fa[p].dtype == fb[p].dtype, p
        assert torch.equal(fa[p], fb[p]), p


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, replayed
# ---------------------------------------------------------------------------


def _tree(seed=0):
    k = prng.PRNGKey(seed)
    return {"a": prng.normal(k, (17, 33), "cpu"),
            "nested": {"b": torch.arange(10, dtype=torch.int32), "c": None,
                       "scalar": torch.tensor(3.5)}}


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(t, str(tmp_path), step=3)
    assert ckpt.latest_step(str(tmp_path)) == 3
    restored = ckpt.restore(_tree(99), str(tmp_path), verify=True)
    assert torch.equal(restored["a"], t["a"])
    assert torch.equal(restored["nested"]["b"], t["nested"]["b"])
    assert restored["nested"]["c"] is None


def test_async_save_and_latest(tmp_path):
    t = _tree()
    th = ckpt.save(t, str(tmp_path), step=1, asynchronous=True)
    th.join(timeout=30)
    assert not th.is_alive()
    ckpt.save(t, str(tmp_path), step=2)
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert os.path.islink(os.path.join(str(tmp_path), "latest"))


def test_restore_shape_mismatch_fails(tmp_path):
    ckpt.save(_tree(), str(tmp_path), step=1)
    bad = {"a": torch.zeros(5, 5),
           "nested": {"b": torch.zeros(10, dtype=torch.int32), "c": None,
                      "scalar": torch.tensor(0.0)}}
    with pytest.raises(ValueError, match="nested|a"):
        ckpt.restore(bad, str(tmp_path))


def _drift_trainer(plan=None):
    dev = PRESETS["pcm_gst"]
    pol = TilePolicy(TileConfig(algorithm="erider", device_p=dev, device_w=dev,
                                lr_p=0.5, lr_w=0.5), name="pcm")
    cfg = TrainerConfig(digital=DigitalOptConfig(kind="sgd"),
                        schedule=ScheduleConfig(kind="constant", base_lr=0.1))
    return AnalogTrainer(_loss_fn, cfg, plan=plan or AnalogPlan.of(("**", pol)))


def _strip_lifetime_keys(directory, step=1):
    path = os.path.join(directory, f"step_{step:09d}", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    for rec in manifest.get("tile_groups", {}).values():
        pol = rec.get("policy") or {}
        for dev_key in ("device_p", "device_w"):
            dev = pol.get("tile", {}).get(dev_key)
            if dev:
                for k in LIFETIME_KEYS:
                    dev.pop(k, None)
    with open(path, "w") as f:
        json.dump(manifest, f)
    return manifest


def test_pre_drift_checkpoint_restores_silently(tmp_path):
    trainer = _drift_trainer()
    state = trainer.init(prng.PRNGKey(0),
                         {"w": torch.ones(8, 8), "v": torch.ones(8, 8)})
    state = _step(trainer, state)
    ckpt.save(state, str(tmp_path), step=1)
    _strip_lifetime_keys(str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        restored = ckpt.restore(state, str(tmp_path))
    for p in ("w", "v"):
        assert torch.equal(restored["tiles"][p]["W"], state["tiles"][p]["W"]), p


def test_pre_drift_manifest_still_warns_on_real_mismatch(tmp_path):
    trainer = _drift_trainer()
    state = trainer.init(prng.PRNGKey(0), {"w": torch.ones(8, 8)})
    ckpt.save(state, str(tmp_path), step=1)
    manifest = _strip_lifetime_keys(str(tmp_path))
    path = os.path.join(str(tmp_path), "step_000000001", "manifest.json")
    for rec in manifest["tile_groups"].values():
        rec["policy"]["tile"]["device_w"]["dw_min"] = 0.4999
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.warns(UserWarning, match="policy"):
        ckpt.restore(state, str(tmp_path))


def test_lifetime_fields_survive_rekey_both_directions(tmp_path):
    pcm, om = PRESETS["pcm_gst"], PRESETS["reram_om"]
    pol_pcm = TilePolicy(TileConfig(algorithm="erider", device_p=pcm,
                                    device_w=pcm, lr_p=0.5, lr_w=0.5), name="pcm")
    pol_om = TilePolicy(TileConfig(algorithm="erider", device_p=om,
                                   device_w=om, lr_p=0.5, lr_w=0.5), name="om")
    for pol in (pol_pcm, pol_om):
        blob = policy_to_json(pol)
        assert blob["tile"]["device_w"]["drift_nu"] == pol.tile.device_w.drift_nu
        assert policy_from_json(blob) == pol

    params = {"w": torch.ones(8, 8), "v": torch.ones(8, 8)}
    single = _drift_trainer(AnalogPlan.of(("**", pol_pcm)))
    mixed = _drift_trainer(AnalogPlan.of(("w", pol_pcm), ("**", pol_om)))

    s_single = _step(single, single.init(prng.PRNGKey(1), params))
    ckpt.save(s_single, str(tmp_path / "a"), step=1)
    template = mixed.init(prng.PRNGKey(1), params)
    with pytest.warns(UserWarning, match="om"):
        restored = ckpt.restore(template, str(tmp_path / "a"))
    for p in params:
        assert torch.equal(restored["tiles"][p]["W"], s_single["tiles"][p]["W"])

    s_mixed = _step(mixed, mixed.init(prng.PRNGKey(2), params))
    ckpt.save(s_mixed, str(tmp_path / "b"), step=1)
    template = single.init(prng.PRNGKey(2), params)
    with pytest.warns(UserWarning, match="pcm"):
        restored = ckpt.restore(template, str(tmp_path / "b"))
    for p in params:
        assert torch.equal(restored["tiles"][p]["W"], s_mixed["tiles"][p]["W"])


def test_trainer_state_roundtrip(tmp_path):
    dev = DeviceConfig(dw_min=0.01, sigma_pm=0.3)
    cfg = TrainerConfig(tile=TileConfig(algorithm="erider", device_p=dev,
                                        device_w=dev),
                        digital=DigitalOptConfig(kind="sgdm"),
                        schedule=ScheduleConfig(base_lr=0.1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        trainer = AnalogTrainer(lambda p, b, r: (torch.sum(p["w"] ** 2), {}),
                                cfg, analog_filter=lambda p, leaf: True)
    state = _step(trainer, trainer.init(prng.PRNGKey(0), {"w": torch.ones(8, 8)}))
    ckpt.save(state, str(tmp_path), step=1)
    restored = ckpt.restore(state, str(tmp_path))
    _assert_trees_equal(_step(trainer, state), _step(trainer, restored))


# ---------------------------------------------------------------------------
# tests/test_plan.py checkpoint cases, replayed
# ---------------------------------------------------------------------------

DEV_A = DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.05)
DEV_B = DeviceConfig(dw_min=0.02, sigma_pm=0.5, sigma_d2d=0.1, sigma_c2c=0.1,
                     ref_mean=0.1, ref_std=0.1)
POL_A = TilePolicy(TileConfig(algorithm="erider", device_p=DEV_A, device_w=DEV_A,
                              lr_p=0.5, lr_w=0.5, gamma=0.1, eta=0.1,
                              chopper_p=0.1), name="pola")
POL_B = TilePolicy(TileConfig(algorithm="rider", device_p=DEV_B, device_w=DEV_A,
                              lr_p=0.5, lr_w=0.5, gamma=0.1, eta=0.2),
                   name="polb")
MIXED = AnalogPlan.of(("a/**", POL_A), ("b/**", POL_B))


def _plan_trainer(plan, **kw):
    cfg = TrainerConfig(digital=DigitalOptConfig(kind="sgd"),
                        schedule=ScheduleConfig(kind="constant", base_lr=0.1),
                        **kw)
    return AnalogTrainer(_loss_fn, cfg, plan=plan)


def _mixed_params():
    params = {}
    for i in range(2):
        params[f"a/l{i}/attn/wq"] = 0.1 * torch.ones(8, 8)
        params[f"b/l{i}/attn/wq"] = 0.1 * torch.ones(8, 8)
    return params


def test_legacy_constructor_shim_warns_exactly_once():
    _reset_legacy_warning()
    cfg = TrainerConfig(tile=POL_A.tile, digital=DigitalOptConfig(kind="sgd"),
                        schedule=ScheduleConfig(kind="constant", base_lr=0.1))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tr = AnalogTrainer(_loss_fn, cfg, analog_filter=lambda p, leaf: True)
        AnalogTrainer(_loss_fn, cfg, analog_filter=lambda p, leaf: True)
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)
           and "AnalogPlan" in str(w.message)]
    assert len(dep) == 1
    state = tr.init(prng.PRNGKey(0), {"w": 0.1 * torch.ones(8, 8)})
    _, m = tr.train_step(state, None)
    assert np.isfinite(float(m["loss"]))


def test_manifest_records_members_and_policies(tmp_path):
    state = _plan_trainer(MIXED).init(prng.PRNGKey(0), _mixed_params())
    ckpt.save(state, str(tmp_path), step=1)
    manifest = ckpt.read_manifest(str(tmp_path), 1)
    assert manifest["layout"] == 4
    groups = manifest["tile_groups"]
    bank = state["tiles"]
    assert set(groups) == {g for g, _ in bank.index}
    for g, paths in bank.index:
        assert groups[g]["members"] == list(paths)
        assert groups[g]["policy"]["tile"]["algorithm"] == \
            bank.policy(g).tile.algorithm
        assert policy_from_json(groups[g]["policy"]) == bank.policy(g)
    classes = manifest["tile_classes"]
    pidx = dict(bank.index)
    assert set(classes) == {c for c, _ in bank.class_index}
    for c, gnames in bank.class_index:
        assert classes[c]["groups"] == list(gnames)
        assert classes[c]["members"] == [list(pidx[g]) for g in gnames]


def test_legacy_single_policy_checkpoint_rekeys_into_mixed_plan(tmp_path):
    params = _mixed_params()
    single = _plan_trainer(AnalogPlan.of(("**", POL_A)))
    state = _step(single, single.init(prng.PRNGKey(1), params))
    assert {g for g, _ in state["tiles"].index} == {"g8x8_float32_nM"}
    ckpt.save(state, str(tmp_path), step=1)
    mixed = _plan_trainer(MIXED)
    template = mixed.init(prng.PRNGKey(1), params)
    with pytest.warns(UserWarning, match="polb"):
        restored = ckpt.restore(template, str(tmp_path))
    assert {g for g, _ in restored["tiles"].index} \
        == {"g8x8_float32_nM_ppola", "g8x8_float32_nM_ppolb"}
    for p in params:
        for slot in ("W", "Qd"):
            assert torch.equal(restored["tiles"][p][slot],
                               state["tiles"][p][slot]), (p, slot)
    restored2, m = mixed.train_step(restored, None)
    assert np.isfinite(float(m["loss"]))
    assert int(restored2["step"]) == 2


def test_mixed_plan_checkpoint_restores_into_single_policy_template(tmp_path):
    params = _mixed_params()
    mixed = _plan_trainer(MIXED)
    state = _step(mixed, mixed.init(prng.PRNGKey(4), params))
    ckpt.save(state, str(tmp_path), step=1)
    single = _plan_trainer(AnalogPlan.of(("**", POL_B)))
    template = single.init(prng.PRNGKey(4), params)
    assert {g for g, _ in template["tiles"].index} == {"g8x8_float32_nM"}
    with pytest.warns(UserWarning, match="pola"):
        restored = ckpt.restore(template, str(tmp_path))
    for p in params:
        assert torch.equal(restored["tiles"][p]["W"], state["tiles"][p]["W"])
    restored2, m = single.train_step(restored, None)
    assert np.isfinite(float(m["loss"]))
    assert int(restored2["step"]) == 2


def test_mixed_plan_checkpoint_roundtrip(tmp_path):
    tr = _plan_trainer(MIXED)
    state = _step(tr, tr.init(prng.PRNGKey(0), _mixed_params()))
    ckpt.save(state, str(tmp_path), step=1)
    restored = ckpt.restore(state, str(tmp_path), verify=True)
    _assert_trees_equal(_step(tr, state)["tiles"], _step(tr, restored)["tiles"])


def test_policy_mismatch_warning_is_consolidated(tmp_path):
    params = _mixed_params()
    mixed = _plan_trainer(MIXED)
    state = _step(mixed, mixed.init(prng.PRNGKey(6), params))
    ckpt.save(state, str(tmp_path), step=1)
    retuned = _plan_trainer(AnalogPlan.of(
        ("a/**", TilePolicy(POL_A.tile, name="tuna")),
        ("b/**", TilePolicy(POL_B.tile, name="tunb"))))
    template = retuned.init(prng.PRNGKey(6), params)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ckpt.restore(template, str(tmp_path))
    pol = [w for w in rec if "policy" in str(w.message)]
    assert len(pol) == 1, [str(w.message) for w in rec]
    msg = str(pol[0].message)
    assert msg.startswith("2 tile stack(s)"), msg
    assert "g8x8_float32_nM_ptuna" in msg and "g8x8_float32_nM_ptunb" in msg


# ---------------------------------------------------------------------------
# tests/test_tile_engine.py checkpoint cases, replayed
# ---------------------------------------------------------------------------

DEV = DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.05)


def _engine_trainer(engine: str) -> AnalogTrainer:
    cfg = TrainerConfig(
        tile=TileConfig(algorithm="erider", device_p=DEV, device_w=DEV,
                        lr_p=0.5, lr_w=0.5, gamma=0.1, eta=0.1, chopper_p=0.1),
        digital=DigitalOptConfig(kind="sgd"),
        schedule=ScheduleConfig(kind="constant", base_lr=0.1),
        engine=engine)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return AnalogTrainer(_loss_fn, cfg, analog_filter=lambda p, leaf: True)


def _params(n_square: int = 8, shape=(16, 16)):
    p = {f"l{i}": 0.1 * torch.ones(shape) for i in range(n_square)}
    p["odd"] = 0.1 * torch.ones(4, 24)
    return p


@pytest.mark.parametrize("engine", ["grouped", "looped"])
def test_abstract_state_matches_init_structure(engine):
    """Paths, shapes, dtypes and devices: a CPU-parameter init against the
    CPU abstract state; both match the JAX package's abstract state."""
    tr = _engine_trainer(engine)
    params = _params(3)
    concrete = tr.init(prng.PRNGKey(0), params)
    specs = tree_map(lambda x: TensorSpec(x.shape, x.dtype, "meta"), params)
    abstract = tr.abstract_state(specs, device="cpu")
    cflat, aflat = flatten_with_path(concrete), flatten_with_path(abstract)
    assert [p for p, _ in cflat] == [p for p, _ in aflat]
    for (p, c), (_, a) in zip(cflat, aflat):
        assert isinstance(a, TensorSpec), p
        assert tuple(c.shape) == a.shape and c.dtype == a.dtype, p
        assert c.device == a.device, p
    on_card = tr.abstract_state(specs, device="cuda")
    for p, a in flatten_with_path(on_card):
        host = p.rsplit("/", 1)[-1] in ("key", "step", "seed_p", "seed_w")
        assert a.device.type == ("cpu" if host else "cuda"), p
    jtr = JTrainer(_jloss_fn, JTrainerConfig(
        tile=JTile(algorithm="erider", device_p=_jdev(DEV), device_w=_jdev(DEV),
                   lr_p=0.5, lr_w=0.5, gamma=0.1, eta=0.1, chopper_p=0.1),
        digital=JOpt(kind="sgd"), schedule=JSched(kind="constant", base_lr=0.1),
        engine=engine), analog_filter=lambda p, leaf: True)
    jabs = jtr.abstract_state({k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
                               for k, v in params.items()})
    jflat = jax.tree_util.tree_flatten_with_path(jabs)[0]
    assert [path_str(kp) for kp, _ in jflat] == [p for p, _ in aflat]
    for (_, j), (p, a) in zip(jflat, aflat):
        assert tuple(j.shape) == a.shape, p
        want = "int64" if j.dtype == jnp.uint32 else jnp.dtype(j.dtype).name
        assert str(a.dtype).replace("torch.", "") == want, p


def test_partition_params_splits_by_filter():
    params = {"l0": {"w": torch.ones(4, 4), "b": torch.ones(4)}, "odd": torch.ones(3)}
    digital, analog = partition_params(params, lambda p, leaf: leaf.ndim == 2)
    assert list(analog) == ["l0/w"]
    assert digital["l0"]["w"] is None and digital["l0"]["b"] is params["l0"]["b"]


def test_legacy_per_tile_checkpoint_restores_into_grouped(tmp_path):
    params = _params(3)
    looped = _engine_trainer("looped")
    state_l = _step(looped, looped.init(prng.PRNGKey(0), params))
    ckpt.save(state_l, str(tmp_path), step=1)
    grouped = _engine_trainer("grouped")
    template = grouped.init(prng.PRNGKey(0), params)
    restored = ckpt.restore(template, str(tmp_path))
    assert isinstance(restored["tiles"], TileBank)
    for p in state_l["tiles"]:
        for slot in ("W", "Qd"):
            assert torch.equal(restored["tiles"][p][slot],
                               state_l["tiles"][p][slot]), (p, slot)
    eff_l = merge_effective(state_l["params"], state_l["tiles"], looped.cfg.tile)
    eff_g = merge_effective(restored["params"], restored["tiles"],
                            grouped.cfg.tile)
    for p in eff_l:
        np.testing.assert_allclose(eff_g[p].numpy(), eff_l[p].numpy())
    restored2, m = grouped.train_step(restored, None)
    assert np.isfinite(float(m["loss"]))
    assert int(restored2["step"]) == 2


def test_legacy_shape_dtype_checkpoint_rekeys_into_spec_groups(tmp_path):
    params = {}
    for i in range(2):
        params[f"l{i}/attn/wq"] = 0.1 * torch.ones(8, 8)
        params[f"l{i}/attn/wo"] = 0.1 * torch.ones(8, 8)
    tr = _engine_trainer("grouped")
    state = _step(tr, tr.init(prng.PRNGKey(1), params))
    bank = state["tiles"]
    union = sorted(bank.paths())
    legacy_name = group_name((8, 8), torch.float32)
    legacy_stack = tree_map(lambda *leaves: torch.stack(leaves),
                            *(bank[p] for p in union))
    legacy_state = dict(state)
    legacy_state["tiles"] = TileBank({legacy_name: legacy_stack},
                                     ((legacy_name, tuple(union)),))
    ckpt.save(legacy_state, str(tmp_path), step=1)
    restored = ckpt.restore(state, str(tmp_path))
    assert {g for g, _ in restored["tiles"].index} \
        == {"g8x8_float32_nM", "g8x8_float32_Mn"}
    for p in union:
        _assert_trees_equal(restored["tiles"][p], bank[p])
    _, m = tr.train_step(restored, None)
    assert np.isfinite(float(m["loss"]))


def test_v3_pergroup_checkpoint_restores_into_v4_bit_identical(tmp_path):
    import zlib

    tr = _engine_trainer("grouped")
    params = {}
    for i in range(3):
        params[f"l{i}/attn/wq"] = 0.1 * torch.ones(8, 8)
        params[f"l{i}/attn/wo"] = 0.1 * torch.ones(8, 8)
    params["odd"] = 0.1 * torch.ones(4, 24)
    state = _step(tr, tr.init(prng.PRNGKey(2), params))
    assert any(len(gs) > 1 for _, gs in state["tiles"].class_index)
    ckpt.save(state, str(tmp_path), step=1)

    # down-convert the written step to layout v3: per-group stacks
    d = tmp_path / "step_000000001"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    classes = manifest.pop("tile_classes")
    arrays = {}
    for fname in sorted({m["file"] for m in manifest["arrays"].values()}):
        with np.load(d / fname) as z:
            arrays.update({k: z[k] for k in z.files})
    new_arrays, new_meta = {}, {}
    for key, meta in manifest["arrays"].items():
        arr = arrays[meta["npz_key"]]
        parts = key.split("/")
        if len(parts) == 3 and parts[0] == "tiles" and parts[1] in classes:
            for ci, g in enumerate(classes[parts[1]]["groups"]):
                gkey = f"tiles/{g}/{parts[2]}"
                garr = arr[ci]
                safe = gkey.replace("/", "__")
                new_arrays[safe] = garr
                new_meta[gkey] = {"shape": list(garr.shape),
                                  "dtype": meta["dtype"],
                                  "file": "arrays_000.npz", "npz_key": safe,
                                  "crc32": zlib.crc32(garr.tobytes())}
        else:
            new_arrays[meta["npz_key"]] = arr
            new_meta[key] = {**meta, "file": "arrays_000.npz"}
    for fname in {m["file"] for m in manifest["arrays"].values()}:
        (d / fname).unlink()
    np.savez(d / "arrays_000.npz", **new_arrays)
    manifest["arrays"] = new_meta
    manifest["layout"] = 3
    with open(d / "manifest.json", "w") as f:
        json.dump(manifest, f)

    restored = ckpt.restore(state, str(tmp_path), verify=True)
    _assert_trees_equal(restored, state)
    _assert_trees_equal(_step(tr, state)["tiles"], _step(tr, restored)["tiles"])


def test_grouped_checkpoint_roundtrip(tmp_path):
    tr = _engine_trainer("grouped")
    state = _step(tr, tr.init(prng.PRNGKey(0), _params(3)))
    ckpt.save(state, str(tmp_path), step=1)
    restored = ckpt.restore(state, str(tmp_path), verify=True)
    s2a, s2b = _step(tr, state), _step(tr, restored)
    for g, _ in state["tiles"].index:
        assert torch.equal(s2a["tiles"].groups[g]["W"], s2b["tiles"].groups[g]["W"])


# ---------------------------------------------------------------------------
# the port against the JAX package: cross-restore and manifest equality
# ---------------------------------------------------------------------------


def _jdev(dev):
    return JDev(**dataclasses.asdict(dev))


def _jpol(pol):
    d = dataclasses.asdict(pol.tile)
    d["device_p"], d["device_w"] = _jdev(pol.tile.device_p), _jdev(pol.tile.device_w)
    d["state_dtype"] = jnp.float32
    return jplan.TilePolicy(JTile(**d), name=pol.name)


def _layout_params():
    rng = np.random.default_rng(3)
    p = {}
    for i in range(2):
        for fam in ("wq", "wo"):
            p[f"a/l{i}/attn/{fam}"] = (0.1 * rng.standard_normal((8, 8))) \
                .astype(np.float32)
        p[f"b/l{i}/mlp/w"] = (0.1 * rng.standard_normal((4, 12))).astype(np.float32)
        p[f"b/l{i}/mlp/b"] = np.ones(12, np.float32)
    return p


LAYOUTS = {
    "grouped": (AnalogPlan.of(("**", POL_A)), "grouped"),
    # device parameters regenerated from per-tile seeds: uint32 seed leaves
    "seeded": (AnalogPlan.of(("**", TilePolicy(dataclasses.replace(
        POL_A.tile, store_device=False, rng="hash"), name="seeded"))),
        "grouped"),
    "looped": (AnalogPlan.of(("**", POL_A)), "looped"),
    "mixed": (AnalogPlan.of(("a/**", POL_A), ("b/**", POL_B)), "grouped"),
}


def _plain(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    return np.asarray(tree)


def _carry(js):
    """The JAX state as the port's TrainState (``convert.train_state``)."""
    tiles = js["tiles"]
    if hasattr(tiles, "classes"):
        t = {"classes": {c: _plain(dict(st)) for c, st in tiles.classes.items()},
             "index": tiles.index, "class_index": tiles.class_index,
             "policies": {g: jplan.policy_to_json(p)
                          for g, p in tiles.policies.items()}}
    else:
        t = {p: _plain(dict(ts)) for p, ts in tiles.items()}
    return convert.train_state({"step": js["step"], "key": js["key"],
                                "params": _plain(js["params"]),
                                "opt": _plain(js["opt"]), "tiles": t}, "cpu")


def _pair(layout):
    """(JAX trainer, JAX state after one step, port trainer, the same state
    carried into the port)."""
    plan, engine = LAYOUTS[layout]
    jplan_ = jplan.AnalogPlan.of(*[(pat, _jpol(pol)) for pat, pol in plan.rules])
    jtr = JTrainer(_jloss_fn, JTrainerConfig(
        digital=JOpt(kind="sgdm"), schedule=JSched(kind="constant", base_lr=0.1),
        engine=engine), plan=jplan_)
    ttr = AnalogTrainer(_loss_fn, TrainerConfig(
        digital=DigitalOptConfig(kind="sgdm"),
        schedule=ScheduleConfig(kind="constant", base_lr=0.1), engine=engine),
        plan=plan)
    params = _layout_params()
    js = jtr.init(jax.random.PRNGKey(5), {k: jnp.asarray(v) for k, v in params.items()})
    js, _ = jtr.jit_step(donate=False)(js, jnp.zeros(()))
    return jtr, js, ttr, _carry(js)


def _template(ttr):
    return ttr.abstract_state(
        {k: TensorSpec(v.shape, torch.float32, "cpu")
         for k, v in _layout_params().items()}, device="cpu")


def _assert_same_as_jax(port_tree, jax_tree):
    want = {path_str(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    got = {p: v.numpy() for p, v in _flat(port_tree).items()}
    assert list(got) == list(want)
    for p, w in want.items():
        g = got[p]
        if w.dtype == np.uint32:
            assert g.dtype == np.int64, p
            g = g.astype(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, p
        assert g.tobytes() == w.tobytes(), p


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_jax_checkpoint_restores_into_the_port(tmp_path, layout):
    _, js, ttr, ts = _pair(layout)
    jckpt.save(js, str(tmp_path), step=7)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        restored = ckpt.restore(_template(ttr), str(tmp_path), verify=True)
    _assert_same_as_jax(restored, js)
    _assert_trees_equal(restored, ts)
    assert type(restored["tiles"]) is type(ts["tiles"])
    # the restored state steps as the carried one does
    _assert_trees_equal(_step(ttr, restored), _step(ttr, ts))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_port_checkpoint_restores_into_jax(tmp_path, layout):
    jtr, js, _, ts = _pair(layout)
    ckpt.save(ts, str(tmp_path), step=7)
    template = jtr.abstract_state(
        {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
         for k, v in _layout_params().items()})
    restored = jckpt.restore(template, str(tmp_path), verify=True)
    _assert_same_as_jax(ts, restored)


def _npy_members(directory, step):
    d = os.path.join(directory, f"step_{step:09d}")
    out = {}
    for f in sorted(os.listdir(d)):
        if f.endswith(".npz"):
            with zipfile.ZipFile(os.path.join(d, f)) as z:
                out.update({(f, n): z.read(n) for n in z.namelist()})
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_manifest_equals_jax_except_time(tmp_path, layout):
    _, js, _, ts = _pair(layout)
    extra = {"gdc_signatures": {"a/l0/attn/wq": 1.25}}
    jckpt.save(js, str(tmp_path / "jax"), step=3, extra=extra)
    ckpt.save(ts, str(tmp_path / "port"), step=3, extra=extra)
    mj = jckpt.read_manifest(str(tmp_path / "jax"), 3)
    mt = ckpt.read_manifest(str(tmp_path / "port"), 3)
    assert mj.pop("time") > 0 and mt.pop("time") > 0
    assert mt == mj
    assert list(mt) == list(mj) and list(mt["arrays"]) == list(mj["arrays"])
    assert _npy_members(str(tmp_path / "port"), 3) == \
        _npy_members(str(tmp_path / "jax"), 3)
    for d in ("jax", "port"):
        assert os.readlink(os.path.join(str(tmp_path / d), "latest")) \
            == "step_000000003"


def test_large_state_spreads_over_chunks(tmp_path, monkeypatch):
    """Chunks close once they pass _CHUNK_BYTES, in sorted key order, as
    the JAX package's do (a small bound stands in for 512 MB)."""
    tree = {f"w{i}": torch.full((64, 64), float(i)) for i in range(5)}
    monkeypatch.setattr(ckpt, "_CHUNK_BYTES", 2 * 64 * 64 * 4)
    monkeypatch.setattr(jckpt, "_CHUNK_BYTES", 2 * 64 * 64 * 4)
    ckpt.save(tree, str(tmp_path / "port"), step=1)
    jckpt.save({k: jnp.asarray(v.numpy()) for k, v in tree.items()},
               str(tmp_path / "jax"), step=1)
    mt = ckpt.read_manifest(str(tmp_path / "port"))
    mj = jckpt.read_manifest(str(tmp_path / "jax"))
    assert [m["file"] for m in mt["arrays"].values()] == \
        ["arrays_000.npz"] * 2 + ["arrays_001.npz"] * 2 + ["arrays_002.npz"]
    mt.pop("time"), mj.pop("time")
    assert mt == mj
    back = ckpt.restore(tree, str(tmp_path / "jax"), verify=True)
    _assert_trees_equal(back, tree)


# ---------------------------------------------------------------------------
# dtypes, placement, snapshots
# ---------------------------------------------------------------------------


def test_bfloat16_roundtrip_within_the_port(tmp_path):
    x = prng.normal(prng.PRNGKey(1), (5, 7), "cpu")
    tree = {"a": x.to(torch.bfloat16), "b": x, "s": torch.tensor(2.5).bfloat16()}
    ckpt.save(tree, str(tmp_path), step=1)
    arrays = ckpt.read_manifest(str(tmp_path))["arrays"]
    assert arrays["a"]["dtype"] == arrays["s"]["dtype"] == "bfloat16"
    template = {"a": TensorSpec((5, 7), torch.bfloat16, "cpu"),
                "b": TensorSpec((5, 7), torch.float32, "cpu"),
                "s": TensorSpec((), torch.bfloat16, "cpu")}
    back = ckpt.restore(template, str(tmp_path), verify=True)
    _assert_trees_equal(back, tree)


def test_jax_written_bfloat16_reads_into_the_port(tmp_path):
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (6, 4)))
    jtree = {"a": jnp.asarray(x).astype(jnp.bfloat16), "b": jnp.asarray(x)}
    jckpt.save(jtree, str(tmp_path / "jax"), step=1)
    back = ckpt.restore({"a": TensorSpec((6, 4), torch.bfloat16, "cpu"),
                         "b": TensorSpec((6, 4), torch.float32, "cpu")},
                        str(tmp_path / "jax"), verify=True)
    assert back["a"].dtype == torch.bfloat16
    assert back["a"].view(torch.int16).numpy().tobytes() == \
        np.asarray(jtree["a"]).tobytes()
    # and the port writes the same records, manifest and crc32 as JAX
    ckpt.save(back, str(tmp_path / "port"), step=1)
    mj = jckpt.read_manifest(str(tmp_path / "jax"))
    mt = ckpt.read_manifest(str(tmp_path / "port"))
    assert mt["arrays"] == mj["arrays"]
    assert _npy_members(str(tmp_path / "port"), 1) == \
        _npy_members(str(tmp_path / "jax"), 1)


def test_reference_restore_fails_on_bfloat16_leaf(tmp_path):
    """Pins the reference's own fault (ROADMAP queue 3): the JAX package's
    restore cannot read back the bfloat16 leaf it wrote."""
    jckpt.save({"a": jnp.ones((3, 4), jnp.bfloat16)}, str(tmp_path), step=1)
    with pytest.raises(TypeError, match="V2"):
        jckpt.restore({"a": jnp.zeros((3, 4), jnp.bfloat16)}, str(tmp_path))


def test_key_words_stored_as_uint32_and_out_of_range_refused(tmp_path):
    tree = {"key": prng.PRNGKey(2 ** 40 + 5), "n": torch.tensor([3, 2 ** 32 - 1])}
    ckpt.save(tree, str(tmp_path), step=1)
    arrays = ckpt.read_manifest(str(tmp_path))["arrays"]
    assert arrays["key"]["dtype"] == arrays["n"]["dtype"] == "uint32"
    back = ckpt.restore(tree, str(tmp_path), verify=True)
    _assert_trees_equal(back, tree)
    with pytest.raises(ValueError, match="uint32"):
        ckpt.save({"k": torch.tensor([-1])}, str(tmp_path), step=2)


def test_async_save_snapshots_before_it_returns(tmp_path):
    tr = _plan_trainer(MIXED)
    state = _step(tr, tr.init(prng.PRNGKey(0), _mixed_params()))
    before = {p: v.clone() for p, v in _flat(state).items()}
    th = ckpt.save(state, str(tmp_path), step=1, asynchronous=True)
    for _, v in flatten_with_path(state):   # in-place updates after return
        v.add_(1)
    th.join(timeout=30)
    assert not th.is_alive()
    back = ckpt.restore(state, str(tmp_path), verify=True)
    got = _flat(back)
    assert list(got) == list(before)
    for p in before:
        assert torch.equal(got[p], before[p]), p


def test_restore_placement_and_its_refusals(tmp_path):
    tr = _plan_trainer(MIXED)
    state = _step(tr, tr.init(prng.PRNGKey(0), _mixed_params()))
    ckpt.save(state, str(tmp_path), step=1)
    specs = {k: TensorSpec(v.shape, v.dtype, "cpu")
             for k, v in _mixed_params().items()}
    template = tr.abstract_state(specs, device="cpu")
    back = ckpt.restore(template, str(tmp_path), device="meta",
                        host_leaves=HOST_LEAVES)
    for p, v in flatten_with_path(back):
        host = p.rsplit("/", 1)[-1] in ("key", "step", "seed_p", "seed_w")
        assert v.device.type == ("cpu" if host else "meta"), p
    # the checkpoint layer knows no leaf names of its own
    back = ckpt.restore(template, str(tmp_path), device="meta")
    assert all(v.device.type == "meta" for _, v in flatten_with_path(back))
    with pytest.raises(NotImplementedError):
        ckpt.restore(state, str(tmp_path), shardings={})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state, str(tmp_path / "empty"))
    with pytest.raises(ValueError, match="collide"):
        ckpt.save(state, str(tmp_path), step=2, extra={"layout": 5})
    if not torch.cuda.is_available():
        # a template on the card without one raises; nothing falls back
        with pytest.raises((RuntimeError, AssertionError)):
            ckpt.restore(tr.abstract_state(specs, device="cuda"), str(tmp_path))


def test_overwrite_moves_the_old_step_aside(tmp_path):
    ckpt.save({"a": torch.zeros(2)}, str(tmp_path), step=4)
    ckpt.save({"a": torch.ones(2)}, str(tmp_path), step=4)
    names = os.listdir(str(tmp_path))
    assert any(n.startswith("step_000000004.old_") for n in names)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert torch.equal(ckpt.restore({"a": torch.zeros(2)}, str(tmp_path))["a"],
                       torch.ones(2))
