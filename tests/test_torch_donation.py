"""The donated train step: ``AnalogTrainer.jit_step()`` writes the state in
place, bit-equal to the pure ``train_step``.

* Every algorithm under every engine (the grouped per-tile loop, the
  grouped 'fused' batched update with hash noise, the looped dict layout),
  with the digital branch cycling through SGD, SGD with momentum, Adam and
  AdamW: 3 donated steps bit-equal to 3 pure steps from the same init,
  metrics too; the step returns the state it was given, every leaf on its
  own storage; E-RIDER's Q~ and Q never share storage; every pulse update
  goes through K1's in-place op (under 'fused' its hash-noise mode,
  ``repro_torch::analog_update_hash_``). The same for bfloat16 tile state and a
  bfloat16 digital leaf, where every write rounds at its store.
* K1's in-place op (``repro_torch::analog_update_``) on the CPU bit-equal
  to the out-of-place op, its write seen on a ``meta`` trace, a
  non-contiguous ``w`` refused; the pulse engine's generic paths through
  ``out=``.
* The donated quickstart against the JAX package's ``jit_step(donate=True)``
  within ``test_torch_trainer.py``'s tolerance (rtol 1e-5).
* Two gloo ranks (``tests/torch_ranks.py``): the rank's blocks keep their
  storage through donated steps, gathered bit-equal to one process.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.core.device import DeviceConfig  # noqa: E402
from repro_torch.core.digital_opt import DigitalOptConfig, ScheduleConfig  # noqa: E402
from repro_torch.core.paths import flatten_with_path  # noqa: E402
from repro_torch.core.plan import AnalogPlan, TilePolicy  # noqa: E402
from repro_torch.core.tile import TileConfig  # noqa: E402
from repro_torch.core.trainer import AnalogTrainer, TrainerConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.roofline.op_cost import OpTrace  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ranks  # noqa: E402

ALGOS = ("sgd", "ttv1", "ttv2", "agad", "residual", "rider", "erider")
ENGINES = ("vmap", "fused", "looped")
OPTS = ("sgd", "sgdm", "adam", "adamw")
K1 = "repro_torch.analog_update.default"
K1_INPLACE = "repro_torch.analog_update_.default"
# K1's hash-noise mode, which the 'fused' engine's batched update takes
K1_HASH = "repro_torch.analog_update_hash.default"
K1_HASH_INPLACE = "repro_torch.analog_update_hash_.default"

DEV_W = DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.05)
DEV_P = DeviceConfig(dw_min=0.01, sigma_pm=0.3, sigma_d2d=0.1, sigma_c2c=0.05,
                     ref_mean=0.3, ref_std=0.2)


def _loss(params, batch, rng):
    h = torch.tanh(batch["x"] @ params["l1"]["w"].float())
    h = torch.tanh(h @ params["l2"]["w"].float() + params["l2"]["b"].float())
    out = h @ params["l3"]["w"].float()
    return torch.mean((out - batch["y"]) ** 2), {}


def _trainer(algorithm, engine, opt, dtype=torch.float32):
    extra = ({"rng": "hash", "update_backend": "fused"} if engine == "fused"
             else {})
    # chopper_p 0.5: the chopper flips, and E-RIDER reprograms Q~, within
    # three steps
    tile = TileConfig(algorithm=algorithm, device_p=DEV_P, device_w=DEV_W,
                      lr_p=0.5, lr_w=0.5, gamma=0.1, eta=0.3, chopper_p=0.5,
                      state_dtype=dtype, **extra)
    cfg = TrainerConfig(
        tile=tile,
        digital=DigitalOptConfig(kind=opt, weight_decay=0.01),
        schedule=ScheduleConfig(kind="constant", base_lr=0.1),
        engine="looped" if engine == "looped" else "grouped")
    return AnalogTrainer(_loss, cfg,
                         plan=AnalogPlan.of(("**", TilePolicy(tile, name="t"))))


def _params(dtype=torch.float32):
    """Two 8x8 tiles (one class of two members), a 6x8 singleton and a
    digital bias."""
    r = np.random.default_rng(0)

    def f(*shape):
        return torch.from_numpy(
            (0.3 * r.standard_normal(shape)).astype(np.float32))

    return {"l1": {"w": f(6, 8)}, "l2": {"w": f(8, 8), "b": f(8).to(dtype)},
            "l3": {"w": f(8, 8)}}


def _batch(i):
    r = np.random.default_rng(10 + i)
    return {"x": torch.from_numpy(r.standard_normal((4, 6)).astype(np.float32)),
            "y": torch.from_numpy(r.standard_normal((4, 8)).astype(np.float32))}


def _check_donated(tr, dtype=torch.float32, steps=3):
    pure = tr.init(prng.PRNGKey(1), _params(dtype))
    state = tr.init(prng.PRNGKey(1), _params(dtype))
    ptrs = {p: t.untyped_storage().data_ptr()
            for p, t in flatten_with_path(state)}
    step, donated = tr.jit_step(donate=False), tr.jit_step()
    assert step == tr.train_step and donated == tr.train_step_
    kinds = set()
    for i in range(steps):
        pure, m_pure = step(pure, _batch(i))
        with OpTrace() as trace:
            out, m = donated(state, _batch(i))
        assert out is state
        kinds |= {r.name for r in trace.records
                  if r.name in (K1, K1_INPLACE, K1_HASH, K1_HASH_INPLACE)}
        assert m.keys() == m_pure.keys()
        for k in m:
            assert torch.equal(m[k], m_pure[k]), (i, k)
        for p, t in flatten_with_path(state):
            assert t.untyped_storage().data_ptr() == ptrs[p], (i, p)
            if p.endswith("/Qt"):
                qd = dict(flatten_with_path(state))[p[:-2] + "Qd"]
                assert t.untyped_storage().data_ptr() \
                    != qd.untyped_storage().data_ptr(), p
    got = dict(flatten_with_path(state))
    want = dict(flatten_with_path(pure))
    assert got.keys() == want.keys()
    for p in want:
        assert got[p].dtype == want[p].dtype, p
        assert torch.equal(got[p], want[p]), p
    # every P and W write through K1's in-place mode, none out of place
    # (the 'fused' engine's in its hash-noise mode)
    fused = tr.cfg.tile.update_backend == "fused"
    assert kinds == {K1_HASH_INPLACE if fused else K1_INPLACE}, kinds
    return state


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algorithm", ALGOS)
def test_donated_steps_bit_equal_and_in_place(algorithm, engine):
    opt = OPTS[(ALGOS.index(algorithm) + ENGINES.index(engine)) % len(OPTS)]
    _check_donated(_trainer(algorithm, engine, opt))


@pytest.mark.parametrize("engine", ("vmap", "fused"))
def test_donated_steps_bfloat16_state(engine):
    """bfloat16 tile state and digital leaf: K1 stores bfloat16, the EMA and
    the digital update round at their store as ``.to`` rounds."""
    state = _check_donated(_trainer("erider", engine, "adamw",
                                    torch.bfloat16), torch.bfloat16)
    assert state["params"]["l2"]["b"].dtype == torch.bfloat16
    assert all(st["Qd"].dtype == torch.bfloat16
               for st in state["tiles"].classes.values())


# ---------------------------------------------------------------------------
# K1's in-place op and the pulse engine's destination
# ---------------------------------------------------------------------------


def _k1_operands(shape, dtype, seed):
    r = np.random.default_rng(seed)

    def f(scale, lo=0.0):
        return torch.from_numpy(
            (lo + scale * r.standard_normal(shape)).astype(np.float32))

    w = f(0.3).to(dtype)
    ubits = torch.from_numpy(
        r.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.int64))
    return w, f(0.05), f(0.1, 1.0).abs(), f(0.1), ubits, f(1.0)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("shape", ((33, 97), (3, 16, 24)))
def test_k1_inplace_op_bit_equal_and_traced_as_a_write(shape, dtype):
    kw = dict(dw_min=0.01, tau_min=1.0, tau_max=1.0, sigma_c2c=0.1, bl=31)
    w, dw, gamma, rho, ubits, zeta = _k1_operands(shape, dtype, 3)
    want = ops.analog_update(w, dw, gamma, rho, None, noise=(ubits, zeta),
                             **kw)
    ptr = w.data_ptr()
    got = ops.analog_update(w, dw, gamma, rho, None, noise=(ubits, zeta),
                            out=w, **kw)
    assert got is w and w.data_ptr() == ptr
    assert torch.equal(w, want)
    # a slot view of a stack, as the per-tile loop hands it
    stack = torch.stack([w, w])
    slot = stack[1]
    ops.analog_update(slot, dw, gamma, rho, None, noise=(ubits, zeta),
                      out=slot, **kw)
    assert torch.equal(stack[0], w)
    assert torch.equal(stack[1], ops.analog_update(
        w, dw, gamma, rho, None, noise=(ubits, zeta), **kw))
    # on meta: one op that writes w and returns nothing
    m = [t.to("meta") for t in (w, dw, gamma, rho, zeta)]
    mu = torch.empty(shape, dtype=torch.int32, device="meta")
    with OpTrace() as trace:
        ops.analog_update(m[0], *m[1:4], None, noise=(mu, m[4]), out=m[0],
                          **kw)
    rec = [r for r in trace.records if r.name.startswith("repro_torch")]
    assert [r.name for r in rec] == [K1_INPLACE]
    assert rec[0].mutated == (0,) and rec[0].outputs == ()
    assert m[0].untyped_storage()._cdata in trace.written
    # a non-contiguous w: the kernel would update a copy
    t = [x.transpose(-1, -2) for x in (w, dw, gamma, rho, ubits, zeta)]
    with pytest.raises(ValueError, match="contiguous"):
        ops.analog_update(*t[:4], None, noise=tuple(t[4:]), out=t[0], **kw)


@pytest.mark.parametrize("kind, mode", [("exp", "fused"),
                                        ("softbounds", "train")])
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_pulse_engine_writes_its_destination(kind, mode, dtype):
    """``_fused_generic`` and ``_pulse_train`` with ``out=w``: bit-equal to
    the new tensor they return without it."""
    from repro_torch.core import pulse
    from repro_torch.core.device import sample_device

    cfg = DeviceConfig(kind=kind, dw_min=0.01, sigma_c2c=0.1, sigma_d2d=0.1)
    dev = sample_device(prng.PRNGKey(4), (12, 10), cfg, device="cpu")
    w, dw = _k1_operands((12, 10), dtype, 5)[:2]
    key = prng.PRNGKey(6)
    want = pulse.analog_update(w, dw, dev, cfg, key, bl=3, mode=mode)
    got = pulse.analog_update(w, dw, dev, cfg, key, bl=3, mode=mode, out=w)
    assert got is w and torch.equal(w, want)


# ---------------------------------------------------------------------------
# against the JAX package, and on two ranks
# ---------------------------------------------------------------------------


def test_donated_quickstart_matches_jax_donated():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import examples.torch_quickstart as tq
    from test_torch_trainer import QS_KEYS, _jax_quickstart

    jtr = _jax_quickstart()
    js = jtr.init(jax.random.PRNGKey(2), {"w": jnp.zeros((32, 32))})
    ttr = tq.make_trainer("cpu")
    ts = ttr.init(prng.PRNGKey(2), {"w": torch.zeros(32, 32)})
    w = ts["tiles"].classes["g32x32_float32_nn"]["W"]
    jstep, tstep = jtr.jit_step(donate=True), ttr.jit_step()
    for i in range(20):
        js, jm = jstep(js, jnp.zeros(()))
        ts, tm = tstep(ts, None)
        for k in QS_KEYS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    assert ts["tiles"].classes["g32x32_float32_nn"]["W"] is w
    np.testing.assert_allclose(
        w.numpy(), np.asarray(js["tiles"].classes["g32x32_float32_nn"]["W"]),
        rtol=0, atol=1e-5)


def test_donated_blocks_keep_their_storage_on_two_ranks(tmp_path):
    """The mixed bank on a (2, 1) mesh: stack rows split over the data
    axis (written as stored), a stack that does not divide (updated whole,
    its cut written back), Adam moments ZeRO-sharded (the gathered
    parameters written back): 2 donated steps, every block on its own
    storage, gathered bit-equal to one process's pure steps."""
    res = torch_ranks.run("bank", 2, str(tmp_path), timeout=150, data=2,
                          model=1, kind="mixed", donate=True)
    for r in res:
        assert r["kept"], r["moved"]
    got = dict(flatten_with_path(res[0]["state"]))
    for p, v in flatten_with_path(res[0]["one_state"]):
        assert torch.equal(got[p], v), p
    for a, b in zip(res[0]["metrics"], res[0]["one_metrics"]):
        assert {k: float(v) for k, v in a.items()} \
            == {k: float(v) for k, v in b.items()}
