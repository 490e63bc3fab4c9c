"""The serve functions of the port's recurrent mixers (RG-LRU, Mamba-2 SSD)
against the JAX package's, on the CPU.

The smoke configs of recurrentgemma-9b (RG-LRU) and mamba2-2.7b (SSD),
the mixers' parameters drawn by the JAX package and carried across with
``repro_torch.convert.params``, the inputs drawn from a numpy seed.
Tolerances (float32), each relative to the largest magnitude of the JAX
array:

* ``causal_conv`` with a prior state and per-row ``lengths``, lengths
  below k-1 included (the new state reaches into the prior one): outputs
  within 1e-6, the new state bit-equal (it is a gather of its inputs).
* ``rglru_forward_with_state`` then 3 ``rglru_decode`` steps: outputs and
  states within 2e-6 (XLA-CPU contracts ``a2 * b1 + b2`` into a fused
  multiply-add, in the scan and in the decode step; ROADMAP queue 3).
* ``ssm_forward_with_state`` then 3 ``ssm_decode`` steps; and SSD seeded
  with a prior state over a right-padded batch (dt zeroed past each row's
  run): outputs and states within 1e-5 (``torch.einsum`` contracts SSD's
  three-operand einsums in another order; ROADMAP queue 3).
* ``make_rglru_state`` / ``make_ssm_state``: JAX's shapes and dtypes, at
  the smoke and the full configs.

Inside the port: a prefill split at an ``ssm_chunk`` boundary, the second
chunk seeded with the first's state, gives the one-shot prefill's output
and state within 1e-5 (the identity the engine's chunked prefill rides).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from test_torch_models import _close, _t  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.paths import TensorSpec, flatten_with_path  # noqa: E402
from repro_torch.models import recurrent  # noqa: E402

RG, SSM = "recurrentgemma-9b", "mamba2-2.7b"


def _tree_close(got, want, rel, err=""):
    g = dict(flatten_with_path(got))
    w = dict(flatten_with_path(jax.tree.map(np.asarray, want)))
    assert sorted(g) == sorted(w), err
    for path in w:
        _close(g[path], w[path], rel, f"{err} {path}")


@functools.lru_cache(maxsize=None)
def _mixer(arch: str):
    """(JAX config, port config, JAX params, port params) of the arch's
    recurrent mixer, drawn by the JAX package from key 1."""
    jcfg, tcfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    init = jrec.init_rglru if arch == RG else jrec.init_ssm
    jp = init(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, jp, convert.params(jax.tree.map(np.asarray, jp), "cpu")


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


@pytest.mark.parametrize("seeded, lengths", [
    (True, None), (False, [6, 2, 1, 0]), (True, [6, 2, 1, 0]),
    (True, [3, 5, 6, 4])], ids=["state", "lengths", "state-lengths-short",
                                "state-lengths"])
def test_causal_conv_with_state_and_lengths_matches_jax(seeded, lengths):
    rng = np.random.default_rng(7)
    k, S, C = 4, 6, 5
    u = rng.standard_normal((4, S, C)).astype(np.float32)
    w = rng.standard_normal((k, C)).astype(np.float32)
    st = rng.standard_normal((4, k - 1, C)).astype(np.float32) if seeded else None
    ln = None if lengths is None else np.array(lengths, np.int32)
    jy, jst = jrec.causal_conv(jnp.asarray(u), jnp.asarray(w),
                               None if st is None else jnp.asarray(st),
                               None if ln is None else jnp.asarray(ln))
    y, new = recurrent.causal_conv(_t(u), _t(w), None if st is None else _t(st),
                                   None if ln is None else _t(ln))
    _close(y, jy, 1e-6, "y")
    np.testing.assert_array_equal(new.numpy(), np.asarray(jst))
    if ln is not None and st is not None and ln[2] == 1:
        # a row of length 1 keeps the last two prior inputs and its one input
        np.testing.assert_array_equal(new[2].numpy(),
                                      np.concatenate([st[2, 1:], u[2, :1]]))


def _decode_chain(jfwd, jdec, tfwd, tdec, cfg, S, rel, steps=3):
    """Prefill S steps with state, then ``steps`` decode steps, each
    package carrying its own state; outputs and states compared at every
    call."""
    x = _x(cfg, (2, S), S)
    (jy, jst), (ty, tst) = jfwd(jnp.asarray(x)), tfwd(_t(x))
    _close(ty, jy, rel, "prefill y")
    _tree_close(tst, jst, rel, "prefill state")
    for i in range(steps):
        xt = _x(cfg, (2, 1), 100 + i)
        jy, jst = jdec(jnp.asarray(xt), jst)
        ty, tst = tdec(_t(xt), tst)
        _close(ty, jy, rel, f"decode {i} y")
        _tree_close(tst, jst, rel, f"decode {i} state")


@pytest.mark.parametrize("S", [1, 5, 9])
def test_rglru_forward_with_state_and_decode_match_jax(S):
    jcfg, tcfg, jp, tp = _mixer(RG)
    jfwd = jax.jit(lambda x: jrec.rglru_forward_with_state(jp, x, jcfg))
    jdec = jax.jit(lambda x, st: jrec.rglru_decode(jp, x, st, jcfg))
    with torch.no_grad():
        _decode_chain(jfwd, jdec,
                      lambda x: recurrent.rglru_forward_with_state(tp, x, tcfg),
                      lambda x, st: recurrent.rglru_decode(tp, x, st, tcfg),
                      tcfg, S, 2e-6)


@pytest.mark.parametrize("S", [2, 16, 40])
def test_ssm_forward_with_state_and_decode_match_jax(S):
    jcfg, tcfg, jp, tp = _mixer(SSM)
    jfwd = jax.jit(lambda x: jrec.ssm_forward_with_state(jp, x, jcfg))
    jdec = jax.jit(lambda x, st: jrec.ssm_decode(jp, x, st, jcfg))
    with torch.no_grad():
        _decode_chain(jfwd, jdec,
                      lambda x: recurrent.ssm_forward_with_state(tp, x, tcfg),
                      lambda x, st: recurrent.ssm_decode(tp, x, st, tcfg),
                      tcfg, S, 1e-5)


def _seeded_state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    km1, GN = cfg.d_conv - 1, cfg.ssm_groups * cfg.d_state
    return {"h": 0.3 * rng.standard_normal(
                (B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_state)).astype(np.float32),
            "conv": {"x": rng.standard_normal((B, km1, cfg.d_inner)).astype(np.float32),
                     "b": rng.standard_normal((B, km1, GN)).astype(np.float32),
                     "c": rng.standard_normal((B, km1, GN)).astype(np.float32)}}


@pytest.mark.parametrize("lengths", [[24, 24, 24], [24, 19, 2]],
                         ids=["full", "padded-tail"])
def test_ssd_seeded_state_and_padded_tail_match_jax(lengths):
    """A chunk continuation (a prior state) over a right-padded batch of 24
    steps (one ``ssm_chunk`` of 16 and a tail): the valid rows' outputs and
    the final states."""
    jcfg, tcfg, jp, tp = _mixer(SSM)
    x = _x(tcfg, (3, 24), 5)
    st = _seeded_state(tcfg, 3, 6)
    ln = np.array(lengths, np.int32)
    jy, jst = jax.jit(lambda x, st, ln: jrec.ssm_forward_with_state(
        jp, x, jcfg, state=st, lengths=ln))(jnp.asarray(x),
                                            jax.tree.map(jnp.asarray, st),
                                            jnp.asarray(ln))
    with torch.no_grad():
        ty, tst = recurrent.ssm_forward_with_state(
            tp, _t(x), tcfg, state=convert.params(st, "cpu"), lengths=_t(ln))
    for b, n in enumerate(lengths):
        _close(ty[b, :n], np.asarray(jy)[b, :n], 1e-5, f"y row {b}")
    _tree_close(tst, jst, 1e-5, "state")
    if lengths[-1] < 24:
        # the padded tail leaves the state where the valid run ended
        with torch.no_grad():
            _, short = recurrent.ssm_forward_with_state(
                tp, _t(x[2:, :2]), tcfg, state=convert.params(
                    jax.tree.map(lambda a: a[2:], st), "cpu"))
        _tree_close(jax.tree.map(lambda t: t[2:], tst),
                    jax.tree.map(lambda t: t.numpy(), short), 1e-5, "tail")


def test_ssd_prefill_split_at_a_chunk_boundary_is_the_one_shot_prefill():
    _, tcfg, _, tp = _mixer(SSM)
    x = _t(_x(tcfg, (2, 40), 8))
    c = tcfg.ssm_chunk
    with torch.no_grad():
        y, st = recurrent.ssm_forward_with_state(tp, x, tcfg)
        y1, st1 = recurrent.ssm_forward_with_state(tp, x[:, :c], tcfg)
        y2, st2 = recurrent.ssm_forward_with_state(tp, x[:, c:], tcfg, state=st1)
    _close(torch.cat([y1, y2], 1), y.numpy(), 1e-5, "y")
    _tree_close(st2, jax.tree.map(lambda t: t.numpy(), st), 1e-5, "state")


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", [RG, SSM])
def test_make_state_shapes_and_dtypes_match_jax(arch, smoke):
    jcfg, tcfg = jget(arch, smoke=smoke), get_config(arch, smoke=smoke)
    jmake = jrec.make_rglru_state if arch == RG else jrec.make_ssm_state
    tmake = recurrent.make_rglru_state if arch == RG else recurrent.make_ssm_state
    want = dict(flatten_with_path(jmake(jcfg, 3, abstract=True)))
    spec = dict(flatten_with_path(tmake(tcfg, 3, abstract=True, device="cpu")))
    assert sorted(spec) == sorted(want)
    for path, w in want.items():
        assert isinstance(spec[path], TensorSpec)
        assert tuple(spec[path].shape) == tuple(w.shape), path
        assert _dtype_name(spec[path].dtype) == str(w.dtype), path
    if smoke:
        zeros = dict(flatten_with_path(tmake(tcfg, 3, device="cpu")))
        for path, t in zeros.items():
            assert tuple(t.shape) == tuple(want[path].shape) and not t.any()
