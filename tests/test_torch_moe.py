"""The port's Mixture-of-Experts FFN against the JAX package's, on the CPU.

The same inputs, drawn from a numpy seed, go through both packages.
Tolerances (float32):

* ``LM.init`` of mixtral-8x7b and deepseek-v2-236b (smoke): the same tree,
  shapes and dtypes, values at most 4 float32 ULP apart;
  ``LM.forward`` / ``LM.loss`` (with ``moe_aux``) / every gradient at
  B=2, S=32 (the reference's ``test_forward_and_grads``; 64 tokens take
  the gather path): logits within 2e-6 of their largest magnitude, loss
  and ``moe_aux`` within ``rtol=1e-6``, every gradient within 1e-5 of its
  largest magnitude (``test_torch_models.check_forward_loss_and_grads``).
* Integer routing is bit-equal: top-k ids and values on ties (the lower
  index first, as ``jax.lax.top_k``), and the einsum dispatch's mask
  (expert, capacity slot) captured from the reference's own
  ``jnp.einsum`` call, also when tokens overflow an expert's capacity.
* ``moe_forward`` at 384 tokens (6 groups of 64) under ``einsum`` and
  ``ragged``: output and the gradients of every parameter and of the input
  within 1e-5 of each array's largest magnitude, aux within ``rtol=1e-6``;
  with no token dropped, einsum, ragged and the gather path agree within
  1e-5 in the port. The ragged path adds each token's k outputs in expert
  order (the reference's scatter order): bit-equal from run to run.
* The training CLI (``--smoke --device cpu``, batch 2 x seq 16: the gather
  path): mixtral-8x7b 4 steps, finite, and a restart from the step-2
  checkpoint bit-equal to the unbroken run on every leaf
  (``test_torch_train_cli.check_cli_restart``); deepseek-v2-236b 3 steps.

The analog train steps of deepseek-v2-236b are in
``test_torch_moe_train.py``: the JAX side compiles for about a minute a
backend, and the test runner hands whole files to its workers.
"""
import dataclasses
import signal
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from test_torch_models import (_close, _t, check_forward_loss_and_grads,  # noqa: E402
                               check_init)
from test_torch_train_cli import check_cli_restart, run_cli  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.paths import flatten_with_path  # noqa: E402
from repro_torch.models import moe  # noqa: E402

MOE = ["deepseek-v2-236b", "mixtral-8x7b"]
SMALL = ["--batch", "2", "--seq", "16"]     # the CLI's steps, kept short


@pytest.fixture(autouse=True)
def _keep_signal_handlers():
    """The CLI's PreemptionHandler takes SIGTERM/SIGINT in the process that
    runs ``main``; give them back to the test worker afterwards."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


@pytest.mark.parametrize("arch", MOE)
def test_lm_init_matches_jax(arch):
    check_init(arch)


@pytest.mark.parametrize("arch", MOE)
def test_lm_forward_loss_and_grads_match_jax(arch):
    check_forward_loss_and_grads(arch)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 6])
def test_top_k_ties_match_jax(k):
    rng = np.random.default_rng(k)
    # values from a set of 5: every row has ties, some across the cut
    x = rng.integers(0, 5, (3, 40, 8)).astype(np.float32) / 4
    x[0, 0] = 0.25                       # a row of one value
    vals, idx = moe.top_k(_t(x), k)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(vals.numpy(), np.asarray(jvals))
    assert idx[0, 0].tolist() == list(range(k))


def _moe_case(arch, impl, cf):
    jcfg = dataclasses.replace(jget(arch, smoke=True), moe_impl=impl,
                               capacity_factor=cf)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), moe_impl=impl,
                               capacity_factor=cf)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 96, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, x


class _EinsumSpy(types.SimpleNamespace):
    """``jax.numpy`` for the reference's ``moe`` module, recording the
    operands of its dispatch and combine einsums."""

    def __init__(self):
        super().__init__(seen={})

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, eq, *ops, **kw):
        self.seen[eq] = ops
        return jnp.einsum(eq, *ops, **kw)


def _grads(tcfg, tp, x, ct):
    leaves = {p: t.clone().requires_grad_(True) for p, t in
              flatten_with_path(tp)}
    tree = {p.split("/")[-1]: t for p, t in leaves.items()}
    tx = _t(x).requires_grad_(True)
    y, aux = moe.moe_forward(tree, tx, tcfg)
    g = torch.autograd.grad((y * _t(ct)).sum() + aux, [tx, *leaves.values()])
    return y, aux, dict(zip(["x", *leaves], g))


@pytest.mark.parametrize("arch,impl,cf", [
    ("mixtral-8x7b", "einsum", 0.5),          # capacity overflow
    ("deepseek-v2-236b", "einsum", 1.5),      # 8 experts + a shared one
    ("mixtral-8x7b", "ragged", 1.5),
    ("deepseek-v2-236b", "ragged", 1.5),
], ids=["einsum-overflow", "einsum-shared", "ragged", "ragged-shared"])
def test_moe_forward_and_grads_match_jax(arch, impl, cf, monkeypatch):
    jcfg, tcfg, jp, x = _moe_case(arch, impl, cf)
    ct = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    @jax.jit
    def jvjp(p, a, c):
        (y, aux), vjp = jax.vjp(lambda p, a: jmoe.moe_forward(p, a, jcfg), p, a)
        return y, aux, vjp((c, jnp.ones((), jnp.float32)))

    jy, jaux, (jgp, jgx) = jvjp(jp, jnp.asarray(x), jnp.asarray(ct))
    tp = convert.params(jax.tree.map(np.asarray, jp), "cpu")
    y, aux, grads = _grads(tcfg, tp, x, ct)
    _close(y, jy, 1e-5, "y")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    _close(grads["x"], jgx, 1e-5, "dx")
    for p, g in flatten_with_path(jax.tree.map(np.asarray, jgp)):
        _close(grads[p], g, 1e-5, p)

    if impl != "einsum":
        y2, _ = moe.moe_forward(tp, _t(x), tcfg)
        assert torch.equal(y.detach(), y2)      # a fixed order of sums
        return
    # the dispatch mask, bit-equal to the one the reference builds
    spy = _EinsumSpy()
    monkeypatch.setattr(jmoe, "jnp", spy)

    @jax.jit
    def jmasks(p, a):
        jmoe.moe_forward(p, a, jcfg)
        return spy.seen["ngec,ngd->necd"][0], spy.seen["ngec,necd->ngd"][0]

    jdispatch, jcombine = (np.asarray(a) for a in jmasks(jp, jnp.asarray(x)))
    g = moe.group_size(x.shape[0] * x.shape[1], tcfg.moe_group)
    xt = _t(x).reshape(-1, g, tcfg.d_model)
    _, gate_vals, gate_idx, _ = moe.route(tp, xt, tcfg)
    capacity = jdispatch.shape[-1]
    combine, mask = moe.capacity_slots(gate_vals, gate_idx, tcfg.n_experts,
                                       capacity)
    assert np.array_equal(mask.numpy(), jdispatch > 0)
    _close(combine, jcombine, 1e-6, "combine")
    kept = int(mask.sum())
    n_pairs = gate_idx.numel()
    if cf < 1:
        assert 0 < kept < n_pairs           # some (token, slot) pairs dropped
    else:
        assert kept == n_pairs


@pytest.mark.parametrize("arch", MOE)
def test_einsum_ragged_and_gather_agree(arch):
    """With capacity for every token, the three dispatches compute the same
    function."""
    tcfg = get_config(arch, smoke=True)
    tcfg = dataclasses.replace(tcfg, capacity_factor=tcfg.n_experts / tcfg.top_k)
    _, _, jp, x = _moe_case(arch, "einsum", 1.5)
    tp = convert.params(jax.tree.map(np.asarray, jp), "cpu")
    tx = _t(x)
    with torch.no_grad():
        y_e, _ = moe.moe_forward(tp, tx, tcfg)
        y_r, _ = moe.moe_forward(tp, tx, dataclasses.replace(tcfg,
                                                             moe_impl="ragged"))
        n, d = x.shape[0] * x.shape[1], tcfg.d_model
        _, gv, gi, _ = moe.route(tp, tx.reshape(1, n, d), tcfg)
        y_g = moe._gather_moe(tp, tx.reshape(n, d), gv.reshape(n, -1),
                              gi.reshape(n, -1), tcfg)
        if tcfg.n_shared:
            y_g = y_g + moe._shared_ffn(tp, tx.reshape(n, d), tcfg)
    _close(y_r, y_e.numpy(), 1e-5, "ragged vs einsum")
    _close(y_g.reshape(y_e.shape), y_e.numpy(), 1e-5, "gather vs einsum")


@pytest.mark.parametrize("n_tok,g", [(64, 64), (384, 64), (96, 48), (97, 1),
                                     (300, 60)])
def test_group_size_is_the_largest_divisor(n_tok, g):
    assert moe.group_size(n_tok, 64) == g


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------


def test_cli_trains_and_restarts_bit_equal(tmp_path):
    hist = check_cli_restart("mixtral-8x7b", tmp_path / "ck", SMALL)
    assert all(np.isfinite(m["moe_aux"]) for m in hist)


def test_cli_runs_deepseek():
    _, hist = run_cli(["--arch", "deepseek-v2-236b", "--smoke", "--device",
                          "cpu", "--steps", "3", "--log-every", "1", *SMALL])
    assert [m["step"] for m in hist] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["moe_aux"])
               and np.isfinite(m["tile/sp_err"]) for m in hist)
