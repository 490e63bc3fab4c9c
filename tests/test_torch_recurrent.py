"""The port's recurrent mixers (RG-LRU, Mamba-2 SSD) against the JAX
package's, on the CPU.

The same inputs, drawn from a numpy seed, go through both packages.
Tolerances (float32):

* ``LM.init`` of recurrentgemma-9b and mamba2-2.7b (smoke): the same tree,
  shapes and dtypes, values at most 4 float32 ULP apart; ``LM.forward`` /
  ``LM.loss`` / every gradient at B=2, S=32 (the reference's
  ``test_forward_and_grads``): logits within 2e-6 of their largest
  magnitude, loss within ``rtol=1e-6``, every gradient within 1e-5 of its
  largest magnitude (``test_torch_models.check_forward_loss_and_grads``).
* ``associative_scan`` against ``jax.lax.associative_scan`` with the
  RG-LRU's combine, at odd and even lengths (1 to 33): the result and its
  gradients within 2e-6 of each array's largest magnitude (XLA-CPU
  contracts ``a2 * b1 + b2`` into a fused multiply-add, so not bit for
  bit); ``causal_conv`` within 1e-6.
* ``ssd_chunked`` with a padded tail (40 steps in chunks of 16) and with
  ``init_state``: output, final state and the gradients of all five
  inputs within 1e-5 of each array's largest magnitude (``torch.einsum``
  may contract the three-operand einsums in another order).
* The training CLI (``--smoke --device cpu``, batch 2 x seq 40): mamba2-2.7b
  4 steps, finite,
  and a restart from the step-2 checkpoint bit-equal to the unbroken run
  on every leaf (``test_torch_train_cli.check_cli_restart``);
  recurrentgemma-9b 3 steps.

The analog train steps of mamba2-2.7b are in
``test_torch_recurrent_train.py``.
"""
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import recurrent as jrec  # noqa: E402
from test_torch_models import (_close, _t, check_forward_loss_and_grads,  # noqa: E402
                               check_init)
from test_torch_train_cli import check_cli_restart, run_cli  # noqa: E402

from repro_torch.models import recurrent  # noqa: E402

RECURRENT = ["mamba2-2.7b", "recurrentgemma-9b"]
SMALL = ["--batch", "2", "--seq", "40"]     # two chunks of 16 and a tail


@pytest.fixture(autouse=True)
def _keep_signal_handlers():
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


@pytest.mark.parametrize("arch", RECURRENT)
def test_lm_init_matches_jax(arch):
    check_init(arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_lm_forward_loss_and_grads_match_jax(arch):
    check_forward_loss_and_grads(arch)


def _jax_combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("S", [1, 2, 5, 8, 16, 33])
def test_associative_scan_matches_jax(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 6)).astype(np.float32)
    b = rng.standard_normal((2, S, 6)).astype(np.float32)
    cts = [rng.standard_normal((2, S, 6)).astype(np.float32) for _ in range(2)]

    @jax.jit
    def jvjp(a, b, ca, cb):
        out, vjp = jax.vjp(lambda a, b: jax.lax.associative_scan(
            _jax_combine, (a, b), axis=1), a, b)
        return out, vjp((ca, cb))

    (ja, jb), jgrads = jvjp(a, b, *cts)
    ta, tb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    oa, ob = recurrent.associative_scan(recurrent._linear_combine, (ta, tb),
                                        axis=1)
    grads = torch.autograd.grad((oa, ob), (ta, tb), [_t(c) for c in cts])
    _close(oa, ja, 2e-6, "a")
    _close(ob, jb, 2e-6, "b")
    for name, g, w in zip("ab", grads, jgrads):
        _close(g, w, 2e-6, f"d{name}")
    # the sequential recurrence h_t = a_t h_{t-1} + b_t, in float64
    h, want = np.zeros((2, 6)), []
    for t in range(S):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want.append(h)
    _close(ob, np.stack(want, 1), 2e-6, "recurrence")


@pytest.mark.parametrize("k", [1, 4])
def test_causal_conv_matches_jax(k):
    rng = np.random.default_rng(k)
    u = rng.standard_normal((2, 9, 5)).astype(np.float32)
    w = rng.standard_normal((k, 5)).astype(np.float32)
    jy, jstate = jrec.causal_conv(u, w)
    y, state = recurrent.causal_conv(_t(u), _t(w))
    _close(y, jy, 1e-6, "y")
    if k == 1:
        assert state is None and jstate is None
    else:
        assert np.array_equal(state.numpy(), np.asarray(jstate))


@pytest.mark.parametrize("s,chunk,seeded", [(40, 16, False), (40, 16, True),
                                            (32, 16, True), (12, 16, False)],
                         ids=["padded-tail", "padded-tail-init-state",
                              "init-state", "one-short-chunk"])
def test_ssd_chunked_matches_jax(s, chunk, seeded):
    rng = np.random.default_rng(s + chunk + seeded)
    b, h, p, n = 2, 3, 4, 5
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt_a = -rng.uniform(0.0, 0.5, (b, s, h)).astype(np.float32)
    B = rng.standard_normal((b, s, h, n)).astype(np.float32)
    C = rng.standard_normal((b, s, h, n)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32)
    ins = [x, dt_a, B, C, init]
    cts = [rng.standard_normal(x.shape).astype(np.float32),
           rng.standard_normal(init.shape).astype(np.float32)]

    def jfn(x, dt_a, B, C, init):
        return jrec.ssd_chunked(x, dt_a, B, C, chunk,
                                init_state=init if seeded else None)

    @jax.jit
    def jvjp(ins, cts):
        out, vjp = jax.vjp(jfn, *ins)
        return out, vjp(tuple(cts))

    (jy, jfinal), jgrads = jvjp(ins, cts)
    tins = [_t(a).requires_grad_(True) for a in ins]
    y, final = recurrent.ssd_chunked(*tins[:4], chunk,
                                     init_state=tins[4] if seeded else None)
    assert y.shape == (b, s, h, p) and final.shape == (b, h, p, n)
    grads = torch.autograd.grad((y, final), tins[:4 + seeded],
                                [_t(c) for c in cts])
    _close(y, jy, 1e-5, "y")
    _close(final, jfinal, 1e-5, "final state")
    for name, g, w in zip(["x", "dt_a", "B", "C", "init"], grads, jgrads):
        _close(g, w, 1e-5, f"d{name}")


def test_cli_trains_and_restarts_bit_equal(tmp_path):
    check_cli_restart("mamba2-2.7b", tmp_path / "ck", SMALL)


def test_cli_runs_recurrentgemma():
    _, hist = run_cli(["--arch", "recurrentgemma-9b", "--smoke", "--device",
                          "cpu", "--steps", "3", "--log-every", "1", *SMALL])
    assert [m["step"] for m in hist] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["tile/sp_err"])
               for m in hist)
