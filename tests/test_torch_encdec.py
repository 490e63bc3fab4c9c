"""The port's encoder-decoder model (cross-attention and the encoder)
against the JAX package's, on the CPU.

The same inputs, drawn from a numpy seed, go through both packages.
Tolerances (float32):

* ``LM.init`` of seamless-m4t-large-v2 (smoke; the ``enc`` tree included):
  the same tree, shapes and dtypes, values at most 4 float32 ULP apart;
  ``LM.forward`` / ``LM.loss`` / every gradient at B=2, S=32 fed from
  ``frames`` as the reference's ``test_forward_and_grads`` feeds it:
  logits within 2e-6 of their largest magnitude, loss within
  ``rtol=1e-6``, every gradient within 1e-5 of its largest magnitude
  (``test_torch_models.check_forward_loss_and_grads``).
* ``cross_forward`` (queries from the decoder, keys and values from an
  encoder output of another length, two chunks) and the encoder
  (``LM._encode``: bidirectional attention over ``frames``, then the
  final norm): outputs and gradients within 2e-6 of each array's largest
  magnitude.
* The training CLI feeds no ``frames``: both packages' CLIs raise on
  seamless-m4t-large-v2 at the first step (the reference's
  ``AttributeError`` on ``None``; the port names the missing input).
"""
import dataclasses
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from test_torch_models import (_close, _jax_lm, _t,  # noqa: E402
                               check_forward_loss_and_grads, check_init)
from test_torch_train_cli import run_cli  # noqa: E402

from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.paths import flatten_with_path, tree_map_with_path  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

ARCH = "seamless-m4t-large-v2"


@pytest.fixture(autouse=True)
def _keep_signal_handlers():
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def test_lm_init_matches_jax():
    check_init(ARCH)


def test_lm_forward_loss_and_grads_match_jax():
    check_forward_loss_and_grads(ARCH)


@pytest.mark.parametrize("S,Se", [(32, 40), (12, 7)])
def test_cross_forward_and_grads_match_jax(S, Se):
    jcfg = dataclasses.replace(jget(ARCH, smoke=True), attn_chunk=16)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), attn_chunk=16)
    jp = jattn.init_attn(jax.random.PRNGKey(4), jcfg, cross=True)
    assert sorted(jp) == ["wk", "wo", "wq", "wv"]
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, Se, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    @jax.jit
    def jvjp(p, x, e, c):
        y, vjp = jax.vjp(lambda p, x, e: jattn.cross_forward(p, x, e, jcfg),
                         p, x, e)
        return y, vjp(c)

    jy, (jgp, jgx, jge) = jvjp(jp, x, enc, ct)
    tp = {k: v.requires_grad_(True) for k, v in
          convert.params(jax.tree.map(np.asarray, jp), "cpu").items()}
    assert sorted(attention.init_attn(prng.PRNGKey(0), tcfg, cross=True,
                                      device="meta")) \
        == sorted(jp)
    tx, te = _t(x).requires_grad_(True), _t(enc).requires_grad_(True)
    y = attention.cross_forward(tp, tx, te, tcfg)
    grads = torch.autograd.grad(y, [tx, te, *tp.values()], _t(ct))
    _close(y, jy, 2e-6, "y")
    _close(grads[0], jgx, 2e-6, "dx")
    _close(grads[1], jge, 2e-6, "denc")
    for name, g in zip(tp, grads[2:]):
        _close(g, jgp[name], 2e-6, name)


def test_encoder_matches_jax():
    jm, jp = _jax_lm(ARCH)
    tm = LM(get_config(ARCH, smoke=True))
    rng = np.random.default_rng(9)
    frames = (0.1 * rng.standard_normal((2, 24, jm.cfg.d_model))
              ).astype(np.float32)
    ct = rng.standard_normal(frames.shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda p: jm._encode(p, jnp.asarray(frames)), jp)
    (jgrads,) = vjp(jnp.asarray(ct))
    tp = convert.params(jax.tree.map(np.asarray, jp), "cpu")
    leaves = {p: t.requires_grad_(True) for p, t in flatten_with_path(tp["enc"])}
    enc = tree_map_with_path(lambda p, _: leaves[p], tp["enc"])
    out = tm._encode(dict(tp, enc=enc), _t(frames))
    grads = torch.autograd.grad(out, list(leaves.values()), _t(ct))
    _close(out, jout, 2e-6, "encoder output")
    want = dict(flatten_with_path(jax.tree.map(np.asarray, jgrads["enc"])))
    for p, g in zip(leaves, grads):
        _close(g, want[p], 2e-6, p)


def test_both_clis_raise_without_frames(capsys):
    argv = ["--arch", ARCH, "--smoke", "--steps", "1", "--batch", "2",
            "--seq", "16"]
    with pytest.raises(AttributeError):
        jtrain.main(argv)
    with pytest.raises(ValueError, match="frames"):
        run_cli(argv + ["--device", "cpu"])
    assert "plan: 22 analog paths" in capsys.readouterr().out
