"""The port's multi-head latent attention (MLA) against the JAX package's,
on the CPU.

The same inputs, drawn from a numpy seed, go through both packages.
Tolerances (float32):

* ``LM.init`` of minicpm3-4b (smoke): the same tree, shapes and dtypes,
  values at most 4 float32 ULP apart; ``LM.forward`` / ``LM.loss`` / every
  gradient at B=2, S=32 (the reference's ``test_forward_and_grads``):
  logits within 2e-6 of their largest magnitude, loss within
  ``rtol=1e-6``, every gradient within 1e-5 of its largest magnitude
  (``test_torch_models.check_forward_loss_and_grads``; deepseek-v2-236b,
  MLA with MoE, is in ``test_torch_moe.py``).
* ``mla_forward`` expanded (``mla_absorbed=False``) and absorbed (``True``)
  on the minicpm3 and deepseek smoke shapes, causal and not, with two
  attention chunks: output and the gradients of every parameter and of
  the input within 2e-6 of each array's largest magnitude; the two forms
  agree with each other within 2e-6 in the port.
* The training CLI on minicpm3-4b (``--smoke --device cpu``, batch 2 x
  seq 16): 4 steps,
  finite, and a restart from the step-2 checkpoint bit-equal to the
  unbroken run on every leaf (``test_torch_train_cli.check_cli_restart``).
"""
import dataclasses
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from test_torch_models import (_close, _t, check_forward_loss_and_grads,  # noqa: E402
                               check_init)
from test_torch_train_cli import check_cli_restart  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.paths import flatten_with_path  # noqa: E402
from repro_torch.models import attention  # noqa: E402


@pytest.fixture(autouse=True)
def _keep_signal_handlers():
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def test_lm_init_matches_jax():
    check_init("minicpm3-4b")


def test_lm_forward_loss_and_grads_match_jax():
    check_forward_loss_and_grads("minicpm3-4b")


def _mla(arch, absorbed):
    cfgs = [dataclasses.replace(get(arch, smoke=True), mla_absorbed=absorbed,
                                attn_chunk=16)
            for get in (jget, get_config)]
    return cfgs


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-236b"])
@pytest.mark.parametrize("absorbed", [False, True], ids=["expanded", "absorbed"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_mla_forward_and_grads_match_jax(arch, absorbed, causal):
    jcfg, tcfg = _mla(arch, absorbed)
    jp = jattn.init_mla(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32)).copy()

    @jax.jit
    def jvjp(p, a, c):
        y, vjp = jax.vjp(lambda p, a: jattn.mla_forward(
            p, a, jcfg, positions=jnp.asarray(pos), causal=causal), p, a)
        return y, vjp(c)

    jy, (jgp, jgx) = jvjp(jp, jnp.asarray(x), jnp.asarray(ct))
    tp = {k: v.requires_grad_(True) for k, v in
          convert.params(jax.tree.map(np.asarray, jp), "cpu").items()}
    tx = _t(x).requires_grad_(True)
    y = attention.mla_forward(tp, tx, tcfg, positions=_t(pos), causal=causal)
    grads = torch.autograd.grad(y, [tx, *tp.values()], _t(ct))
    _close(y, jy, 2e-6, "y")
    _close(grads[0], jgx, 2e-6, "dx")
    want = dict(flatten_with_path(jax.tree.map(np.asarray, jgp)))
    for name, g in zip(tp, grads[1:]):
        _close(g, want[name], 2e-6, name)
    other = dataclasses.replace(tcfg, mla_absorbed=not absorbed)
    with torch.no_grad():
        y2 = attention.mla_forward(tp, tx, other, positions=_t(pos),
                                   causal=causal)
    _close(y2, y.detach().numpy(), 2e-6, "expanded vs absorbed")


def test_cli_trains_and_restarts_bit_equal(tmp_path):
    check_cli_restart("minicpm3-4b", tmp_path / "ck", ["--batch", "2", "--seq", "16"])
