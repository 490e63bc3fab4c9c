"""Analog training of the port's Mamba-2 model against the JAX package's, on
the CPU: the reference's ``test_analog_train_step_smoke`` for mamba2-2.7b
(smoke: three SSD layers, tied embeddings).

Three E-RIDER train steps (microbatch 2) in both packages from one state
carried across with ``convert.train_state``, under ``update_backend``
``vmap`` and ``fused``, with ``test_torch_models.check_analog_train_steps``'s
tolerances: every metric within ``rtol=1e-6``; every tile leaf within 1e-6
on all but at most 0.1 % of its elements, each of those off by a whole
pulse; the digital parameters within 1e-6. The pulse-update wrapper runs
2 x 14 times a step under ``vmap`` (two arrays per analog path; the
stacked float32 ``a_log`` / ``dt_bias`` / ``d_skip`` (3, 8) are analog
paths as in the reference) and 2 x 9 under ``fused`` (two per scan class).

A file of its own: the JAX side compiles each backend's step for tens of
seconds, and the test runner hands whole files to its workers.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_models import check_analog_train_steps  # noqa: E402


@pytest.mark.parametrize("backend,calls", [("vmap", 28), ("fused", 18)])
def test_analog_train_step_matches_jax(backend, calls, monkeypatch):
    check_analog_train_steps("mamba2-2.7b", backend, "smoke", calls,
                             monkeypatch)
