"""The port's dense-attention LM stack against the JAX package's, on the CPU.

The same inputs, drawn from a numpy seed, go through both packages.
Tolerances (float32 unless stated):

* ``common``: ``rms_norm``, ``apply_rope``, ``apply_mrope``, ``activation``
  and ``softmax_cross_entropy`` within ``rtol=2e-6`` (``atol`` 1e-6 of the
  largest magnitude): XLA-CPU's ``rsqrt``/``sin``/``cos``/``tanh`` and its
  fused multiply-adds differ from torch's by a few ULP. bfloat16
  ``rms_norm``: within one bf16 ULP.
* ``chunked_attention``: output and the gradients of its custom VJP
  against ``jax.vjp`` within 2e-6 of each array's largest magnitude
  (another summation order in the einsums).
* ``LM.forward`` / ``LM.loss`` / gradients on the smoke configs of the four
  dense-attention archs, from the JAX package's parameters converted with
  ``repro_torch.convert.params``: logits within 2e-6 of their largest
  magnitude, loss within ``rtol=1e-6``, every gradient leaf within 1e-5 of
  its largest magnitude (``check_forward_loss_and_grads``, which the files
  of the other block families, ``test_torch_{moe,mla,recurrent,encdec}``,
  run on their archs).
* ``LM.init`` against JAX's ``init`` from the same key: the same tree,
  shapes and dtypes; values at most 4 float32 ULP apart
  (``prng.normal`` is at most 3 ULP off ``jax.random.normal``).
  ``abstract_params`` of all ten archs at full width against
  ``jax.eval_shape``: the same paths, shapes and dtypes. The depth cut of
  the card's full-width runs (``step_profile.cut_depth``) keeps every
  other field; their plans' analog paths and elements, exact.
* Every arch inits and its serve modes run: the fixed driver's
  ``prefill`` and ``decode`` (an encoder-decoder's through its encoder and
  the cross K/V cache), and for a decoder-only arch the engine's ``chunk``
  and per-lane ``decode``; an unknown mode raises ``ValueError``.
* The analog plan of the qwen2 smoke config: ``describe_plan``, the
  TileBank index and class index identical.
* Three analog train steps of the qwen2 smoke config (E-RIDER,
  ``microbatch=2``) from one state carried across with
  ``convert.train_state``, under ``update_backend`` ``vmap`` and
  ``fused``: every metric within ``rtol=1e-6``; every tile leaf within
  1e-6 on all but at most 0.1 % of its elements, each of those off by a
  whole pulse (>= 1e-4): a ULP apart in a gradient can flip a
  stochastic-rounding pulse. With the training CLI's non-smoke tile
  config (bfloat16 state, hash noise): metrics within ``rtol=2e-5`` (a
  flipped pulse moves the pulse-count sum), every tile leaf bit-equal on
  all but at most 0.1 % of its elements, each of those off by at most one
  pulse (``2 * dw_min``: the response is below 2) or one bfloat16 ULP.
  The pulse-update wrapper runs 2 x 12 = 24 times a step under ``vmap``
  (two arrays per analog path) and 2 x 7 = 14 under ``fused`` (two per
  scan class) (``check_analog_train_steps``; deepseek-v2-236b and
  mamba2-2.7b in ``test_torch_{moe,recurrent}_train.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core.device import DeviceConfig as JDev  # noqa: E402
from repro.core.digital_opt import DigitalOptConfig as JOpt  # noqa: E402
from repro.core.digital_opt import ScheduleConfig as JSched  # noqa: E402
from repro.core.tile import TileConfig as JTile  # noqa: E402
from repro.core.trainer import AnalogTrainer as JTrainer  # noqa: E402
from repro.core.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.core.trainer import default_analog_filter as jfilter  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.device import DeviceConfig  # noqa: E402
from repro_torch.core.digital_opt import DigitalOptConfig, ScheduleConfig  # noqa: E402
from repro_torch.core.paths import TensorSpec, flatten_with_path, tree_map_with_path  # noqa: E402
from repro_torch.core.tile import TileConfig  # noqa: E402
from repro_torch.core.trainer import AnalogTrainer, TrainerConfig  # noqa: E402
from repro_torch.core.trainer import default_analog_filter  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, blocks, common  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

DENSE = ["gemma3-4b", "qwen2-0.5b", "qwen2-vl-2b", "qwen3-14b"]
B, S = 2, 32


def _close(got, want, rel: float, err=""):
    """|got - want| <= rel * max|want| everywhere."""
    got = got.detach().to(torch.float32).numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (err, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    diff = float(np.abs(got - want).max())
    assert diff <= rel * scale, (err, diff, scale)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_lm(arch: str):
    """The JAX package's smoke LM and its parameters from key 0."""
    jm = JLM(jget(arch, smoke=True))
    return jm, jm.init(jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------


def test_rms_norm_activation_and_cross_entropy_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    w = (0.1 * rng.standard_normal(48)).astype(np.float32)
    np.testing.assert_allclose(common.rms_norm(_t(x), _t(w), 1e-6).numpy(),
                               np.asarray(jcommon.rms_norm(x, w, 1e-6)),
                               rtol=2e-6, atol=1e-6)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    want = jcommon.rms_norm(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(w, jnp.bfloat16), 1e-6)
    got = common.rms_norm(xb, wb, 1e-6)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
    assert np.all(np.abs(got.float().numpy() - want) <= ulp)
    for kind in ("silu", "gelu"):
        np.testing.assert_allclose(common.activation(_t(x), kind).numpy(),
                                   np.asarray(jcommon.activation(x, kind)),
                                   rtol=2e-6, atol=1e-6, err_msg=kind)
    logits = rng.standard_normal((2, 7, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 40, (2, 7)).astype(np.int32)
    labels[0, :3] = np.argmax(logits[0, :3], -1)  # some right answers
    loss, aux = common.softmax_cross_entropy(_t(logits), _t(labels))
    jloss, jaux = jcommon.softmax_cross_entropy(logits, labels)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-6)
    np.testing.assert_allclose(float(aux["ce"]), float(jaux["ce"]), rtol=2e-6)
    assert float(aux["accuracy"]) == float(jaux["accuracy"]) > 0


def test_rope_and_mrope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    np.testing.assert_allclose(
        common.apply_rope(_t(x), _t(pos), 1e6).numpy(),
        np.asarray(jcommon.apply_rope(x, pos, 1e6)), rtol=2e-6, atol=1e-6)
    pos3 = rng.integers(0, 50, (3, 2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        common.apply_mrope(_t(x), _t(pos3), (4, 6, 6)).numpy(),
        np.asarray(jcommon.apply_mrope(x, pos3, (4, 6, 6))),
        rtol=2e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# chunked attention and its custom VJP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H,KV,S,chunk,causal,window", [
    (4, 2, 32, 16, True, 8),      # sliding window, two chunks
    (4, 4, 30, 12, True, 0),      # chunk < S, padded last chunk
    (6, 2, 24, 8, False, 0),      # GQA with G = 3, bidirectional
], ids=["window", "padded-chunk", "gqa"])
def test_chunked_attention_and_grads_match_jax(H, KV, S, chunk, causal, window):
    rng = np.random.default_rng(H * 100 + S)
    D = 16
    q = rng.standard_normal((2, S, H, D)).astype(np.float32)
    k = rng.standard_normal((2, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((2, S, KV, D)).astype(np.float32)
    ct = rng.standard_normal((2, S, H, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, chunk=chunk)
    want, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(a, b, c, **kw),
                        q, k, v)
    wgrads = vjp(jnp.asarray(ct))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = attention.chunked_attention(tq, tk, tv, **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(ct))
    _close(out, want, 2e-6, "out")
    for name, g, w in zip("qkv", grads, wgrads):
        _close(g, w, 2e-6, f"d{name}")


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------


def _batch(cfg):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.frontend:
        batch["frames"] = (0.1 * rng.standard_normal((B, S, cfg.d_model))
                           ).astype(np.float32)
    return batch


def check_forward_loss_and_grads(arch):
    """``LM.forward`` / ``LM.loss`` / every gradient of the smoke config of
    ``arch`` against the JAX package's, from JAX's parameters converted
    (the reference's ``test_forward_and_grads``, B=2, S=32). The MoE aux
    loss rides in the loss and its own ``moe_aux`` entry."""
    (jm, jp), tm = _jax_lm(arch), LM(get_config(arch, smoke=True))
    tp = convert.params(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(jm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = tm.forward(tp, tb["tokens"], tb.get("frames"))
    assert logits.shape == (B, S, jm.cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    if not jm.cfg.n_experts:
        assert float(aux) == 0.0

    def jloss_fn(p):  # jm.loss, with the logits kept: one compile
        jlogits, jaux_moe = jm.forward(p, jb["tokens"], jb.get("frames"))
        loss, aux = jcommon.softmax_cross_entropy(jlogits, jb["labels"])
        if jm.cfg.n_experts:
            loss = loss + jm.cfg.aux_loss_coef * jaux_moe
            aux["moe_aux"] = jaux_moe
        return loss, (aux, jlogits)

    (jloss, (jaux, jlogits)), jgrads = jax.jit(
        jax.value_and_grad(jloss_fn, has_aux=True))(jp)
    _close(logits, jlogits, 2e-6, "logits")
    leaves = {p: leaf.requires_grad_(True) for p, leaf in flatten_with_path(tp)}
    loss, aux = tm.loss(tree_map_with_path(lambda p, _: leaves[p], tp), tb, None)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert loss.item() > 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert sorted(aux) == sorted(jaux)
    for k in ("ce", "moe_aux"):
        if k in jaux:
            np.testing.assert_allclose(aux[k].item(), float(jaux[k]),
                                       rtol=1e-6, err_msg=k)
    assert float(aux["accuracy"]) == float(jaux["accuracy"])
    jflat = dict(flatten_with_path(jax.tree.map(np.asarray, jgrads)))
    assert sorted(jflat) == sorted(leaves)
    for p, g in zip(leaves, grads):
        assert bool(torch.isfinite(g).all()), p
        _close(g, jflat[p], 1e-5, p)


def check_init(arch):
    """``LM.init`` against JAX's ``init`` from the same key: the same tree,
    shapes and dtypes; values at most 4 float32 ULP apart."""
    _, jp = _jax_lm(arch)
    tp = LM(get_config(arch, smoke=True)).init(prng.PRNGKey(0), device="cpu")
    want = flatten_with_path(jax.tree.map(np.asarray, jp))
    got = flatten_with_path(tp)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == a.shape and str(t.dtype) == f"torch.{a.dtype}", p
        ulp = np.spacing(np.abs(a)).astype(np.float32)
        off = np.abs(t.numpy() - a) / ulp
        worst = np.unravel_index(np.argmax(off), off.shape)
        assert off[worst] <= 4, (p, worst, float(off[worst]), a[worst],
                                 t.numpy()[worst])


@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_loss_and_grads_match_jax(arch):
    check_forward_loss_and_grads(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_lm_init_matches_jax(arch):
    check_init(arch)


def test_abstract_params_allocate_nothing_and_match_init():
    model = LM(get_config("qwen2-0.5b", smoke=True))
    specs = model.abstract_params(device="cpu")
    real = model.init(prng.PRNGKey(0), device="cpu")
    got, want = flatten_with_path(specs), flatten_with_path(real)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, s), (_, t) in zip(got, want):
        assert s == TensorSpec(t.shape, t.dtype, "cpu"), p
    # the full-width tree is built without drawing a number
    full = LM(get_config("qwen2-0.5b")).abstract_params(device="cpu")
    n = sum(int(np.prod(s.shape)) for _, s in flatten_with_path(full))
    assert n == get_config("qwen2-0.5b").param_count() + 24 * (896 * 2 + 1152) + 896
    assert all(s.dtype == torch.bfloat16 for _, s in flatten_with_path(full))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_width_abstract_params_match_jax(arch):
    """``abstract_params`` of every arch at full width (the 4-D expert
    stacks, the float32 SSD leaves, the encoder tree) against
    ``jax.eval_shape`` of the reference's ``init``: the same paths, shapes
    and dtypes, drawing nothing."""
    want = flatten_with_path(JLM(jget(arch)).abstract_params())
    got = flatten_with_path(LM(get_config(arch)).abstract_params(device="cpu"))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == a.shape, p
        assert str(t.dtype) == f"torch.{np.dtype(a.dtype).name}", p


@pytest.mark.parametrize("arch,n_paths,n_analog,largest", [
    ("minicpm3-4b", 15, 689_426_432, 188_026_880),
    ("mamba2-2.7b", 14, 321_689_472, 104_857_600)])
def test_depth_cut_of_the_full_width_runs(arch, n_paths, n_analog, largest):
    """The full-width LM runs on the card (``chip_smoke.py`` phase 11,
    ``benchmarks/step_profile.py --layers 8``) cut the depth to 8 layers and
    nothing else: the plan of the CLI's trainer over the cut tree, its
    analog paths, elements and largest leaf (bf16 tiles, 8 B an element)."""
    from repro_torch.benchmarks.step_profile import cut_depth
    from repro_torch.launch import train

    full = get_config(arch)
    cfg = cut_depth(full, 8)
    assert cfg.n_layers == cfg.n_periods == 8
    assert dataclasses.replace(cfg, n_layers=full.n_layers,
                               n_periods=full.n_periods) == full
    model = LM(cfg)
    trainer = train.make_trainer(model, "erider", False, 6)
    state = trainer.abstract_state(model.abstract_params(device="cpu"),
                                   device="cpu")
    bank = state["tiles"]
    sizes = [int(np.prod(st["W"].shape)) for st in bank.classes.values()]
    assert sum(len(ps) for _, ps in bank.index) == n_paths
    assert sum(sizes) == n_analog
    assert max(int(np.prod(st["W"].shape[2:])) for st in
               bank.classes.values()) == largest
    assert {st["W"].dtype for st in bank.classes.values()} == {torch.bfloat16}
    with pytest.raises(ValueError, match="cannot cut"):
        cut_depth(get_config("recurrentgemma-9b"), 8)   # a tail
    with pytest.raises(ValueError, match="cannot cut"):
        cut_depth(get_config("deepseek-v2-236b"), 8)    # a dense prefix


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_unported_arch_raises_at_init(arch):
    """Every arch inits and every serve mode runs on its smoke config: a
    4-token prefill and a decode step of the fixed driver's dense cache,
    and for a decoder-only arch a 4-token chunk into lane 1 of the paged
    cache and a per-lane decode step (lane 0 idle). Finite logits, the
    caches written in place; an unknown mode raises ``ValueError``."""
    cfg = get_config(arch, smoke=True)
    model = LM(cfg)
    params = model.init(prng.PRNGKey(0), device="cpu")
    toks = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    batch = {"tokens": toks}
    if cfg.is_encdec:
        batch["frames"] = torch.ones((2, 3, cfg.d_model), dtype=cfg.dtype)
    cache = model.init_cache(2, 6, enc_len=3, device="cpu")
    logits, out = model.prefill(params, batch, cache)
    assert out is cache and logits.shape == (2, 1, cfg.vocab)
    logits, _ = model.decode_step(params, toks[:, :1], cache, 4)
    assert logits.shape == (2, 1, cfg.vocab) and torch.isfinite(logits).all()
    assert all(int(leaf[..., :5].min()) == 0
               for p_, leaf in flatten_with_path(cache) if p_.endswith("pos"))
    if cfg.is_encdec:
        assert float(cache["body"]["p0"]["ck"].abs().max()) > 0
    else:
        paged = model.init_paged_cache(2, 5, 4, 8, device="cpu")
        one = torch.ones(1, dtype=torch.int32)
        logits, out = model.prefill_commit_batch(
            params, toks[:1], paged, torch.tensor([[3, 4]], dtype=torch.int32),
            one, 0 * one, 4 * one, one.bool())
        assert out is paged and torch.isfinite(logits).all()
        logits, _ = model.decode_step_lanes(
            params, toks[:, :1], paged,
            torch.tensor([[0, 0], [3, 4]], dtype=torch.int32),
            torch.tensor([0, 4], dtype=torch.int32),
            torch.tensor([False, True]))
        assert logits.shape == (2, 1, cfg.vocab) and torch.isfinite(logits).all()
    x = torch.zeros((1, 4, cfg.d_model), dtype=cfg.dtype)
    with pytest.raises(ValueError):
        blocks.apply_stack(params["stack"], x, cfg, "serve")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        LM(get_config("qwen2-0.5b", smoke=True)).init(prng.PRNGKey(0))


# ---------------------------------------------------------------------------
# the analog plan and the analog train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["erider", "attn=rider,**=erider"])
def test_lm_plan_groups_and_classes_match_jax(spec):
    from repro.launch import train as jtrain

    from repro_torch.launch import train

    (jm, jp), tm = _jax_lm("qwen2-0.5b"), LM(get_config("qwen2-0.5b", smoke=True))
    jtr = JTrainer(jm.loss, JTrainerConfig(), plan=jtrain.make_plan(spec, True))
    ttr = AnalogTrainer(tm.loss, TrainerConfig(), plan=train.make_plan(spec, True))
    tp = tm.init(prng.PRNGKey(0), device="cpu")
    assert ttr.describe_plan(tp) == jtr.describe_plan(jp)
    if spec == "erider":
        assert ttr.describe_plan(tp).startswith(
            "plan: 12 analog paths -> 8 groups")
    jbank = jtr.init(jax.random.PRNGKey(1), jp)["tiles"]
    tbank = ttr.init(prng.PRNGKey(1), tp)["tiles"]
    assert tbank.index == jbank.index
    assert tbank.class_index == jbank.class_index
    if spec == "erider":
        assert len(tbank.class_index) == 7


def _carry(js):
    bank = js["tiles"]
    return convert.train_state({
        "step": js["step"], "key": js["key"],
        "params": jax.tree.map(np.asarray, js["params"]),
        "opt": jax.tree.map(np.asarray, js["opt"]),
        "tiles": {"classes": {c: jax.tree.map(np.asarray, st)
                              for c, st in bank.classes.items()},
                  "index": bank.index, "class_index": bank.class_index,
                  "policies": {g: jplan.policy_to_json(p)
                               for g, p in bank.policies.items()}},
    }, "cpu")


def _trainers(backend: str, tiles: str, arch: str = "qwen2-0.5b"):
    """Both packages' trainers on the smoke model of ``arch``: the reference's
    ``test_analog_train_step_smoke`` set-up (``tiles="smoke"``, float32
    state, threefry noise), or the training CLI's non-smoke tile config
    and optimizer (``tiles="full"``: bfloat16 state, hash noise, device
    parameters redrawn from seeds)."""
    from repro.launch import train as jtrain

    from repro_torch.launch import train

    jm, tm = _jax_lm(arch)[0], LM(get_config(arch, smoke=True))
    if tiles == "full":
        sched = dict(kind="cosine", base_lr=0.1, total_steps=3)
        jtr = JTrainer(jm.loss, JTrainerConfig(
            digital=JOpt(kind="sgdm", clip_norm=1.0), schedule=JSched(**sched),
            microbatch=2), plan=jtrain.make_plan("erider", False))
        ttr = AnalogTrainer(tm.loss, TrainerConfig(
            digital=DigitalOptConfig(kind="sgdm", clip_norm=1.0),
            schedule=ScheduleConfig(**sched), microbatch=2),
            plan=train.make_plan("erider", False))
        return jm, jtr, ttr
    dev = dict(dw_min=0.001, sigma_pm=0.3, sigma_d2d=0.1)
    jtr = JTrainer(jm.loss, JTrainerConfig(
        tile=JTile(algorithm="erider", device_p=JDev(**dev),
                   device_w=JDev(**dev), update_backend=backend),
        digital=JOpt(kind="sgdm"), schedule=JSched(base_lr=0.05),
        microbatch=2), jfilter)
    ttr = AnalogTrainer(tm.loss, TrainerConfig(
        tile=TileConfig(algorithm="erider", device_p=DeviceConfig(**dev),
                        device_w=DeviceConfig(**dev), update_backend=backend),
        digital=DigitalOptConfig(kind="sgdm"), schedule=ScheduleConfig(base_lr=0.05),
        microbatch=2), default_analog_filter)
    return jm, jtr, ttr


def _bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    x = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(x)) - 7).astype(np.float32)


@pytest.mark.parametrize("backend,tiles,calls", [
    ("vmap", "smoke", 24), ("fused", "smoke", 14), ("vmap", "full", 24)])
def test_analog_train_step_matches_jax(backend, tiles, calls, monkeypatch):
    check_analog_train_steps("qwen2-0.5b", backend, tiles, calls, monkeypatch)


def check_analog_train_steps(arch, backend, tiles, calls, monkeypatch):
    """Three analog train steps of the smoke config of ``arch`` in both
    packages from one state carried with ``convert.train_state``; the
    pulse-update wrapper runs ``calls`` times a step."""
    jm, jtr, ttr = _trainers(backend, tiles, arch)
    js = jtr.init(jax.random.PRNGKey(1), _jax_lm(arch)[1])
    ts = _carry(js)
    count = [0]
    wrapped = ops.analog_update

    def counting(*a, **kw):
        count[0] += 1
        return wrapped(*a, **kw)

    monkeypatch.setattr(ops, "analog_update", counting)
    step = jtr.jit_step(donate=False)
    rng = np.random.default_rng(0)
    for i in range(3):
        toks = rng.integers(0, jm.cfg.vocab, (4, S)).astype(np.int32)
        b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
        js, jmet = step(js, {k: jnp.asarray(v) for k, v in b.items()})
        count[0] = 0
        ts, tmet = ttr.train_step(ts, {k: _t(v) for k, v in b.items()})
        assert count[0] == calls, (i, count[0])
        assert set(tmet) == set(jmet)
        for k in jmet:
            np.testing.assert_allclose(
                float(tmet[k]), float(jmet[k]),
                rtol=2e-5 if tiles == "full" else 1e-6, err_msg=f"step {i} {k}")
    assert ts["tiles"].class_index == js["tiles"].class_index
    for c, st in js["tiles"].classes.items():
        for leaf in ("W", "P", "Qd", "Qt"):
            got = ts["tiles"].classes[c][leaf]
            want = np.asarray(st[leaf].astype(jnp.float32))
            diff = np.abs(got.float().numpy() - want)
            if tiles == "full":
                # bfloat16 state: bit-equal but for a flipped pulse
                # (dw_min 1e-4 times a response below 2) or one ULP
                assert got.dtype == torch.bfloat16
                off = diff > 0
                ulp = _bf16_ulp(np.maximum(np.abs(want), np.abs(got.float().numpy())))
                assert np.all(diff <= np.maximum(ulp, 2e-4)), (c, leaf)
            else:
                off = diff > 1e-6
                assert np.all(diff[off] >= 1e-4), (c, leaf, diff[off])
            assert off.mean() <= 1e-3, (c, leaf, off.mean())
    for p, a in flatten_with_path(jax.tree.map(np.asarray, js["params"])):
        np.testing.assert_allclose(dict(flatten_with_path(ts["params"]))[p].numpy(),
                                   a, rtol=1e-6, atol=1e-6, err_msg=p)
