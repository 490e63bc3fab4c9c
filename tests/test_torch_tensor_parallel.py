"""Compute over the model axis (``--model-parallel``): the port against one
process and against the JAX package's host mesh.

* ``distributed.sharding.tp_layout`` on the ten archs' full configs at a
  model axis of 2 and 4: a module splits exactly where the reference's
  hint shards its activation (``attention_q_spec`` on the query heads,
  ``hint_spec`` on the MLP's hidden units, the RG-LRU's channels and the
  vocabulary, both held to JAX by ``test_torch_distributed``), on the dim
  ``param_spec`` shards: MLA's up-projections on the heads, its latents
  whole; the RG-LRU in whole gate blocks; SSD on its heads, B and C with
  the groups; cross-attention and the encoder as dense attention.
* Two gloo ranks on a (1, 2) mesh (``torch_ranks.tp_all``), float32 at
  smoke size: ``copy_to_model`` / ``reduce_from_model`` around a column
  and a row product, ``vocab_rows`` and the vocab-parallel CE (z-loss, a
  mask, argmax ties inside and across the blocks); dense GQA with biases,
  qk-norm, a sliding window with one KV head (``wk``/``wv`` read whole),
  M-RoPE, the MLP, the routed experts on the einsum, gather and ragged
  paths and the shared experts, the vocabulary's embedding and CE. Each
  output and input gradient within ``MODULE_RTOL`` of one process (the
  largest difference over the tensor's largest magnitude; a row split sums
  two halves), each split weight's gradient block equal to the same block
  of one process's gradient, one model-group all-reduce per split module.
* The CLI with ``--model-parallel 2`` (two ranks) and ``--data-parallel 2
  --model-parallel 2`` (four ranks) on qwen2-0.5b and mixtral-8x7b smoke
  against one rank: loss, accuracy and sp_err within ``LOSS_RTOL`` at each
  of 3 steps, every float leaf within 1e-5 but for at most 0.1 % of its
  elements (a stochastic-rounding pulse flipped by a last-bit difference
  in a gradient), no model-group all-gather of a weight in the forward and
  ``tp_layout.all_reduces()`` model-group all-reduces a step.
* The same qwen2 smoke run on (1, 2) against the JAX CLI on a (1, 2) mesh
  of two forced host devices: loss and sp_err within ``JAX_RTOL``.
* MLA (minicpm3-4b), RG-LRU (recurrentgemma-9b), SSD (mamba2-2.7b) and the
  encoder-decoder (seamless-m4t-large-v2, with frames) on (1, 2): their
  mixers split, within the CLI's standard of one process, with
  ``tp_layout.all_reduces()`` model-group all-reduces a step
  (``test_torch_tensor_parallel_mixers`` holds each mixer alone).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(os.path.dirname(HERE), "src"), HERE]

import torch_ranks  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.paths import flatten_with_path  # noqa: E402
from repro_torch.core.trainer import AnalogTrainer, TrainerConfig  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.common import attention_q_spec, hint_spec  # noqa: E402

MODULE_RTOL = 2e-6       # measured: <= 4.6e-7 (the MoE router's gradient)
LOSS_RTOL = 1e-6         # measured: <= 8e-8 on (1, 2)
JAX_RTOL = 2e-6          # measured: 1.5e-7
STEPS = 3
ARGV = ["--smoke", "--steps", str(STEPS), "--batch", "4", "--device", "cpu",
        "--log-every", "1", "--ckpt-every", "100"]
# mixtral at 512 tokens: MoE groups of 64 within each data rank's rows,
# the einsum dispatch
CLI_ARCHS = {"qwen2-0.5b": 16, "mixtral-8x7b": 128}
FAMILIES = ("minicpm3-4b", "recurrentgemma-9b", "mamba2-2.7b",
            "seamless-m4t-large-v2")


def _argv(arch, data=1, model=1):
    return ARGV + ["--arch", arch, "--seq", str(CLI_ARCHS[arch]),
                   "--data-parallel", str(data), "--model-parallel", str(model)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything on ranks at once, with the one-process runs and the JAX
    CLI beside them: the (1, 2) programs on two ranks, the (2, 2) CLI runs
    on four, the JAX (1, 2) run in its own process."""
    work = tmp_path_factory.mktemp("tp")
    metrics = str(work / "jax_metrics.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(HERE), "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    jax = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", "--smoke", "--steps",
         str(STEPS), "--batch", "4", "--seq", "16", "--log-every", "1",
         "--model-parallel", "2", "--metrics-out", metrics],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    two = torch_ranks.start(
        "tp_all", 2, str(work), timeout=240, data=1, model=2,
        argvs=[_argv(a, 1, 2) for a in CLI_ARCHS], archs=list(FAMILIES),
        batch=4, seq=16, steps=2)
    four = torch_ranks.start("cli_runs", 4, str(work), timeout=240, data=2,
                             model=2,
                             argvs=[_argv(a, 2, 2) for a in CLI_ARCHS])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # as the ranks run
    try:
        one = {a: train.main(_argv(a)) for a in CLI_ARCHS}
        fam = {a: torch_ranks.lm_steps(None, "cpu", a, 4, 16, 2)
               for a in FAMILIES}
    finally:
        torch.set_num_threads(threads)
    res2, res4 = two.wait(), four.wait()
    try:
        _, err = jax.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        jax.kill()
        raise
    assert jax.returncode == 0, err[-3000:]
    with open(metrics) as f:
        jhist = json.load(f)
    return dict(two=res2, four=res4, one=one, fam=fam, jax=jhist)


def _close(got, want, rtol, label):
    """The largest difference within ``rtol`` of the largest magnitude."""
    got, want = got.double(), want.double()
    assert got.shape == want.shape, label
    scale = float(want.abs().max()) or 1.0
    gap = float((got - want).abs().max())
    assert gap <= rtol * scale, (label, gap, scale)


def _leaves_close(got_tree, want_tree, label):
    """Every float leaf within 1e-5 but for at most 0.1 % of its elements
    (a flipped pulse); integer leaves equal."""
    got = dict(flatten_with_path(got_tree))
    for p, want in flatten_with_path(want_tree):
        g = got[p]
        if not want.is_floating_point():
            assert torch.equal(g, want), (label, p)
            continue
        off = (g.double() - want.double()).abs() > 1e-5
        assert float(off.double().mean()) <= 1e-3, (label, p,
                                                    int(off.sum()))


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tp_layout_splits_where_the_reference_hints(arch):
    cfg = get_config(arch)
    for m in (2, 4):
        mesh = make_host_mesh(1, m)
        rules = sh.logical_rules(mesh)
        layout = sh.tp_layout(cfg, mesh)
        heads = attention_q_spec((8, 16, cfg.n_heads, cfg.head_dim),
                                 rules) is not None
        mlp = hint_spec((8, 16, cfg.d_ff), ("batch", None, "mlp"), rules)
        vocab = hint_spec((8, 16, cfg.vocab), ("batch", None, "vocab"), rules)
        params = dict(flatten_with_path(
            train.LM(cfg).abstract_params("meta")))
        assert sorted(layout.entries) == sorted(params)
        for p, e in layout.entries.items():
            shape = tuple(params[p].shape)
            mod, name = p.rsplit("/", 1) if "/" in p else ("", p)
            part = mod.rsplit("/", 1)[-1]
            label = f"{arch} M={m} {p}"
            if e.dim is not None:
                # the dim param_spec shards and rule_template names "M"
                assert sh.param_spec(p, shape, mesh)[e.dim] == "model", label
                assert sh.rule_template(p, len(shape))[e.dim] == "M", label
            mla = part == "attn" and f"{mod}/wdkv" in params
            ssd = part == "mix" and f"{mod}/a_log" in params
            assert "15c" not in e.why, label
            if p == "embed":
                assert (e.kind, e.dim) == (("vocab", -2) if vocab
                                           else ("replicated", None)), label
            elif p == "head":
                assert (e.dim == -1) == (vocab is not None), label
            elif mla and name in ("wuq", "wuk", "wuv", "wo"):
                # the up-projections on the query heads, wo their rows
                assert (e.dim is not None) == heads, label
                assert e.kind == ("row" if name == "wo" else "column") \
                    or not heads, label
            elif mla:
                # wdq, wdkv, wkr and their norms: the latents run whole
                assert e.dim is None, label
            elif ssd and name in ("wb", "wc", "conv_b", "conv_c"):
                # B and C split with the groups, else read whole
                assert (e.dim is not None) == (
                    cfg.ssm_heads % m == 0 and cfg.ssm_groups % m == 0), label
            elif ssd and name == "norm":
                assert e.dim is None, label
            elif ssd:
                assert (e.dim is not None) == (cfg.ssm_heads % m == 0), label
                assert e.kind == ("row" if name == "wout" else "column") \
                    or e.dim is None, label
            elif part == "mix":
                # the RG-LRU: its channels (the hint on u) in whole gate
                # blocks
                rnn = hint_spec((8, 16, cfg.rnn_width),
                                ("batch", None, "mlp"), rules)
                assert (e.dim is not None) == (
                    rnn is not None and cfg.n_heads % m == 0), label
                assert e.kind == ("row" if name == "wout" else "column") \
                    or e.dim is None, label
            elif part in ("attn", "cross") and name in ("wq", "bq", "wo"):
                # dense attention, the encoder's and the cross-attention
                assert (e.dim is not None) == heads, label
                assert e.kind == ("row" if name == "wo" else "column") \
                    or not heads, label
            elif part in ("attn", "cross") and name in ("wk", "wv", "bk",
                                                        "bv"):
                assert (e.dim is not None) == (heads and cfg.n_kv % m == 0), \
                    label
            elif part == "mlp":
                assert (e.dim is not None) == (mlp is not None), label
            elif part == "moe" and name != "router":
                assert (e.dim is not None) == ("model" in sh.param_spec(
                    p, shape, mesh)), label
            else:
                assert e.dim is None, label
    if arch == "qwen2-0.5b":
        # 24 layers x (attention, MLP) x (forward, recompute, backward),
        # then the embedding, the logits' gradient and the CE's three
        assert sh.tp_layout(cfg, make_host_mesh(1, 2)).all_reduces() == 149
        # 14 heads on 4 ranks: attention replicates, the MLP splits
        four = sh.tp_layout(cfg, make_host_mesh(1, 4))
        assert four.dim("stack/body/p0/attn/wq") is None
        assert four.dim("stack/body/p0/mlp/wi") == -1
        assert four.all_reduces() == 24 * 3 + 5


def test_tp_layout_refuses_a_mismatched_trainer():
    cfg = get_config("qwen2-0.5b", smoke=True)
    layout = sh.tp_layout(cfg, make_host_mesh(1, 2))
    with pytest.raises(ValueError, match="model ranks"):
        AnalogTrainer(train.LM(cfg).loss, TrainerConfig(),
                      plan=train.make_plan("erider", True),
                      tensor_parallel=layout)


def test_a_block_outside_a_model_axis_raises():
    """A module never runs on a weight's block as if it were whole, and a
    model axis of two ranks needs its group."""
    from repro_torch.models import common, moe

    cfg = get_config("qwen2-0.5b", smoke=True)
    d, ff = cfg.d_model, cfg.d_ff
    half = {"wi": torch.zeros(d, ff // 2), "wg": torch.zeros(d, ff // 2),
            "wo": torch.zeros(ff // 2, d)}
    with pytest.raises(ValueError, match="mlp/wi"):
        moe.mlp_forward(half, torch.zeros(1, 2, d), cfg)
    with pytest.raises(ValueError, match="group"):
        with common.model_parallel(None, 2, 0):
            pass
    # whole weights under no axis: the one-process module, no collective
    whole = {k: torch.zeros(d, ff) if k != "wo" else torch.zeros(ff, d)
             for k in half}
    assert moe.mlp_forward(whole, torch.zeros(1, 2, d), cfg).shape == (1, 2, d)


# ---------------------------------------------------------------------------
# the operators and the split modules on (1, 2)
# ---------------------------------------------------------------------------

MODULES = sorted(torch_ranks._tp_module_cases())


def _check_case(res, label, calls):
    for a, b in zip(res["out"], res["ref_out"]):
        _close(a, b, MODULE_RTOL, f"{label} out")
    for a, b in zip(res["dx"], res["ref_dx"]):
        _close(a, b, MODULE_RTOL, f"{label} dx")
    for n, g in res["grads"].items():
        want = res["ref_grads"][n]
        if want is None:
            assert g is None, (label, n)
            continue
        _close(g, want, MODULE_RTOL, f"{label} d{n}")
    assert res["calls"] == calls, (label, res["calls"])


@pytest.mark.parametrize("case", MODULES)
def test_split_module_matches_one_process(runs, case):
    for rank in runs["two"]:
        res = rank["modules"][case]
        if case == "vocab":
            calls = {"model/all_reduce/embed": 1, "model/all_reduce/max": 2,
                     "model/all_reduce/ce": 1}
            assert res["split"] == ["embed"]
        else:
            n = 2 if case == "moe_shared" else 1
            calls = {"model/all_reduce/out": n}
            assert {"wq", "wo"} <= set(res["split"]) or "wi" in res["split"]
        _check_case(res, case, calls)
    if case == "window_kv_whole":
        # one KV head on two ranks: wk/wv read whole, not split
        assert "wk" not in runs["two"][0]["modules"][case]["split"]


def test_operators_match_one_process(runs):
    for rank in runs["two"]:
        ops = rank["modules"]["ops"]
        _check_case(ops["mlp"], "copy/reduce",
                    {"model/all_reduce/out": 1})
        # an embedding read through vocab_rows is the whole table's read
        assert torch.equal(ops["rows"]["out"][0], ops["rows"]["ref_out"][0])
        _check_case(ops["rows"], "vocab_rows", {"model/all_reduce/embed": 1})
        # loss, ce and accuracy (ties to the lowest global id)
        ce = ops["ce"]
        _check_case(ce, "vocab CE", {"model/all_reduce/max": 2,
                                     "model/all_reduce/ce": 1})
        # 2 of the 5 unmasked tokens right: the in-block tie (ids 2, 5) and
        # the equal row go to the lowest id, the tie across the blocks
        # (ids 6, 9) to 6, not the label 9
        assert float(ce["out"][0][2]) == float(ce["ref_out"][0][2]) \
            == float(torch.tensor(0.4))


# ---------------------------------------------------------------------------
# the CLI on (1, 2) and (2, 2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_cli_model_parallel_matches_one_rank(runs, arch, mesh):
    i = list(CLI_ARCHS).index(arch)
    ranks = [r["cli"][i] for r in runs["two"]] if mesh == "1x2" else \
        [r[i] for r in runs["four"]]
    state, hist = runs["one"][arch]
    got = ranks[0]["history"]
    assert len(got) == len(hist) == STEPS
    for a, b in zip(got, hist):
        for k in ("loss", "accuracy", "tile/sp_err", "tile/pulses"):
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL,
                                       err_msg=f"{arch} {mesh} {k}")
    _leaves_close(ranks[0]["state"], state, f"{arch} {mesh}")
    data = 1 if mesh == "1x2" else 2
    layout = sh.tp_layout(get_config(arch, smoke=True),
                          make_host_mesh(data, 2))
    for r in ranks:
        stats = r["stats"]
        assert not any(k.startswith("model/all_gather/weights")
                       for k in stats), sorted(stats)
        calls = sum(v["calls"] for k, v in stats.items()
                    if k.startswith("model/all_reduce"))
        assert calls == layout.all_reduces() * STEPS, (calls, arch, mesh)
        # the split weights' gradients: one gather of their bytes a step
        assert stats["model/all_gather/grads"]["calls"] == STEPS


def test_cli_model_parallel_matches_the_jax_host_mesh(runs):
    got = runs["two"][0]["cli"][0]["history"]
    want = runs["jax"]
    assert [m["step"] for m in want] == list(range(STEPS))
    for a, b in zip(got, want):
        for k in ("loss", "tile/sp_err"):
            np.testing.assert_allclose(a[k], b[k], rtol=JAX_RTOL, err_msg=k)


@pytest.mark.parametrize("arch", FAMILIES)
def test_out_of_slice_families_on_a_model_axis(runs, arch):
    """MLA, the RG-LRU, SSD and the encoder-decoder (item 15c) split on
    (1, 2), within the CLI's standard of one process."""
    got = runs["two"][0]["lm"][arch]
    want = runs["fam"][arch]
    for a, b in zip(got["history"], want["history"]):
        for k in ("loss", "tile/sp_err"):
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL,
                                       err_msg=f"{arch} {k}")
    layout = sh.tp_layout(get_config(arch, smoke=True), make_host_mesh(1, 2))
    mixers = {"minicpm3-4b": ("/attn/wuq", "/attn/wuk", "/attn/wuv",
                              "/attn/wo"),
              "recurrentgemma-9b": ("/mix/wx", "/mix/war", "/mix/lam",
                                    "/mix/wout"),
              "mamba2-2.7b": ("/mix/wx", "/mix/a_log", "/mix/wout"),
              "seamless-m4t-large-v2": ("/cross/wq", "/cross/wo",
                                        "enc/stack/body/p0/attn/wq")}[arch]
    split = layout.split
    for name in mixers:
        assert any(p.endswith(name) for p in split), (arch, name)
    assert not any("15c" in e.why for e in layout.entries.values()), arch
    _leaves_close(got["state"], want["state"], arch)
    for r in runs["two"]:
        stats = r["lm"][arch]["stats"]
        assert not any(k.startswith("model/all_gather/weights")
                       for k in stats), sorted(stats)
        calls = sum(v["calls"] for k, v in stats.items()
                    if k.startswith("model/all_reduce"))
        assert calls == layout.all_reduces() * 2, (arch, calls)
