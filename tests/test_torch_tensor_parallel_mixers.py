"""The model axis for MLA, RG-LRU, Mamba-2 SSD, cross-attention and the
encoder-decoder (``--model-parallel``): the port against one process and
against the JAX package's host mesh.

* ``distributed.sharding.tp_layout`` on the ten archs' full configs at a
  model axis of 2 and 4: no entry left replicated for a later slice, each
  replicated entry with a divisibility reason or the reference's; the
  model-group all-reduces a step of each family counted by hand.
* One layer of each mixer on two gloo ranks of a (1, 2) mesh
  (``torch_ranks.tp_mixers``), float32 at smoke size: MLA expanded and
  absorbed, the RG-LRU, SSD at one group (``wb``/``wc`` read whole) and at
  two (split), both over a padded tail, the gated norm alone (over split
  channels, then a row-split product), cross-attention with KV heads that
  divide and that do not. Output and input gradients within
  ``MIXER_RTOL`` of one process (the largest difference over the tensor's
  largest magnitude; a row split sums two halves, the norm two sums of
  squares), each parameter's gradient block equal to the same block of one
  process's gradient within it, and the module's model-group all-reduces
  forward and backward counted by name. The encoder-decoder's whole loss
  with frames (``LM.loss``): loss and every gradient block within
  ``MIXER_RTOL``, ``tp_layout.all_reduces()`` all-reduces.
* The CLI with ``--model-parallel 2`` (two ranks) and ``--data-parallel 2
  --model-parallel 2`` (four ranks) on the smoke minicpm3-4b,
  deepseek-v2-236b, recurrentgemma-9b and mamba2-2.7b against one rank,
  and the CLI's trainer (``lm_steps``) on MLA absorbed, SSD at two groups
  and the encoder-decoder with frames against one process: loss,
  accuracy, sp_err and pulses within ``LOSS_RTOL`` at each step, every
  float leaf within 1e-5 but for at most 0.1 % of its elements (a
  stochastic-rounding pulse flipped by a last-bit difference in a
  gradient), ``tp_layout.all_reduces()`` model-group all-reduces a step,
  no model-group all-gather of a split weight in the forward
  (``model/all_gather/weights``; SSD's ``wb``/``wc`` at one group, stored
  split and read whole, gather as ``model/all_gather/whole``).
* The (1, 2) CLI runs of minicpm3-4b, recurrentgemma-9b and mamba2-2.7b
  against the JAX CLI on a (1, 2) mesh of two forced host devices: the
  learning rate equal, loss and sp_err within ``JAX_RTOL``, at step 0
  (the forward, the backward and one update over the model axis). The JAX
  CLI compiles its step again at step 1 (~170 CPU-seconds a run for two
  steps, ~100 for one), so it runs one step; the one-rank comparisons
  above hold the second.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

MIXER_RTOL = 1e-5        # measured: <= 3.4e-6 (SSD at one group)
LOSS_RTOL = 1e-6         # measured: <= 1.2e-7
JAX_RTOL = 2e-6          # measured: <= 1.2e-7
STEPS = 2
JAX_STEPS = 1
ARGV = ["--smoke", "--steps", str(STEPS), "--batch", "4", "--device", "cpu",
        "--log-every", "1", "--ckpt-every", "100"]
# deepseek at 128 tokens: MoE groups of 64 within each data rank's rows;
# mamba2 at 24: a tail of 8 past its 16-token chunk
CLI_ARCHS = {"minicpm3-4b": 16, "deepseek-v2-236b": 32,
             "recurrentgemma-9b": 16, "mamba2-2.7b": 24}
JAX_ARCHS = ("minicpm3-4b", "recurrentgemma-9b", "mamba2-2.7b")
VARIANTS = {"minicpm3-4b-absorbed": ("minicpm3-4b", {"mla_absorbed": True}),
            "mamba2-2.7b-g2": ("mamba2-2.7b", {"ssm_groups": 2}),
            "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {})}
LM_SEQ = 24
# each case's model-group all-reduces, forward and backward, by label
MIXER_CALLS = {
    # the output's sum; the gradients of ql, ckv and k_pe
    "mla_expanded": {"out": 1, "grad": 3},
    "mla_absorbed": {"out": 1, "grad": 3},
    # the output's sum; the input's gradient
    "rglru": {"out": 1, "grad": 1},
    # the output's and the norm's sums; the norm's sum's gradient; the
    # gradients of the input, the norm's weight and, at one group, wb, wc,
    # conv_b and conv_c read whole
    "ssd_g1": {"out": 1, "norm": 1, "norm/grad": 1, "grad": 6},
    "ssd_g2": {"out": 1, "norm": 1, "norm/grad": 1, "grad": 2},
    # the output's sum; the gradients of x and enc_out (and of wk, wv read
    # whole when one KV head serves both ranks)
    "cross_kv_split": {"out": 1, "grad": 2},
    "cross_kv_whole": {"out": 1, "grad": 4},
    "gated_norm": {"out": 1, "norm": 1, "norm/grad": 1, "grad": 1},
}


def _argv(arch, data=1, model=1):
    return ARGV + ["--arch", arch, "--seq", str(CLI_ARCHS[arch]),
                   "--data-parallel", str(data), "--model-parallel", str(model)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything at once: the JAX CLI runs (one process each), the (1, 2)
    programs on two ranks, the (2, 2) ones on four, and the one-process
    runs in this process."""
    work = tmp_path_factory.mktemp("tp_mixers")
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(HERE), "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    jax = {}
    for arch in JAX_ARCHS:
        out = str(work / f"jax_{arch}.json")
        jax[arch] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro.launch.train", "--arch", arch,
             "--smoke", "--steps", str(JAX_STEPS), "--batch", "4", "--seq",
             str(CLI_ARCHS[arch]), "--log-every", "1", "--model-parallel",
             "2", "--metrics-out", out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    kw = dict(variants=VARIANTS, batch=4, seq=LM_SEQ, steps=STEPS)
    two = torch_ranks.start("tp_mixers_all", 2, str(work), timeout=400,
                            data=1, model=2,
                            argvs=[_argv(a, 1, 2) for a in CLI_ARCHS], **kw)
    four = torch_ranks.start("tp_mixers_all", 4, str(work), timeout=400,
                             data=2, model=2,
                             argvs=[_argv(a, 2, 2) for a in CLI_ARCHS], **kw)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # as the ranks run
    try:
        one = {a: train.main(_argv(a)) for a in CLI_ARCHS}
        lm = {n: torch_ranks.lm_steps(None, "cpu", a, 4, LM_SEQ, STEPS, change)
              for n, (a, change) in VARIANTS.items()}
    finally:
        torch.set_num_threads(threads)
    res2, res4 = two.wait(), four.wait()
    jhist = {}
    for arch, (out, proc) in jax.items():
        try:
            _, err = proc.communicate(timeout=400)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, err[-3000:]
        with open(out) as f:
            jhist[arch] = json.load(f)
    return dict(two=res2, four=res4, one=one, lm=lm, jax=jhist)


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


def _history_close(got, want, label):
    assert len(got) == len(want) == STEPS, label
    for a, b in zip(got, want):
        for k in ("loss", "accuracy", "tile/sp_err", "tile/pulses"):
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL,
                                       err_msg=f"{label} {k}")


def _model_stats_hold(stats, layout, label):
    """``layout.all_reduces()`` model-group all-reduces a step and no
    model-group all-gather of a split weight in the forward."""
    assert not any(k.startswith("model/all_gather/weights")
                   for k in stats), (label, sorted(stats))
    calls = sum(v["calls"] for k, v in stats.items()
                if k.startswith("model/all_reduce"))
    assert calls == layout.all_reduces() * STEPS, (label, calls)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tp_layout_leaves_no_mixer_for_a_later_slice(arch):
    cfg = get_config(arch)
    for m in (2, 4):
        layout = sh.tp_layout(cfg, make_host_mesh(1, m))
        for p, e in layout.entries.items():
            assert "15c" not in e.why, (arch, m, p)
            if e.dim is None:
                assert ("divide" in e.why or e.why in (
                    "a latent projection, whole on every rank",
                    "one weight over every head",
                    "one weight over all of d_inner: each rank reads its "
                    "slice", "not split over the model axis")), (arch, m, p,
                                                                 e.why)


def test_tp_layout_counts_the_mixers_all_reduces():
    """By hand, at a model axis of 2 (every body period recomputed)."""
    mesh = make_host_mesh(1, 2)
    # MiniCPM3-4B: 62 x (MLA: out + recompute + ql, ckv, k_pe; MLP: out +
    # recompute + x) + the vocabulary's 5
    assert sh.tp_layout(get_config("minicpm3-4b"), mesh).all_reduces() \
        == 62 * (5 + 3) + 5
    # Mamba2-2.7B: 64 x (out + recompute + x; the norm's sum + recompute +
    # its gradient + the weight's; wb, wc, conv_b, conv_c whole) + 5
    assert sh.tp_layout(get_config("mamba2-2.7b"), mesh).all_reduces() \
        == 64 * (3 + 4 + 4) + 5
    # RecurrentGemma-9B: 12 periods of (rec, rec, attn_local with one KV
    # head: wk and wv whole) and their MLPs; the tail's two rec layers and
    # MLPs run outside the recompute
    assert sh.tp_layout(get_config("recurrentgemma-9b"), mesh).all_reduces() \
        == 12 * (3 + 3 + 5 + 3 * 3) + 2 * (2 + 2) + 5
    # SeamlessM4T: the encoder's 24 (attention, MLP) and the decoder's 24
    # (attention, cross-attention + enc_out's gradient, MLP)
    assert sh.tp_layout(get_config("seamless-m4t-large-v2"),
                        mesh).all_reduces() == 24 * 2 * 3 + 24 * 10 + 5


# ---------------------------------------------------------------------------
# each mixer on (1, 2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(MIXER_CALLS))
def test_mixer_matches_one_process(runs, case):
    for rank in runs["two"]:
        res = rank["modules"][case]
        for a, b in zip(res["out"], res["ref_out"]):
            _close(a, b, MIXER_RTOL, f"{case} out")
        for a, b in zip(res["dx"], res["ref_dx"]):
            _close(a, b, MIXER_RTOL, f"{case} dx")
        for n, g in res["grads"].items():
            want = res["ref_grads"][n]
            assert (g is None) == (want is None), (case, n)
            if want is not None:
                _close(g, want, MIXER_RTOL, f"{case} d{n}")
        want = {f"model/all_reduce/{k}": v for k, v in MIXER_CALLS[case].items()}
        assert res["calls_all"] == want, (case, res["calls_all"])
    split = set(runs["two"][0]["modules"][case].get("split", ()))
    if case.startswith("ssd"):
        # B and C split with the groups, read whole at one group
        assert {"wx", "wz", "wdt", "a_log", "wout"} <= split
        assert ("wb" in split) == (case == "ssd_g2")
    elif case == "cross_kv_whole":
        assert split == {"wq", "wo"}
    elif case != "gated_norm":
        assert "wo" in split or "wout" in split


def test_encdec_loss_and_gradients_on_a_model_axis(runs):
    for rank in runs["two"]:
        res = rank["modules"]["encdec"]
        _close(res["out"][0], res["ref_out"][0], MIXER_RTOL, "encdec loss")
        _close(res["dx"][0], res["ref_dx"][0], MIXER_RTOL, "encdec dframes")
        for n, g in res["grads"].items():
            _close(g, res["ref_grads"][n], MIXER_RTOL, f"encdec d{n}")
        assert sum(res["calls_all"].values()) == res["all_reduces"]
    layout = sh.tp_layout(get_config("seamless-m4t-large-v2", smoke=True),
                          make_host_mesh(1, 2))
    for part in ("enc/stack/body/p0/attn", "stack/body/p0/attn",
                 "stack/body/p0/cross"):
        assert layout.dim(f"{part}/wq") == -1 and layout.dim(
            f"{part}/wo") == -2, part


# ---------------------------------------------------------------------------
# the CLI and the CLI's trainer on (1, 2) and (2, 2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_cli_mixers_match_one_rank(runs, arch, mesh):
    i = list(CLI_ARCHS).index(arch)
    ranks = [r["cli"][i] for r in runs["two" if mesh == "1x2" else "four"]]
    state, hist = runs["one"][arch]
    _history_close(ranks[0]["history"], hist, f"{arch} {mesh}")
    _leaves_close(ranks[0]["state"], state, f"{arch} {mesh}")
    data = 1 if mesh == "1x2" else 2
    layout = sh.tp_layout(get_config(arch, smoke=True),
                          make_host_mesh(data, 2))
    for r in ranks:
        _model_stats_hold(r["stats"], layout, f"{arch} {mesh}")
        assert r["stats"]["model/all_gather/grads"]["calls"] == STEPS
    if arch == "mamba2-2.7b":
        # one group: B and C stored split, read whole
        assert "model/all_gather/whole" in ranks[0]["stats"]


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("name", VARIANTS)
def test_lm_variants_match_one_process(runs, name, mesh):
    got = runs["two" if mesh == "1x2" else "four"]
    want = runs["lm"][name]
    _history_close(got[0]["lm"][name]["history"], want["history"],
                   f"{name} {mesh}")
    _leaves_close(got[0]["lm"][name]["state"], want["state"],
                  f"{name} {mesh}")
    arch, change = VARIANTS[name]
    cfg = dataclasses.replace(get_config(arch, smoke=True), **change)
    layout = sh.tp_layout(cfg, make_host_mesh(1 if mesh == "1x2" else 2, 2))
    for r in got:
        _model_stats_hold(r["lm"][name]["stats"], layout, f"{name} {mesh}")


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_cli_mixers_match_the_jax_host_mesh(runs, arch):
    got = runs["two"][0]["cli"][list(CLI_ARCHS).index(arch)]["history"]
    want = runs["jax"][arch]
    assert [m["step"] for m in want] == list(range(JAX_STEPS))
    for a, b in zip(got, want):
        # step 0's learning rate is the base rate at either run length
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-7)
        for k in ("loss", "tile/sp_err"):
            np.testing.assert_allclose(a[k], b[k], rtol=JAX_RTOL,
                                       err_msg=f"{arch} {k}")
