"""The benchmark's plain reference held to the port on the CPU.

Each configuration file freezes what the port runs (the model's sizes, the
parameter leaves, the CLI's tile plan and optimizer); the first test holds
the files to the port. The rest compare the reference's pieces with the
port's at small sizes: the random chains bit for bit, the model's loss and
gradients, the SSD scan against a sequential scan, and whole runs of the
harness's driver, whose numbers must agree with the reference's closely.
"""
from __future__ import annotations

import json
import math
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench import checks, generate, weights
from bench.drivers import train as driver
from bench.reference import follow, lm, rng

ROOT = Path(__file__).resolve().parents[1]
ZEROS = ("ln1", "ln2", "ln_f", "norm", "bq", "bk", "bv", "dt_bias")
DEVICE_KEYS = ("kind", "tau_min", "tau_max", "dw_min", "sigma_d2d",
               "sigma_pm", "sigma_c2c", "ref_mean", "ref_std")


def _init_kind(path: str) -> str:
    name = path.rsplit("/", 1)[-1]
    if name == "embed":
        return "normal"
    if name in ZEROS:
        return "zeros"
    if name == "d_skip":
        return "ones"
    if name == "a_log":
        return "a_log"
    return "trunc"


def port_config(arch: str, n_layers: int, smoke: bool = False,
                schedule_steps: int = 10000, lr: float = 0.1) -> dict:
    """The frozen sections of a configuration file, derived from the port."""
    from repro_torch.configs import get_config
    from repro_torch.core.paths import flatten_with_path
    from repro_torch.core.plan import plan_partition
    from repro_torch.core.tile import group_tiles
    from repro_torch.launch import train
    from repro_torch.models.lm import LM

    cfg = driver.cut_depth(get_config(arch, smoke=smoke), n_layers)
    model = LM(cfg)
    trainer = train.make_trainer(model, "erider", False, schedule_steps, lr)
    specs = model.abstract_params("cpu")
    leaves = flatten_with_path(specs)
    _, analog, policies = plan_partition(specs, trainer.plan)
    groups = group_tiles({p: tuple(analog[p].shape) for p in analog},
                         trainer.cfg.tile, policies)
    tile = policies[next(iter(analog))].tile
    sched, dig = trainer.cfg.schedule, trainer.cfg.digital
    kind = cfg.pattern[0]
    model_keys = {"layer": kind, "n_layers": cfg.n_layers,
                  "d_model": cfg.d_model, "vocab": cfg.vocab,
                  "norm_eps": cfg.norm_eps, "z_loss": 1e-4,
                  "tied_embeddings": cfg.tied_embeddings}
    if kind == "attn":
        model_keys.update(n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                          head_dim=cfg.head_dim, d_ff=cfg.d_ff,
                          rope_base=cfg.rope_base, qkv_bias=cfg.qkv_bias)
    else:
        model_keys.update(d_inner=cfg.d_inner, ssm_heads=cfg.ssm_heads,
                          ssm_head_dim=cfg.ssm_head_dim, d_state=cfg.d_state,
                          d_conv=cfg.d_conv, ssm_groups=cfg.ssm_groups,
                          ssm_chunk=cfg.ssm_chunk)

    def dev(d):
        return {k: getattr(d, k) for k in DEVICE_KEYS}

    return {
        "arch": arch, "smoke": smoke,
        "model": model_keys,
        "params": [{"path": p, "shape": list(t.shape),
                    "dtype": str(t.dtype).replace("torch.", ""),
                    "init": _init_kind(p)} for p, t in leaves],
        "plan": {"algorithm": "erider", "tiles": "full",
                 "schedule_steps": schedule_steps, "lr": lr},
        "tiles": {"algorithm": tile.algorithm,
                  "state_dtype": str(tile.state_dtype).replace("torch.", ""),
                  "rng": tile.rng, "pulse_mode": tile.pulse_mode,
                  "grad_norm": tile.grad_norm, "bl": tile.bl,
                  "buffered_transfer": tile.buffered_transfer,
                  "lr_p": tile.lr_p, "lr_w": tile.lr_w, "gamma": tile.gamma,
                  "eta": tile.eta, "chopper_p": tile.chopper_p,
                  "target_range": tile.target_range,
                  "min_weight_range": tile.min_weight_range,
                  "device_p": dev(tile.device_p),
                  "device_w": dev(tile.device_w),
                  "groups": [list(paths) for _, paths in groups]},
        "optimizer": {"kind": dig.kind, "momentum": dig.momentum,
                      "clip_norm": dig.clip_norm, "schedule": sched.kind,
                      "base_lr": sched.base_lr,
                      "warmup_steps": sched.warmup_steps,
                      "total_steps": sched.total_steps,
                      "min_ratio": sched.min_ratio},
    }


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [c["name"] for c in _spec()["configs"]])
def test_config_file_is_what_the_port_runs(name):
    conf = next(c for c in _spec()["configs"] if c["name"] == name)
    data = json.loads((ROOT / conf["file"]).read_text())
    want = port_config(data["arch"], data["model"]["n_layers"],
                       schedule_steps=data["plan"]["schedule_steps"],
                       lr=data["plan"]["lr"])
    for key, value in want.items():
        assert data[key] == value, key


def test_key_chain_matches_the_port():
    from repro_torch import prng
    from repro_torch.core.trainer import _crc_fold

    for seed in (0, 7, 2 ** 31 + 5, -3):
        key = rng.key_of_seed(seed)
        assert torch.equal(key, prng.PRNGKey(seed))
        assert list(weights.key_words(seed)) == key.tolist()
        assert torch.equal(rng.split(key, 4), prng.split(key, 4))
        assert torch.equal(rng.crc_fold(key, "a/b|c"), _crc_fold(key, "a/b|c"))
        for k in rng.split(key, 40):
            assert rng.bernoulli(k, 0.05) == bool(prng.bernoulli(k, 0.05))


def test_hash_chains_match_the_port():
    from repro_torch.core.device import DeviceConfig, sample_device
    from repro_torch.kernels import fastrng

    seed = rng.split(rng.key_of_seed(11), 2)[1]
    shape = (3, 5, 7)
    n = math.prod(shape)
    assert torch.equal(rng.hash_bits(seed, 0, n, 1, "cpu"),
                       fastrng.hash_bits(seed, shape, 1, "cpu").reshape(-1))
    want = fastrng.hash_normal_ref(seed, shape, 2, "cpu").reshape(-1)
    got = torch.cat([rng.hash_normal(seed, s, c, 2, "cpu")
                     for s, c in rng.pieces(n, 17)])
    assert torch.equal(got, want)
    for d in (dict(sigma_d2d=0.1, sigma_pm=0.3, ref_mean=0.1, ref_std=0.1),
              dict(sigma_d2d=0.1, sigma_pm=0.3, ref_mean=0.0, ref_std=0.0)):
        cfg = DeviceConfig(kind="softbounds", dw_min=1e-4, sigma_c2c=0.05, **d)
        port = sample_device(seed, shape, cfg, method="hash", device="cpu")
        gam, rho = rng.device_params(
            seed, 0, n, "cpu", {k: getattr(cfg, k) for k in DEVICE_KEYS})
        assert torch.equal(gam, port["gamma"].reshape(-1))
        assert torch.equal(rho, port["rho"].reshape(-1))


def test_pulse_update_matches_the_port():
    from repro_torch.kernels import ops

    dev = {"tau_min": 1.0, "tau_max": 1.0, "dw_min": 1e-3, "sigma_d2d": 0.1,
           "sigma_pm": 0.3, "sigma_c2c": 0.05, "ref_mean": 0.0,
           "ref_std": 0.0}
    g = torch.Generator().manual_seed(0)
    w = (0.3 * torch.randn(4, 33, generator=g)).to(torch.bfloat16)
    dw = 3e-3 * torch.randn(4, 33, generator=g)
    sd, sn = rng.split(rng.key_of_seed(3), 2)
    gam, rho = rng.device_params(sd, 0, w.numel(), "cpu", dev)
    want = ops.analog_update(w, dw, gam.reshape(w.shape), rho.reshape(w.shape),
                             sn, dw_min=1e-3, tau_min=1.0, tau_max=1.0,
                             sigma_c2c=0.05, rng="hash")
    got = w.clone().reshape(-1)
    follow.analog_update(got, dw.reshape(-1), gam, rho, sn, dev,
                         torch.bfloat16, "cpu")
    assert torch.equal(got, want.reshape(-1))


def _ssd_scan(X, A, B, C):
    """The SSD recurrence token by token: h = exp(A) h + B x, y = C h."""
    b, s, h, p = X.shape
    state = torch.zeros(b, h, p, B.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(s):
        state = (torch.exp(A[:, t])[..., None, None] * state
                 + X[:, t, :, :, None] * B[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t]))
    return torch.stack(ys, 1)


def test_ssd_reference_is_the_recurrence():
    g = torch.Generator().manual_seed(1)
    b, s, h, p, n = 2, 24, 3, 4, 5
    X = torch.randn(b, s, h, p, generator=g, dtype=torch.float64)
    A = -torch.rand(b, s, h, generator=g, dtype=torch.float64)
    B = torch.randn(b, s, h, n, generator=g, dtype=torch.float64)
    C = torch.randn(b, s, h, n, generator=g, dtype=torch.float64)
    model = lm.Model({"model": {}})
    got = model.ssd(X, A, B, C, 8)
    torch.testing.assert_close(got, _ssd_scan(X, A, B, C), rtol=1e-10,
                               atol=1e-10)


SMOKE = [("qwen2-0.5b", 2), ("mamba2-2.7b", 3)]
MIX = {"kind": "train", "batch": 2, "seq": 32, "ids": "uniform",
       "trace_steps": 2}


@pytest.mark.parametrize("arch,layers", SMOKE)
def test_model_loss_and_grads_match_the_port(arch, layers):
    from repro_torch.models.lm import LM

    cfg = port_config(arch, layers, smoke=True)
    port = LM(driver.cut_depth(__import__(
        "repro_torch.configs", fromlist=["get_config"]).get_config(
            arch, smoke=True), layers))
    params = weights.make(cfg, 5, "cpu")
    # the norm weights and biases start at 0: move them so they matter
    g = torch.Generator().manual_seed(2)
    params = {p: (t + 0.1 * torch.randn(t.shape, generator=g).to(t.dtype)
                  if _init_kind(p) in ("zeros", "ones") else t)
              for p, t in params.items()}
    batch = generate.train_batch(MIX, cfg["model"]["vocab"], 5, 0)
    tokens = torch.from_numpy(batch["tokens"])
    labels = torch.from_numpy(batch["labels"])
    loss, grads = lm.loss_and_grads(cfg, params, tokens, labels)
    leaves = {p: t.detach().clone().requires_grad_(True)
              for p, t in params.items()}
    want, _ = port.loss(weights.nest(leaves), {"tokens": tokens,
                                               "labels": labels}, None)
    want.backward()
    assert loss == pytest.approx(float(want.detach()), rel=1e-5)
    for p, t in leaves.items():
        torch.testing.assert_close(grads[p], t.grad.float(), rtol=2e-4,
                                   atol=2e-6 * float(t.grad.abs().max()))


def smoke_context(arch, layers, seed, cell=None):
    config = port_config(arch, layers, smoke=True)
    cell = cell or {"name": "qwen2-0.5b.train.b16s1024", "chips": 1}
    return SimpleNamespace(cell=cell, config=config, config_name=arch,
                           mix=MIX, seed=seed, seconds=0.2, trace=False,
                           device="cpu", t0=time.perf_counter())


@pytest.mark.parametrize("arch,layers", SMOKE)
def test_driver_run_agrees_with_the_reference(arch, layers):
    torch.manual_seed(0)
    res = driver.run(smoke_context(arch, layers, 2 ** 31 + 17))
    v = res["values"]
    assert v["loss_gap"] < 1e-4, v
    assert v["first_gap"] < 1e-2, v
    assert v["change_gap"] < 1e-2, v
    assert res["attempted"] >= 1
    assert np.isfinite(res["e2e"]["train_tokens_per_s"])


def test_gaps_measure_the_worst_leaf():
    ref = {"loss": [2.0, 2.0], "grad": {"a": 1.0, "b": 1.0, "c": 1e-9},
           "first": {"a": 1.0, "b": 3.0, "c": 0.0},
           "change": {"a": 1.0, "b": 0.1, "c": 0.0}}
    prog = {"loss": [2.0, 2.02], "first": {"a": 1.0, "b": 3.3, "c": 5.0},
            "change": {"a": 1.0, "b": 0.3, "c": 9.0}}
    v = checks.gaps(prog, ref, analog={"b"})
    assert v["loss_gap"] == pytest.approx(0.01)
    # c is left out (its gradient is under a thousandth of the median);
    # b is the only analog leaf, measured against its own norm
    assert v["first_gap"] == pytest.approx(0.1)
    assert v["change_gap"] == pytest.approx(2.0)


@pytest.mark.parametrize("part,key,value", [
    ("tiles", "algorithm", "rider"), ("tiles", "rng", "threefry"),
    ("tiles", "pulse_mode", "stochastic"), ("tiles", "grad_norm", "max"),
    ("tiles", "bl", 31), ("tiles", "buffered_transfer", True),
    ("optimizer", "kind", "adam"), ("optimizer", "schedule", "constant")])
def test_reference_refuses_what_it_does_not_implement(part, key, value):
    conf = next(c for c in _spec()["configs"] if c["name"] == "qwen2-0.5b")
    data = json.loads((ROOT / conf["file"]).read_text())
    follow.check_implemented(data)
    data[part] = dict(data[part], **{key: value})
    with pytest.raises(ValueError, match=f"{part}.{key} = "):
        follow.check_implemented(data)
    with pytest.raises(ValueError, match=f"{part}.{key} = "):
        follow.follow(data, MIX, 1, "cpu")
