"""The reference's first training steps, from the benchmark's inputs alone.

``follow(config, mix, seed, device)`` makes the weights and the key of the
seed again (``bench.weights``), the first batches (``bench.traffic``), and
runs ``steps`` steps of the training the configuration states: E-RIDER
(paper Alg. 3) on every analog leaf, SGD with momentum and global-norm
clipping under a warm-up cosine schedule on the digital ones.

An analog leaf w0 is one tile: scale = max(max|w0|, min_weight_range) /
(target_range * tau), W = w0 / scale, P = Q = Q~ = 0 in the state dtype,
chopper c = 1, and device seeds (kp, kw) = split(fold_in(key, crc(path)),
3)[:2]. A step splits the state key into (next, begin, model, update);
each tile's begin and update keys are split from the key with the CRC of
its group's paths folded in, one a member. Then, per step:
  begin    c flips with probability chopper_p; on a flip Q~ <- Q;
  forward  the tile's weight scale * (W + gamma_mix c (P - Q~));
  P        <- pulse update of -alpha c g * scale (alpha = lr * lr_p);
  W        <- pulse update of beta c (P - Q~) (beta = lr * lr_w);
  Q        <- (1 - eta) Q + eta P;
the pulse update (paper eq. 2) with the device's soft bounds, stochastic
rounding and cycle-to-cycle noise (``analog_update``).

It returns the numbers the benchmark compares (``bench.checks``): each
step's loss, each leaf's norm of what its optimizer holds after step 1
(the digital momentum; a tile's P, its first gradient in pulses), each
leaf's norm of the change after the last step (digital: the parameter; a
tile: its P, W, Q and Q~ together), and each leaf's gradient norm at step
1, which picks the leaves that are compared.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .. import generate, weights
from . import lm, rng

F32 = torch.float32
STATE_DTYPES = {"bfloat16": torch.bfloat16,
                "float8_e4m3fn": torch.float8_e4m3fn}


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().to(F32),
                                          dtype=torch.float64))


def lr_at(step: int, opt: Dict) -> torch.Tensor:
    """The warm-up cosine schedule, in float32."""
    s = torch.tensor(float(step), dtype=F32)
    base = torch.tensor(opt["base_lr"], dtype=F32)
    w = opt["warmup_steps"]
    warm = torch.clamp_max(rng.div(s + 1.0, w), 1.0) if w > 0 else 1.0
    span = max(opt["total_steps"] - w, 1)
    frac = torch.clamp(rng.div(s - w, span), 0.0, 1.0)
    r = opt["min_ratio"]
    decay = r + (1 - r) * 0.5 * (1 + torch.cos(math.pi * frac))
    return base * warm * decay


def device_params(seed, n: int, dev: Dict, device):
    """The flat float32 (gamma, rho) of a tile of ``n`` elements."""
    parts = [rng.device_params(seed, start, count, device, dev)
             for start, count in rng.pieces(n)]
    return (torch.cat([g for g, _ in parts]), torch.cat([r for _, r in parts]))


def analog_update(w, dw, gamma, rho, seed_noise, dev: Dict, dtype, device):
    """Paper eq. 2 on the flat tile ``w`` in place, piece by piece: pulses
    n = stochastic_round(dw / dw_min) (hash bits, salt 1), delta = n
    dw_min, w + delta F(w) - |delta| G(w) + dw_min sigma_c2c sqrt|n| q(w)
    zeta (hash normals, salt 2), clipped to [-tau_min, tau_max], for the
    device's flat ``gamma`` and ``rho``."""
    dw_min, tmin, tmax = dev["dw_min"], dev["tau_min"], dev["tau_max"]
    sigma = dev["sigma_c2c"]
    for start, count in rng.pieces(w.numel()):
        sl = slice(start, start + count)
        gam, rh = gamma[sl], rho[sl]
        ubits = rng.hash_bits(seed_noise, start, count, 1, device)
        zeta = rng.hash_normal(seed_noise, start, count, 2, device)
        wf, dwf = w[sl].to(F32), dw[sl].to(F32)
        n_real = rng.div(dwf, dw_min)
        n_floor = torch.floor(n_real)
        u = ubits.to(F32) * (1.0 / 4294967296.0)
        n_q = n_floor + (u < n_real - n_floor).to(F32)
        delta = n_q * dw_min
        qp = (gam + rh) * (1.0 - rng.div(wf, tmax))
        qm = (gam - rh) * (1.0 + rng.div(wf, tmin))
        f, g = (qm + qp) * 0.5, (qm - qp) * 0.5
        upd = delta * f - torch.abs(delta) * g
        q_dir = torch.where(delta >= 0.0, qp, qm)
        noise = dw_min * sigma * torch.sqrt(torch.abs(n_q)) * q_dir * zeta
        w[sl] = torch.clamp(wf + upd + noise, -tmin, tmax).to(dtype)


class Tile:
    """One analog leaf under E-RIDER, its arrays flat in the state dtype."""

    def __init__(self, path: str, w0: torch.Tensor, key, tcfg: Dict, dtype):
        self.path, self.shape, self.dtype = path, tuple(w0.shape), dtype
        self.cfg = tcfg
        kp, kw, _ = rng.split(rng.crc_fold(key, path), 3)
        dw_ = tcfg["device_w"]
        tau = min(dw_["tau_min"], dw_["tau_max"])
        max_abs = torch.clamp_min(torch.max(torch.abs(w0.to(F32))),
                                  tcfg["min_weight_range"])
        self.scale = rng.div(max_abs, tcfg["target_range"] * tau)
        self.W = (w0.to(F32) / self.scale).to(dtype).reshape(-1)
        self.W0 = self.W.clone()
        self.P = torch.zeros_like(self.W)
        self.Qd = torch.zeros_like(self.W)
        self.Qt = torch.zeros_like(self.W)
        self.c = torch.ones((), dtype=F32, device=w0.device)
        # the device parameters are drawn from the tile's seeds at each
        # update, as the program draws them, and not held between steps
        self.kp, self.kw = kp, kw

    def begin(self, key) -> None:
        if rng.bernoulli(key, self.cfg["chopper_p"]):
            self.c = -self.c
            self.Qt = self.Qd.clone()

    def weight(self) -> torch.Tensor:
        pq = (self.P.to(F32) - self.Qt.to(F32)).to(self.dtype).to(F32)
        eff = self.W.to(F32) + self.cfg["gamma"] * self.c * pq
        return (eff * self.scale).to(self.dtype).reshape(self.shape)

    def update(self, grad, key, lr) -> None:
        t = self.cfg
        device = self.W.device
        g = grad.to(F32).reshape(-1) * self.scale
        kp, kw, _ = rng.split(key, 3)
        alpha, beta = lr * t["lr_p"], lr * t["lr_w"]
        c = self.c
        dp = -alpha.to(device) * c * g
        del g
        n = self.W.numel()
        analog_update(self.P, dp, *device_params(self.kp, n, t["device_p"],
                                                 device),
                      kp, t["device_p"], self.dtype, device)
        del dp
        p_new = self.P.to(F32)
        dw = beta.to(device) * c * (p_new - self.Qt.to(F32))
        analog_update(self.W, dw, *device_params(self.kw, n, t["device_w"],
                                                 device),
                      kw, t["device_w"], self.dtype, device)
        del dw
        eta = t["eta"]
        self.Qd = ((1.0 - eta) * self.Qd.to(F32) + eta * p_new).to(self.dtype)

    def change(self) -> float:
        return math.sqrt(sum(norm(a) ** 2 for a in (
            self.P, self.W.to(F32) - self.W0.to(F32), self.Qd, self.Qt)))


# what the reference implements, of the keys a configuration's ``tiles``
# and ``optimizer`` state; any other value is refused by name
IMPLEMENTED = {
    "tiles": {"algorithm": "erider", "rng": "hash", "pulse_mode": "fused",
              "grad_norm": "none", "bl": 0, "buffered_transfer": False},
    "optimizer": {"kind": "sgdm", "schedule": "cosine"},
}


def check_implemented(cfg: Dict) -> None:
    """Raise on a configuration whose training the reference does not
    implement, naming the key and its value."""
    for part, want in IMPLEMENTED.items():
        for k, v in want.items():
            got = cfg[part].get(k)
            if got != v or type(got) is not type(v):
                raise ValueError(f"the reference implements {part}.{k} = "
                                 f"{v!r}, not {got!r}")
    for d in ("device_p", "device_w"):
        kind = cfg["tiles"][d]["kind"]
        if kind != "softbounds":
            raise ValueError(f"the reference implements tiles.{d}.kind = "
                             f"'softbounds', not {kind!r}")


def follow(cfg: Dict, mix: Dict, seed: int, device, precision: str = "f32",
           steps: int = 2, rows: Optional[int] = None) -> Dict:
    """The reference's numbers of the first ``steps`` steps (see the module
    docstring). ``precision="fp8"`` is the control: matrix products in
    float8 e4m3 and the tile state in float8 e4m3. ``rows`` (a fault's
    reading) trains on the first ``rows`` rows of each batch only."""
    check_implemented(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tcfg, opt = cfg["tiles"], cfg["optimizer"]
    dtype = STATE_DTYPES["float8_e4m3fn" if precision == "fp8"
                         else tcfg["state_dtype"]]
    key = rng.key_of_seed(seed)
    params = weights.make(cfg, seed, device)
    groups: List[List[str]] = tcfg["groups"]
    analog = [p for g in groups for p in g]
    tiles = {p: Tile(p, params.pop(p), key, tcfg, dtype) for p in analog}
    digital = params
    p0 = {p: t.clone() for p, t in digital.items()}
    mu = {p: torch.zeros_like(t, dtype=F32) for p, t in digital.items()}
    out = {"loss": [], "first": {}, "change": {}, "grad": {}}
    state_key = key
    vocab = cfg["model"]["vocab"]
    for step in range(steps):
        nxt, k_begin, _, k_upd = rng.split(state_key, 4)
        for g in groups:
            keys = rng.split(rng.crc_fold(k_begin, "|".join(g)), len(g))
            for i, p in enumerate(g):
                tiles[p].begin(keys[i])
        batch = generate.train_batch(mix, vocab, seed, step)
        eff = {**digital, **{p: t.weight() for p, t in tiles.items()}}
        loss, grads = lm.loss_and_grads(
            cfg, eff, torch.from_numpy(batch["tokens"][:rows]).to(device),
            torch.from_numpy(batch["labels"][:rows]).to(device), precision)
        del eff
        out["loss"].append(loss)
        if step == 0:
            out["grad"] = {p: norm(g) for p, g in grads.items()}
        lr = lr_at(step, opt)
        # digital: SGD with momentum on the globally clipped gradient
        gnorm = torch.sqrt(sum((torch.sum(torch.square(grads[p].to(F32)))
                                for p in digital),
                               torch.zeros((), dtype=F32, device=device)))
        clip = torch.clamp_max(
            torch.full_like(gnorm, opt["clip_norm"]) / (gnorm + 1e-12), 1.0)
        for p, t in digital.items():
            mu[p] = opt["momentum"] * mu[p] + (grads[p] * clip).to(F32)
            digital[p] = (t.to(F32) - lr.to(device) * mu[p]).to(t.dtype)
        for g in groups:
            keys = rng.split(rng.crc_fold(k_upd, "|".join(g)), len(g))
            for i, p in enumerate(g):
                tiles[p].update(grads.pop(p), keys[i], lr)
        del grads
        if step == 0:
            out["first"] = {**{p: norm(m) for p, m in mu.items()},
                            **{p: norm(t.P) for p, t in tiles.items()}}
        state_key = nxt
    out["change"] = {**{p: norm(t.to(F32) - p0[p].to(F32))
                        for p, t in digital.items()},
                     **{p: t.change() for p, t in tiles.items()}}
    return out
