"""Zero-shifting SP estimation (paper Algorithm 1) — stochastic and cyclic.

Port of the JAX package's ``core/zs.py``: the *static* calibration baseline
whose pulse complexity the paper bounds (Thm 2.2: avg ||G||^2 <=
O(1/(N dw_min)) + Theta(dw_min); Thm C.2: last-iterate
N <= log(.)/(2 mu_q dw_min) for monotone devices). The reference's
``lax.scan`` over pulses is a Python loop here, with the same key chain:
``split(k, 3)`` per pulse and ``bernoulli(ke, 0.5, w.shape)`` for the
stochastic sign.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import prng
from ..kernels import ref as kref
from .device import DeviceConfig, DeviceParams, fg, symmetric_point
from .pulse import zs_step


def _sign(scheme: str, n: int, ke, w: torch.Tensor) -> torch.Tensor:
    """+-1 per element: a fair coin from ``ke`` (stochastic) or the pulse
    parity (cyclic, paper eq. 31)."""
    if scheme == "stochastic":
        up = prng.bernoulli(ke, 0.5, w.shape, w.device)
        return torch.where(up, 1.0, -1.0)
    return (1.0 if n % 2 == 0 else -1.0) * torch.ones_like(w)


def zs_estimate(key, w0, dp: DeviceParams, cfg: DeviceConfig, n_pulses: int,
                *, scheme: str = "stochastic",
                tail_average: Optional[bool] = None) -> torch.Tensor:
    """Run Algorithm 1 for ``n_pulses`` pulses and return the SP estimate.

    scheme: 'stochastic' draws eps ~ U{-dw_min, +dw_min} i.i.d. per element;
            'cyclic' alternates +dw_min, -dw_min (paper eq. 31).

    tail_average: return the average of the last half of the iterates instead
    of W_N. Defaults to True for the stochastic scheme (Thm 2.2 bounds the
    *average* iterate; the stochastic last iterate keeps a Theta(dw_min)
    jitter floor) and False for the cyclic one, whose +/- pairs cancel.
    """
    if scheme not in ("stochastic", "cyclic"):
        raise ValueError(scheme)
    if tail_average is None:
        tail_average = scheme == "stochastic"
    tail_start = n_pulses // 2 if tail_average else max(n_pulses - 1, 0)
    tail_len = max(n_pulses - tail_start, 1)

    w, k = w0, key
    acc = torch.zeros_like(w0, dtype=torch.float32)
    for n in range(n_pulses):
        k, ke, kc = prng.split(k, 3)
        w = zs_step(w, _sign(scheme, n, ke, w) * cfg.dw_min, dp, cfg, kc)
        if n >= tail_start:
            acc = acc + w.to(torch.float32)
    if n_pulses == 0:
        return w
    return kref.div(acc, float(tail_len)).to(w.dtype)


def zs_estimate_with_trace(key, w0, dp: DeviceParams, cfg: DeviceConfig,
                           n_pulses: int, *, scheme: str = "stochastic"
                           ) -> Tuple[torch.Tensor, dict]:
    """As ``zs_estimate`` but also returns per-pulse traces of
    mean ||G(W_n)||^2 (``g_sq``) and mean (W_n - w_sp)^2 (``sp_err_sq``).
    (The reference's unused ``every`` argument is not carried over.)"""
    w_sp = symmetric_point(dp, cfg)
    w, k = w0, key
    g_sq, err_sq = [], []
    for n in range(n_pulses):
        k, ke, kc = prng.split(k, 3)
        w = zs_step(w, _sign(scheme, n, ke, w) * cfg.dw_min, dp, cfg, kc)
        _, g = fg(w, dp, cfg)
        g_sq.append(torch.mean(g * g))
        err_sq.append(torch.mean((w - w_sp) ** 2))
    if not g_sq:
        empty = torch.zeros(0, device=w.device)
        return w, {"g_sq": empty, "sp_err_sq": empty}
    return w, {"g_sq": torch.stack(g_sq), "sp_err_sq": torch.stack(err_sq)}


def pulses_to_target(g_sq_trace, target: float) -> int:
    """Smallest N with running-average ||G||^2 <= target (-1 if never).
    Host-side post-processing of a finished trace (its own numpy import
    says so)."""
    import numpy as np

    if torch.is_tensor(g_sq_trace):
        g_sq_trace = g_sq_trace.detach().cpu().numpy()
    g = np.asarray(g_sq_trace)
    avg = np.cumsum(g) / (np.arange(len(g)) + 1)
    hits = np.nonzero(avg <= target)[0]
    return int(hits[0]) + 1 if len(hits) else -1
