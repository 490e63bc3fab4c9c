"""Plain loss and gradients of the benchmark's language models.

Written from the published layer equations, in float32 (TF32 off), over a
flat {path: tensor} of parameters in the port's layout (the configuration
file's ``params``; stacked layers lead with the layer axis):

  attn (Qwen2, arXiv:2407.10671): pre-norm RMSNorm with a (1 + w) weight;
       q, k, v projections with biases; rotary embedding on the two halves
       of each head; causal softmax attention, grouped KV heads; output
       projection; residual; RMSNorm; SwiGLU MLP; residual.
  ssm  (Mamba-2, arXiv:2405.21060): pre-norm; z, x, B, C, dt projections;
       depthwise causal convolution of width d_conv and SiLU on x, B, C;
       dt = softplus(dt + dt_bias), A = -exp(a_log); the SSD scan (the
       paper's chunked minimal form, its chunks joined by a segment-sum
       matrix); D skip; y * SiLU(z); RMSNorm over d_inner; out projection;
       residual.
  head: final RMSNorm, tied embedding as the output projection, token
       cross-entropy with a z-loss z * logsumexp^2, averaged over tokens.

``precision="fp8"`` (the control) rounds both operands of every matrix
product to float8 e4m3 under a per-tensor scale to its largest value,
passing the gradient straight through.

The batch runs in blocks of rows, each layer under activation
checkpointing, so the gradient sums over blocks and fits the card at the
cells' sizes.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
BODY = "stack/body/p0/"


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = torch.clamp_min(x.detach().abs().amax(), 1e-30)
    s = 448.0 / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).to(F32) / s
    return x + (q - x.detach())


class Model:
    def __init__(self, cfg: Dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.m = cfg["model"]
        self.q = _fp8 if precision == "fp8" else (lambda t: t)

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def rms(self, x, w):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.m["norm_eps"]) * (1.0 + w)

    # -- attention layer ---------------------------------------------------
    def _rope(self, x, base: float):
        S, D = x.shape[1], x.shape[-1]
        half = D // 2
        freqs = base ** (-torch.arange(half, dtype=F32, device=x.device)
                         / half)
        ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * freqs
        cos = torch.cos(ang)[None, :, None, :]
        sin = torch.sin(ang)[None, :, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attn_layer(self, p, i, x):
        m = self.m
        B, S, _ = x.shape
        H, KV, D = m["n_heads"], m["n_kv"], m["head_dim"]
        a = BODY + "attn/"
        h = self.rms(x, p[BODY + "ln1"][i])
        q = self.mm(h, p[a + "wq"][i]) + p[a + "bq"][i]
        k = self.mm(h, p[a + "wk"][i]) + p[a + "bk"][i]
        v = self.mm(h, p[a + "wv"][i]) + p[a + "bv"][i]
        q = self._rope(q.reshape(B, S, H, D), m["rope_base"])
        k = self._rope(k.reshape(B, S, KV, D), m["rope_base"])
        v = v.reshape(B, S, KV, D)
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", self.q(q), self.q(k)) / math.sqrt(D)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~causal, float("-inf"))
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", self.q(w), self.q(v))
        x = x + self.mm(o.reshape(B, S, H * D), p[a + "wo"][i])
        h = self.rms(x, p[BODY + "ln2"][i])
        f = BODY + "mlp/"
        up = F.silu(self.mm(h, p[f + "wi"][i])) * self.mm(h, p[f + "wg"][i])
        return x + self.mm(up, p[f + "wo"][i])

    # -- SSD layer -----------------------------------------------------------
    @staticmethod
    def _conv(u, w):
        """Depthwise causal convolution: y[t] = sum_j w[j] u[t - k + 1 + j]."""
        k, C = w.shape
        y = F.conv1d(u.transpose(1, 2), w.t().unsqueeze(1), padding=k - 1,
                     groups=C)
        return y[..., :u.shape[1]].transpose(1, 2)

    @staticmethod
    def _segsum(x):
        """(..., T) -> (..., T, T): sum of x[j+1..i] at (i, j), -inf above
        the diagonal (the paper's stable form)."""
        T = x.shape[-1]
        x = x[..., None].expand(*x.shape, T)
        below = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(-1)
        s = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
        on = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        return s.masked_fill(~on, float("-inf"))

    def ssd(self, X, A, Bm, Cm, L: int):
        """X (b, s, h, p) already times dt; A (b, s, h) = dt * A; B, C
        (b, s, h, n). The Mamba-2 paper's ``ssd_minimal_discrete``."""
        b, s, h, pd = X.shape
        c = s // L
        X, Bm, Cm = (t.reshape(b, c, L, h, -1) for t in (X, Bm, Cm))
        A = A.reshape(b, c, L, h).permute(0, 3, 1, 2)          # b h c l
        A_cum = torch.cumsum(A, dim=-1)
        Lm = torch.exp(self._segsum(A))                         # b h c l l
        cb = torch.einsum("bclhn,bcshn->bhcls", self.q(Cm), self.q(Bm))
        Y_diag = torch.einsum("bhcls,bcshp->bclhp", self.q(cb * Lm),
                              self.q(X))
        decay = torch.exp(A_cum[..., -1:] - A_cum)              # b h c l
        states = torch.einsum("bclhn,bclhp->bchpn",
                              self.q(Bm * decay.permute(0, 2, 3, 1)[..., None]),
                              self.q(X))
        states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
        chunk_decay = torch.exp(self._segsum(
            F.pad(A_cum[..., -1], (1, 0))))                     # b h z c
        states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
        out_decay = torch.exp(A_cum).permute(0, 2, 3, 1)        # b c l h
        Y_off = torch.einsum("bclhn,bchpn->bclhp",
                             self.q(Cm * out_decay[..., None]),
                             self.q(states))
        return (Y_diag + Y_off).reshape(b, s, h, pd)

    def ssm_layer(self, p, i, x):
        m = self.m
        B, S, _ = x.shape
        a = BODY + "mix/"
        H, P, N = m["ssm_heads"], m["ssm_head_dim"], m["d_state"]
        G = m["ssm_groups"]
        h = self.rms(x, p[BODY + "ln1"][i])
        z = self.mm(h, p[a + "wz"][i])
        xs = F.silu(self._conv(self.mm(h, p[a + "wx"][i]), p[a + "conv_x"][i]))
        Bm = F.silu(self._conv(self.mm(h, p[a + "wb"][i]), p[a + "conv_b"][i]))
        Cm = F.silu(self._conv(self.mm(h, p[a + "wc"][i]), p[a + "conv_c"][i]))
        dt = torch.logaddexp(self.mm(h, p[a + "wdt"][i]) + p[a + "dt_bias"][i],
                             torch.zeros((), dtype=F32, device=x.device))
        A = -torch.exp(p[a + "a_log"][i])
        xs = xs.reshape(B, S, H, P)
        # head h reads group h // (H / G)
        Bm = torch.repeat_interleave(Bm.reshape(B, S, G, N), H // G, dim=2)
        Cm = torch.repeat_interleave(Cm.reshape(B, S, G, N), H // G, dim=2)
        y = self.ssd(xs * dt[..., None], dt * A, Bm, Cm, m["ssm_chunk"])
        y = y + p[a + "d_skip"][i][:, None] * xs
        y = y.reshape(B, S, H * P) * F.silu(z)
        y = self.rms(y, p[a + "norm"][i])
        return x + self.mm(y, p[a + "wout"][i])

    # -- the whole model -----------------------------------------------------
    def token_loss_sum(self, p, tokens, labels):
        """Sum over the block's tokens of cross-entropy plus z-loss."""
        x = p["embed"][tokens]
        layer = {"attn": self.attn_layer, "ssm": self.ssm_layer}[
            self.m["layer"]]
        for i in range(self.m["n_layers"]):
            x = checkpoint(layer, p, i, x, use_reentrant=False)
        x = self.rms(x, p["ln_f"])
        logits = self.mm(x, p["embed"].t())
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.sum(lse - ll + self.m["z_loss"] * lse * lse)


def loss_and_grads(cfg: Dict, params: Dict[str, torch.Tensor], tokens,
                   labels, precision: str = "f32"
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(mean token loss, {path: float32 gradient}) of one batch; ``tokens``
    and ``labels`` (B, S) integer tensors on the parameters' device."""
    model = Model(cfg, precision)
    leaves = {k: v.detach().to(F32).requires_grad_(True)
              for k, v in params.items()}
    B, S = tokens.shape
    rows = max(1, 4096 // S)
    total = 0.0
    n = float(B * S)
    with torch.enable_grad():
        for r in range(0, B, rows):
            blk = model.token_loss_sum(leaves, tokens[r:r + rows].long(),
                                       labels[r:r + rows].long()) / n
            blk.backward()
            total += float(blk.detach())
    return total, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in leaves.items()}
