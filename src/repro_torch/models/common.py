"""Shared model building blocks: inits, norms, activations, RoPE/M-RoPE and
the token cross-entropy.

Port of the JAX package's ``models/common.py``. Models are functional:
``init(key, cfg, device) -> params`` (nested dicts of tensors) and pure
apply functions; parameter names are the reference's (``stack/body/p0/
attn/wq``), so analog plans, sharding templates and checkpoints select the
same paths in both packages. Initializers draw through ``repro_torch.prng``
as ``jax.random`` draws, in float32, then cast to the config's dtype.

The sharding hints (``set_shard_rules``, ``hint_spec``,
``attention_q_spec``) resolve logical axes to a spec as the reference's
do; ``constrain`` and ``constrain_attention_q`` return their input
unchanged, since a port rank holds plain local tensors. What the
reference's hints make GSPMD do over the model axis, the port does by
hand under ``model_parallel``: the trainer hands a forward this rank's
block of every weight that ``distributed.sharding.tp_layout`` splits, and
the modules that read them (``attention.attn_forward``,
``attention.mla_forward``, ``attention.cross_forward``,
``recurrent.rglru_forward``, ``recurrent.ssm_forward``,
``moe.mlp_forward``, ``moe.moe_forward``, ``lm.LM``) bracket their split
products with Megatron's two operators, ``copy_to_model`` (identity
forward, a sum all-reduce of the gradient over the model group) and
``reduce_from_model`` (a sum all-reduce forward, identity backward); a
norm over split channels (SSD's gated norm, ``rms_norm_over_model``)
sums its sum of squares over the group both ways (``sum_over_model``);
the vocabulary's embedding read (``vocab_rows``) and cross-entropy
(``softmax_cross_entropy(..., vocab=)``) take their rank's block of the
vocabulary. A serve step as a rank of a mesh also meets caches that
``distributed.sharding.cache_shardings`` cuts on another dim than the
compute: ``sum_partials`` (partial scores or state products over a slice
of their contraction dim), ``gather_from_model`` (this rank's heads'
activations made every head's), ``model_slice`` and ``to_model_block``
(a value in a cache block's cut), and ``vocab_greedy`` (the argmax over
a split vocabulary). Outside ``model_parallel`` every one of them is the
identity and a module whose weights are whole runs as one process does.
``data_parallel`` tells a forward on one rank's rows of a global batch how
many ranks share it, so a statistic over the batch (``data_mean``) is the
global batch's, as the reference's one program computes it.
``sequence_parallel`` tells a serve step whose rows do not split over the
data axes (one row, which every data rank computes) which block of a
cache's slots this rank holds where the data axes split its sequence.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import prng
from ..kernels.ref import div

# ---------------------------------------------------------------------------
# sharding hints (rules installed by a launcher)
# ---------------------------------------------------------------------------

_ACTIVE_RULES: contextvars.ContextVar = contextvars.ContextVar(
    "shard_rules", default=None)


def set_shard_rules(rules) -> None:
    """Install (mesh, {logical_name: mesh_axis | None}) for the hints
    (``distributed.sharding.logical_rules``)."""
    _ACTIVE_RULES.set(rules)


def hint_spec(shape, logical_axes, rules=None):
    """The spec a ``constrain(x, *logical_axes)`` hint asks for on a tensor
    of ``shape`` (a tuple of mesh axes or None per dim), or None when it
    asks for nothing. Divisibility-aware: a dim that does not divide by its
    mesh axes' size drops its hint."""
    rules = _ACTIVE_RULES.get() if rules is None else rules
    if rules is None:
        return None
    mesh, table = rules

    def axis_size(a):
        if a is None:
            return 1
        n = 1
        for nm in (a if isinstance(a, tuple) else (a,)):
            n *= mesh.shape[nm]
        return n

    axes = []
    for i, name in enumerate(logical_axes):
        a = table.get(name)
        n = axis_size(a)
        axes.append(a if (a is not None and n > 1 and shape[i] % n == 0)
                    else None)
    return None if all(a is None for a in axes) else tuple(axes)


def constrain(x, *logical_axes: Optional[str]):
    """A sharding hint: ``x`` itself (see the module docstring)."""
    return x


def attention_q_spec(shape, rules=None):
    """The spec ``constrain_attention_q`` asks for on a (B, Sq, H, D)
    query: heads on the model axis when H divides it, else nothing."""
    rules = _ACTIVE_RULES.get() if rules is None else rules
    if rules is None:
        return None
    mesh, table = rules
    model_ax = table.get("heads")
    if model_ax is None:
        return None
    msize = mesh.shape[model_ax] if not isinstance(model_ax, tuple) else 0
    if msize and msize > 1 and shape[2] % msize == 0:
        return (table.get("batch"), None, model_ax, None)
    return None


def constrain_attention_q(q):
    """The query's sharding hint: ``q`` itself."""
    return q


# ---------------------------------------------------------------------------
# batch statistics over the data axes (installed by a trainer step)
# ---------------------------------------------------------------------------

_DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "data_group", default=None)


@contextlib.contextmanager
def data_parallel(group, size: int):
    """Within the block, a forward runs on this rank's rows of a global
    batch split ``size`` ways over ``group``: ``data_size`` and
    ``data_mean`` let a statistic over the batch (the MoE router's) be the
    global batch's, as the reference's one program computes it."""
    tok = _DATA_GROUP.set((group, size) if size > 1 else None)
    try:
        yield
    finally:
        _DATA_GROUP.reset(tok)


def data_size() -> int:
    """How many ranks share the global batch (1 outside ``data_parallel``)."""
    dp = _DATA_GROUP.get()
    return 1 if dp is None else dp[1]


class _DataMean(torch.autograd.Function):
    """The mean over the data ranks forward; the gradient passes unscaled.
    Every rank's loss then holds the global statistic, and the trainer's
    mean over ranks of the gradients gives each rank's rows the 1/size
    share of it that the one-process gradient gives them."""

    @staticmethod
    def forward(ctx, x, group, size):
        from ..distributed import runtime

        return div(runtime.all_reduce(x.detach(), group, label="batch_stats"),
                   float(size))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def data_mean(x):
    """The mean over the data ranks of a per-rank mean ``x`` (equal rows on
    every rank, so the global batch's mean); ``x`` itself outside
    ``data_parallel``."""
    dp = _DATA_GROUP.get()
    return x if dp is None else _DataMean.apply(x, *dp)


# ---------------------------------------------------------------------------
# compute over the model axis (installed by a trainer step)
# ---------------------------------------------------------------------------

_MODEL_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "model_group", default=None)


@contextlib.contextmanager
def model_parallel(group, size: int, index: int):
    """Within the block, a forward runs on this rank's blocks of the split
    weights: ``size`` ranks of ``group`` each hold block ``index`` of every
    weight that ``distributed.sharding.tp_layout`` splits. A size of 1 is
    one process (the operators are the identity)."""
    if size > 1 and group is None:
        raise ValueError(f"a model axis of {size} ranks needs its group")
    tok = _MODEL_GROUP.set((group, size, index) if size > 1 else None)
    try:
        yield
    finally:
        _MODEL_GROUP.reset(tok)


def model_size() -> int:
    """How many ranks split the model's weights (1 outside
    ``model_parallel``)."""
    mp = _MODEL_GROUP.get()
    return 1 if mp is None else mp[1]


def model_index() -> int:
    """This rank's block index over the model axis (0 outside)."""
    mp = _MODEL_GROUP.get()
    return 0 if mp is None else mp[2]


def parallel_context():
    """A context manager that installs the data and model axes active now:
    ``torch.utils.checkpoint`` recomputes a forward inside backward, where
    autograd's device threads see no context variable of the caller."""
    saved = (_DATA_GROUP.get(), _MODEL_GROUP.get())

    @contextlib.contextmanager
    def enter():
        toks = (_DATA_GROUP.set(saved[0]), _MODEL_GROUP.set(saved[1]))
        try:
            yield
        finally:
            _MODEL_GROUP.reset(toks[1])
            _DATA_GROUP.reset(toks[0])

    return enter


def split_width(local: int, whole: int, what: str) -> bool:
    """Whether a module's weight is this rank's block of ``whole`` columns
    or rows (``local``, a 1/size share) rather than the whole weight.
    Raises when it is neither, or when it is a block outside
    ``model_parallel``: a module never runs on a block as if it were
    whole."""
    if local == whole:
        return False
    m = model_size()
    if m > 1 and local * m == whole:
        return True
    raise ValueError(f"{what}: {local} of {whole} columns or rows on a model "
                     f"axis of {m} rank(s)")


def _model_reduce(x, group, label, op="sum"):
    from ..distributed import runtime

    return runtime.all_reduce(x, group, op=op, label=label)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group (each
    rank's split product gives its part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_reduce(g, ctx.group, "model/all_reduce/grad"), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward (a row split's partial
    products, in their own dtype); the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, group, label):
        return _model_reduce(x, group, label)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_model(x):
    """The input of a split region (``x`` itself outside
    ``model_parallel``)."""
    mp = _MODEL_GROUP.get()
    return x if mp is None else _CopyToModel.apply(x, mp[0])


def reduce_from_model(x, label: str = "model/all_reduce/out"):
    """The output of a split region: the sum of every rank's part (``x``
    itself outside ``model_parallel``)."""
    mp = _MODEL_GROUP.get()
    return x if mp is None else _ReduceFromModel.apply(x, mp[0], label)


class _SumOverModel(torch.autograd.Function):
    """The sum over the model group forward and backward: a statistic that
    every rank's block adds to and every rank's block reads, so each
    rank's gradient of it holds only its block's part."""

    @staticmethod
    def forward(ctx, x, group, label):
        ctx.group, ctx.label = group, label
        return _model_reduce(x, group, label)

    @staticmethod
    def backward(ctx, g):
        return _model_reduce(g, ctx.group, ctx.label + "/grad"), None, None


def sum_over_model(x, label: str = "model/all_reduce/norm"):
    """The sum of every rank's ``x`` forward, its gradient summed too
    (``x`` itself outside ``model_parallel``)."""
    mp = _MODEL_GROUP.get()
    return x if mp is None else _SumOverModel.apply(x, mp[0], label)


def rms_norm_over_model(x, w, eps: float = 1e-6):
    """``rms_norm(x, w)`` where ``x`` may be this rank's block of the
    ``w.shape[-1]`` channels it normalises over (split by the product
    before it): each rank's float32 sum of squares is summed over the model
    group forward and backward (``sum_over_model``) before the rsqrt, and
    the whole ``w`` is read at this rank's slice, its gradient summed. One
    norm over all the channels, as one process computes it (a norm per
    block would be another function)."""
    width = w.shape[-1]
    if not split_width(x.shape[-1], width, "norm"):
        return rms_norm(x, w, eps)
    n = x.shape[-1]
    w = copy_to_model(w).narrow(-1, model_index() * n, n)
    xf = x.to(torch.float32)
    ss = sum_over_model(torch.sum(torch.square(xf), dim=-1, keepdim=True))
    out = xf * torch.rsqrt(div(ss, float(width)) + eps) * (
        1.0 + w.to(torch.float32))
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# serving over the model axis (no autograd: a serve step runs under no_grad)
# ---------------------------------------------------------------------------


def sum_partials(x, what: str):
    """The sum over the model group of each rank's partial ``x``: scores or
    state products summed over a slice of their contraction dim, which a
    serve cache stores split over the model axis (``runtime.STATS`` label
    ``model/all_reduce/partial/<what>``). ``x`` itself outside
    ``model_parallel``."""
    return reduce_from_model(x, f"model/all_reduce/partial/{what}")


_SEQUENCE_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "sequence_group", default=None)


@contextlib.contextmanager
def sequence_parallel(group, size: int, index: int):
    """Within the block, ``size`` data ranks of ``group`` each compute
    every row of a serve step (a batch that does not split over them), and
    a cache leaf split on its sequence holds block ``index`` of its slots
    on this rank: a decode over it merges the ranks' partial softmax over
    the group (``attention.decode_attention``)."""
    tok = _SEQUENCE_GROUP.set((group, size, index) if size > 1 else None)
    try:
        yield
    finally:
        _SEQUENCE_GROUP.reset(tok)


def sequence_group():
    """(group, size, index) of ``sequence_parallel``, or None outside."""
    return _SEQUENCE_GROUP.get()


def gather_from_model(x, dim: int, what: str):
    """Every rank's ``x`` concatenated along ``dim`` in model-rank order
    (``model/all_gather/serve/<what>``): a serve step's activation of this
    rank's heads made every head's. ``x`` itself outside
    ``model_parallel``."""
    mp = _MODEL_GROUP.get()
    if mp is None:
        return x
    from ..distributed import runtime

    return runtime.all_gather(x, mp[0], dim=dim % x.ndim,
                              label=f"model/all_gather/serve/{what}")


def model_slice(t, n: int, dim: int = -1):
    """This rank's block of ``n`` along ``dim`` of ``t`` (``t`` itself when
    it has ``n`` there): what a rank stores of a whole value."""
    if t.shape[dim] == n:
        return t
    return t.narrow(dim, model_index() * n, n)


def to_model_block(t, shape, what: str = "state"):
    """``t`` in the shape ``shape`` of another cut over the model axis: a
    dim where ``t`` is a 1/size block of ``shape`` is gathered
    (``model/all_gather/<what>``), then a dim where ``shape`` is a block of
    ``t`` is cut to this rank's block. The dims are the same value's, so
    the result is the block ``shape`` names bit for bit."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    m = model_size()
    for d in range(t.ndim):
        if t.shape[d] * m == shape[d]:
            from ..distributed import runtime

            t = runtime.all_gather(t, _MODEL_GROUP.get()[0], dim=d,
                                   label=f"model/all_gather/{what}")
    for d in range(t.ndim):
        if shape[d] * m == t.shape[d]:
            t = model_slice(t, shape[d], d)
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: {tuple(t.shape)} is no cut of {shape} "
                         f"over {m} model rank(s)")
    return t


def vocab_greedy(logits, vocab: int):
    """The greedy token (B, 1) int32 of (B, S, V) logits at the last
    position, where the logits may be this rank's block of the ``vocab``
    (``LM._logits`` under a split head): the smallest global id that holds
    the global max, as one process's ``argmax`` takes it."""
    block = _vocab_block(logits.shape[-1], vocab, "logits")
    if block is None:
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    _, pred = _vocab_argmax(logits[:, -1].to(torch.float32), block[0], vocab)
    return pred.to(torch.int32)[:, None]


def _vocab_block(n_local: int, vocab: int, what: str):
    """(first id of this rank's block, block size) of a vocabulary split
    over the model axis, or None when the table is whole."""
    if not split_width(n_local, vocab, what):
        return None
    return model_index() * n_local, n_local


def vocab_rows(table, ids, vocab: int):
    """``take_rows(table, ids)`` where ``table`` may be this rank's block of
    the vocabulary's rows: ids outside the block read 0, then the ranks'
    reads are summed (one all-reduce), which adds each row to zeros, so the
    result is the whole table's read bit for bit."""
    block = _vocab_block(table.shape[0], vocab, "embed")
    if block is None:
        return take_rows(table, ids)
    lo, n = block
    local = ids - lo
    inside = (local >= 0) & (local < n)
    x = take_rows(table, torch.where(inside, local, 0))
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return reduce_from_model(x, "model/all_reduce/embed")


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _meta(device) -> bool:
    """On the meta device an initializer draws nothing: its result only
    carries a shape and a dtype (``LM.abstract_params``)."""
    return torch.device(device).type == "meta"


def dense_init(key, shape: Sequence[int], dtype, fan_in: Optional[int] = None,
               device="cuda"):
    if _meta(device):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fi = fan_in if fan_in is not None else shape[0]
    std = fi ** -0.5
    return (std * prng.truncated_normal(key, -2.0, 2.0, shape, device)).to(dtype)


def embed_init(key, shape, dtype, device="cuda"):
    if _meta(device):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    return prng.normal(key, shape, device).to(dtype)


def zeros(shape, dtype, device="cuda"):
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def dot(a, b):
    """``a @ b`` in the promoted dtype of the two, as ``jnp`` promotes (a
    float32 activation times a bfloat16 analog weight is a float32
    product); torch's ``@`` refuses mixed dtypes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def take_rows(table, ids):
    """``table[ids]`` (rows of a 2-D table), with a backward that sums each
    row's gradients in a fixed order on either device: on CUDA an indexed
    read (its ``index_put_`` sorts the ids first; ``F.embedding``'s
    backward is not bit-reproducible there), on the CPU ``F.embedding``
    (an indexed read's ``index_put_`` adds in parallel there). A ``meta``
    table takes the card's route."""
    if table.device.type != "cpu":
        return table[ids]
    return F.embedding(ids, table)


def einsum(eq: str, *ops):
    """``torch.einsum`` in the promoted dtype of its operands, as
    ``jnp.einsum`` promotes."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
    return out.to(x.dtype)


def activation(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def softcap(x, cap: float):
    if cap and cap > 0:
        return torch.tanh(div(x, cap)) * cap
    return x


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, base: float, device="cuda"):
    half = head_dim // 2
    return torch.pow(base, div(-torch.arange(0, half, dtype=torch.float32,
                                             device=device), half))


def _rotate(x, ang):
    """Rotate the (even, odd halves) pairs of x (..., S, H, D) by ang
    (..., S, D/2), in float32; cast back to x's dtype."""
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, base: float = 10000.0):
    """x: (..., S, H, D); positions: (..., S) int. Rotates pairs (even, odd
    halves split convention)."""
    freqs = rope_freqs(x.shape[-1], base, x.device)  # (d/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., S, d/2)
    return _rotate(x, ang)


def apply_mrope(x, positions3, sections: Tuple[int, ...], base: float = 10000.0):
    """Multimodal RoPE (Qwen2-VL): positions3 (3, ..., S) for (t, h, w);
    frequency channels are split into per-section groups, each rotated by its
    own position stream. ``sum(sections) == head_dim // 2``."""
    d = x.shape[-1]
    half = d // 2
    assert sum(sections) == half, (sections, d)
    freqs = rope_freqs(d, base, x.device)  # (half,)
    angs = []
    off = 0
    for i, sec in enumerate(sections):
        # an index past the leading axis reads its last row, as jnp indexing
        # clamps: text-only (B, S) positions reach here unbroadcast from
        # ``attention._rope_qk``, and every row is the same arange
        pos = positions3[min(i, positions3.shape[0] - 1)]  # (..., S)
        angs.append(pos[..., :, None].to(torch.float32) * freqs[off:off + sec])
        off += sec
    return _rotate(x, torch.cat(angs, dim=-1))  # (..., S, half)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits, labels, mask=None, z_loss: float = 1e-4,
                          vocab: Optional[int] = None):
    """Token-level CE in f32 with optional z-loss; returns (loss, aux).
    ``logits`` may be this rank's block of a ``vocab`` split over the model
    axis (``_vocab_parallel_ce``); the loss and accuracy are then the
    whole vocabulary's on every rank."""
    lf = logits.to(torch.float32)
    labels = labels.long()
    block = None if vocab is None else _vocab_block(lf.shape[-1], vocab,
                                                    "logits")
    if block is not None:
        lse, ll, pred = _vocab_parallel_ce(lf, labels, block, vocab)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, labels[..., None])[..., 0]
        pred = torch.argmax(lf, -1)
    ce = lse - ll
    zl = z_loss * torch.square(lse)
    per_tok = ce + zl
    if mask is None:
        mask = torch.ones_like(ce)
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    loss = torch.sum(per_tok * mask) / denom
    acc = torch.sum((pred == labels) * mask) / denom
    return loss, {"ce": torch.sum(ce * mask) / denom, "accuracy": acc}


def _vocab_argmax(lf, lo: int, vocab: int):
    """(global max, argmax id) over the whole vocabulary of ``lf``, this
    rank's float32 logits of the ids from ``lo``: a MAX all-reduce of the
    maxima, then the smallest global id that holds it (torch's first-index
    rule), one more MAX all-reduce of the negated ids."""
    group = _MODEL_GROUP.get()[0]
    lmax = torch.amax(lf, dim=-1)
    gmax = _model_reduce(lmax, group, "model/all_reduce/max", op="max")
    first = torch.argmax((lf == gmax[..., None]).to(torch.uint8), -1)
    cand = torch.where(lmax == gmax, first + lo,
                       torch.full_like(first, vocab))
    return gmax, -_model_reduce(-cand, group, "model/all_reduce/max",
                                op="max")


def _vocab_parallel_ce(lf, labels, block, vocab: int):
    """(logsumexp, label logit, argmax) over the whole vocabulary from
    ``lf``, this rank's float32 logits of the ids ``block`` (first id,
    count): the global max (a MAX all-reduce, held constant, as
    logsumexp's gradient does not depend on it), the sum of ``exp(lf -
    max)`` and the label's logit (read on the rank that holds it, 0
    elsewhere) in one sum all-reduce; the argmax is the smallest global id
    that holds the global max (torch's first-index rule), one more MAX
    all-reduce of the negated ids."""
    lo, n = block
    with torch.no_grad():
        gmax, pred = _vocab_argmax(lf, lo, vocab)
    local = labels - lo
    inside = (local >= 0) & (local < n)
    ll = torch.gather(lf, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    ll = torch.where(inside, ll, torch.zeros((), dtype=ll.dtype,
                                             device=ll.device))
    sums = reduce_from_model(torch.stack(
        [torch.sum(torch.exp(lf - gmax[..., None]), dim=-1), ll]),
        "model/all_reduce/ce")
    return gmax + torch.log(sums[0]), sums[1], pred
