"""Sharding rules: parameter-path patterns -> partition specs, and the
local shards they give each rank.

Port of the JAX package's ``distributed/sharding.py``: the same
MaxText-style logical rules keyed on the model zoo's parameter names, the
same divisibility fallbacks and the same specs, element for element.
Highlights:

* model axis ("model"): attention heads / MLA up-projections / FFN hidden /
  expert ffn dim / RG-LRU blocks / SSD heads / vocab.
* data axes ("pod", "data"): batch; ZeRO-style sharding of analog tile
  state and digital optimizer moments (legal because analog updates are
  element-local).
* scan-stacked body params (path contains "/body/") get a leading None
  for the period axis.
* decode caches: batch dim on the data axes when divisible, otherwise the
  sequence dim (long-context batch=1).

A dim that does not divide falls back to replication.

The port has no SPMD compiler, so a spec also says what each rank holds:
``P`` is a tuple with one entry per dim, an axis name, a tuple of names
(the first the slowest) or None; ``shard`` cuts this rank's block out of a
full tensor, ``gather`` rebuilds the full tensor from the blocks
(``distributed.runtime`` collectives over ``launch.mesh.Mesh.group``),
and ``placements`` gives the same layout as ``torch.distributed.tensor``
placements. A rank's shard is a plain tensor; the trainer keeps the
specs beside it (``AnalogTrainer.shardings``) and runs each stacked tile
phase on its rows through ``shard_stacked_call``. ``constrain_stacked``,
``params_shardings`` and ``placements`` are kept for parity with the
reference (its trainer's ``_constrain``, its launchers) and held to it by
the tests; the port's trainer lays state out by ``state_shardings``.
"""
from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Optional, Tuple

from ..core.paths import flatten_with_path, tree_map, tree_map_with_path
from . import runtime


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e if (e is None or isinstance(e, str)) else tuple(e)
            for e in entries))

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s two fields)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh}, {self.spec})"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec):
    """The ``torch.distributed.tensor`` placements of ``spec``: one per
    mesh axis, ``Shard(dim)`` on the axes a dim names (a tuple entry shards
    its dim over its axes in mesh order, as DTensor nests them), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for a in mesh.axis_names:
        dims = [d for d, e in enumerate(spec) if a in _axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def mesh_axis_sizes(mesh):
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    model_ax = "model" if "model" in mesh.axis_names else None
    dsize = 1
    for a in data_axes:
        dsize *= mesh.shape[a]
    msize = mesh.shape[model_ax] if model_ax else 1
    return data_axes, dsize, model_ax, msize


# (regex, spec template) — "M" for the model axis, "D" for data axes, None
# for replicated; matched against the trailing dims of the leaf.
PARAM_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"embed$", ("M", None)),
    (r"head$", (None, "M")),
    (r"(wq|wk|wv|wuq|wuk|wuv)$", (None, "M")),
    (r"(bq|bk|bv)$", ("M",)),
    (r"attn/wo$", ("M", None)),
    (r"cross/wo$", ("M", None)),
    (r"(wdq|wdkv|wkr)$", (None, None)),
    (r"(qln|kvln|qn|kn|ln1|ln2|lnx|ln_f|norm)$", (None,)),
    (r"mlp/(wi|wg)$", (None, "M")),
    (r"mlp/wo$", ("M", None)),
    (r"moe/router$", (None, None)),
    (r"moe/(wi|wg)$", (None, None, "M")),
    (r"moe/wo$", (None, "M", None)),
    (r"moe/(swi|swg)$", (None, "M")),
    (r"moe/swo$", ("M", None)),
    (r"mix/(wx|wy|wz|wb|wc|wdt)$", (None, "M")),
    (r"mix/(war|wai)$", ("M", None, None)),
    (r"mix/lam$", ("M",)),
    (r"mix/(conv|conv_x|conv_b|conv_c)$", (None, "M")),
    (r"mix/(a_log|dt_bias|d_skip)$", ("M",)),
    (r"mix/wout$", ("M", None)),
    (r"wout$", ("M", None)),
    (r"(conv1|conv2)/w$", (None, None, None, None)),
    (r"/b$", (None,)),
    (r"/w$", (None, "M")),  # convnet fc fallback
)


def _resolve(template, shape, data_axes, dsize, model_ax, msize,
             zero_dim: Optional[int]):
    """Template -> spec with divisibility checks. ``zero_dim`` set: ZeRO-
    shard the first replicated divisible dim over the data axes."""
    offset = len(shape) - len(template)
    spec: list = [None] * len(shape)
    for i, t in enumerate(template):
        dim = offset + i
        if t == "M" and model_ax and msize > 1 and shape[dim] % msize == 0 \
                and shape[dim] > 0:
            spec[dim] = model_ax
    if zero_dim is not None and data_axes and dsize > 1:
        for dim in range(len(shape)):
            if spec[dim] is None and shape[dim] % dsize == 0 and shape[dim] >= dsize:
                spec[dim] = data_axes if len(data_axes) > 1 else data_axes[0]
                break
    return P(*spec)


def rule_template(path: str, ndim: int) -> Tuple:
    """Mesh-independent spec template of a parameter path, normalized to
    ``ndim`` dims (leading dims pad with None; body-scan params gain a
    leading None). Two paths with equal templates shard identically on
    every mesh, so their tiles may share a stack (``core.tile``)."""
    template = None
    for pat, tmpl in PARAM_RULES:
        if re.search(pat, path):
            template = tmpl
            break
    if template is None:
        template = (None,) * ndim
    if "/body/" in path and ndim > len(template):
        template = (None,) + tuple(template)
    while len(template) < ndim:
        template = (None,) + tuple(template)
    return tuple(template[-ndim:]) if ndim else ()


def template_tag(template) -> str:
    """(None, "M") -> "nM", ("M", None, None) -> "Mnn", () -> "s"."""
    if not template:
        return "s"
    return "".join({"M": "M", "D": "D"}.get(t, "n") for t in template)


def param_spec(path: str, shape, mesh, zero: bool = False) -> P:
    data_axes, dsize, model_ax, msize = mesh_axis_sizes(mesh)
    template = rule_template(path, len(shape))
    return _resolve(template, tuple(shape), data_axes, dsize, model_ax, msize,
                    0 if zero else None)


_TILE_SLOTS = r"(W|P|Qd|Qt|H|dev_p/(gamma|rho)|dev_w/(gamma|rho))"

# group signatures already warned about (one warning per offending stack)
_MIXED_RULE_WARNED: set = set()


def grouped_tile_spec(member_paths, shape, mesh, zero: bool = True) -> P:
    """Spec of a stacked tile-group array (n, *member-shape).

    Member dims inherit the owning weights' model-axis spec. A stack that
    mixes rules replicates its member dims and warns once, naming the
    offending paths. The leading stack axis takes the data axes (ZeRO)
    when the group size divides, else the first divisible replicated
    member dim does."""
    if isinstance(member_paths, str):
        member_paths = (member_paths,)
    shape = tuple(shape)
    data_axes, dsize, model_ax, msize = mesh_axis_sizes(mesh)
    per_path = {p: param_spec(p, shape[1:], mesh) for p in member_paths}
    specs = set(per_path.values())
    if len(specs) == 1:
        inner = specs.pop()
    else:
        inner = P(*([None] * (len(shape) - 1)))
        sig = tuple(sorted(member_paths))
        if sig not in _MIXED_RULE_WARNED:
            _MIXED_RULE_WARNED.add(sig)
            warnings.warn(
                "tile group mixes partition rules; model axis dropped "
                "(member dims replicate) for stack of "
                + ", ".join(f"{p}->{per_path[p]}" for p in sig)
                + " — re-group with spec-aware keys (core.tile.group_tiles)",
                stacklevel=2)
    spec = [None] + list(inner) + [None] * (len(shape) - 1 - len(inner))
    if zero and data_axes and dsize > 1:
        daxes = data_axes if len(data_axes) > 1 else data_axes[0]
        if shape[0] % dsize == 0 and shape[0] >= dsize:
            spec[0] = daxes
        else:
            for dim in range(1, len(shape)):
                if spec[dim] is None and shape[dim] % dsize == 0 \
                        and shape[dim] >= dsize:
                    spec[dim] = daxes
                    break
    return P(*spec)


def merge_specs(specs):
    """Dim-wise agreement of specs: keep an axis only where every spec
    places it; disagreeing dims replicate."""
    specs = [tuple(s) for s in specs]
    n = max((len(s) for s in specs), default=0)
    specs = [s + (None,) * (n - len(s)) for s in specs]
    return P(*[s0 if all(s[d] == s0 for s in specs) else None
               for d, s0 in enumerate(specs[0])]) if specs else P()


def constrain_stacked(tree, member_paths, mesh, zero: bool = True,
                      prefix: int = 0):
    """This rank's shard of every stacked tile-state leaf of ``tree`` (whole
    tensors): the port's counterpart of ``with_sharding_constraint`` on a
    stack. Leaves of rank >= prefix + 3 (``prefix`` leading axes, then the
    stack axis and a >= 2-D member) take the group spec, the dim-wise
    agreement over ``member_paths`` (a path tuple or a tuple of them, one
    per scanned group); per-tile scalars and seeds stay whole."""
    paths_list = [member_paths] if member_paths and isinstance(
        member_paths[0], str) else list(member_paths)

    def c(leaf):
        nd = leaf.ndim
        if nd < prefix + 3:
            return leaf
        inner = merge_specs([
            grouped_tile_spec(ps, tuple(leaf.shape)[prefix:], mesh, zero=zero)
            for ps in paths_list])
        return shard(leaf, P(*([None] * prefix + list(inner))), mesh)

    return tree_map(c, tree)


def stacked_rows(mesh, n: int, axis: int = 0) -> Optional[P]:
    """The spec that splits axis ``axis`` of a stack (length ``n``) over the
    data axes, or None when there is no data axis to split over or ``n``
    does not divide: the one test of ``shard_stacked_call``."""
    data_axes, dsize, _, _ = mesh_axis_sizes(mesh)
    if dsize <= 1 or n % dsize:
        return None
    return P(*([None] * axis),
             data_axes if len(data_axes) > 1 else data_axes[0])


def shard_stacked_call(fn, mesh, n: int, *args, axis: int = 0):
    """Run ``fn`` on this rank's rows of axis ``axis`` (length ``n``, split
    over the data axes, ``stacked_rows``) of every argument; returns
    ``fn``'s output on those rows. An argument leaf is whole (length ``n``
    there) or already this rank's rows (a ZeRO-stored block). ``fn`` must
    be element-local over the axis, as every stacked tile phase is, so the
    rows' results are the rows of the global call. Returns None when
    ``stacked_rows`` does; the caller then runs the global call."""
    rows = stacked_rows(mesh, n, axis)
    if rows is None:
        return None
    cut = tree_map(
        lambda leaf: shard(leaf, rows, mesh) if leaf.shape[axis] == n
        else leaf, args)
    return fn(*cut)


def state_shardings(state_tree, mesh, zero_states: bool = True):
    """NamedShardings of an AnalogTrainer state (TensorSpec or tensor
    leaves, global shapes).

    Class-keyed tile stacks (C, n, *member): the class axis replicates,
    the stack axis takes the ZeRO/data axes and the member dims the
    dim-wise agreement of the member groups' model-axis specs; per-tile
    scalars and seeds replicate; optimizer moments shard like their
    parameter plus ZeRO; parameters by their rule."""
    from ..core.tile import TileBank

    bank = state_tree.get("tiles") if hasattr(state_tree, "get") else None
    members = dict(bank.index) if isinstance(bank, TileBank) else {}
    class_groups = dict(bank.class_index) if isinstance(bank, TileBank) else {}

    def spec_of(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        m = re.match(rf"tiles/([^/]+)/{_TILE_SLOTS}$", path)
        if m and m.group(1) in class_groups:
            inner = merge_specs([
                grouped_tile_spec(members[g], shape[1:], mesh,
                                  zero=zero_states)
                for g in class_groups[m.group(1)]])
            return P(None, *inner)
        if m and m.group(1) in members:
            return grouped_tile_spec(members[m.group(1)], shape, mesh,
                                     zero=zero_states)
        m = re.match(r"tiles/([^/]+)/(t|c|scale|prog|seed_w|seed_p)$", path)
        if m and (m.group(1) in class_groups or m.group(1) in members):
            return P(*([None] * len(shape)))
        m = re.match(rf"tiles/(.*)/{_TILE_SLOTS}$", path)
        if m:
            return param_spec(m.group(1), shape, mesh, zero=zero_states)
        if path.startswith("opt/"):
            sub = re.sub(r"^opt/(mu|nu)/", "", path)
            return param_spec(sub, shape, mesh, zero=zero_states)
        if path.startswith("params/"):
            return param_spec(path[len("params/"):], shape, mesh)
        return param_spec(path, shape, mesh)

    return tree_map_with_path(
        lambda p, leaf: NamedSharding(mesh, spec_of(p, leaf)), state_tree)


def params_shardings(params_tree, mesh):
    return tree_map_with_path(
        lambda p, leaf: NamedSharding(mesh, param_spec(p, leaf.shape, mesh)),
        params_tree)


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------


def batch_shardings(batch_tree, mesh):
    data_axes, dsize, model_ax, msize = mesh_axis_sizes(mesh)
    daxes = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)

    def spec_of(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        spec: list = [None] * len(shape)
        if shape[0] % dsize == 0 and dsize > 1:
            spec[0] = daxes
        return P(*spec)

    return tree_map(lambda leaf: NamedSharding(mesh, spec_of(leaf)),
                    batch_tree)


def cache_shardings(cache_tree, mesh):
    """Decode-cache shardings: batch on the data axes when divisible, else
    the sequence dim (long-context batch=1); the model axis on the last
    divisible head / head_dim / state dim."""
    data_axes, dsize, model_ax, msize = mesh_axis_sizes(mesh)
    daxes = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)

    def spec_of(path, leaf):
        shape = tuple(leaf.shape)
        name = path.split("/")[-1]
        spec: list = [None] * len(shape)
        if len(shape) == 0 or name == "pos":
            return P(*spec)
        bdim = 1 if "/body/" in path else 0
        if len(shape) <= bdim:
            return P(*spec)
        batch_ok = dsize > 1 and shape[bdim] % dsize == 0 and shape[bdim] >= dsize
        if batch_ok:
            spec[bdim] = daxes
        elif name in ("k", "v", "ckv", "kpe", "ck", "cv") and len(shape) > bdim + 1 \
                and dsize > 1 and shape[bdim + 1] % dsize == 0:
            spec[bdim + 1] = daxes  # shard the cache's sequence dim
        if model_ax:
            for dim in range(len(shape) - 1, bdim, -1):
                if spec[dim] is None and shape[dim] % msize == 0 and shape[dim] >= msize:
                    spec[dim] = model_ax
                    break
        return P(*spec)

    return tree_map_with_path(
        lambda p, leaf: NamedSharding(mesh, spec_of(p, leaf)), cache_tree)


def replicated(tree, mesh):
    return tree_map(lambda _: NamedSharding(mesh, P()), tree)


def logical_rules(mesh):
    """Table consumed by ``models.common.constrain``."""
    data_axes, dsize, model_ax, msize = mesh_axis_sizes(mesh)
    daxes = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)
    return mesh, {
        "batch": daxes,
        "embed": None,
        "heads": model_ax,
        "mlp": model_ax,
        "vocab": model_ax,
    }


# ---------------------------------------------------------------------------
# compute over the model axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPEntry:
    """How one parameter is computed with over the model axis: ``kind``
    "column" (its output columns or channels split), "row" (its input rows
    split; the output summed over the model group), "vocab" (the
    embedding's rows) or "replicated" (``why`` says why); ``dim`` the split
    dim, counted from the end (so a body-stacked leaf's leading period axis
    does not move it), None when replicated."""
    kind: str
    dim: Optional[int] = None
    why: str = ""


class TPLayout:
    """``tp_layout``'s answer: ``entries`` {parameter path: TPEntry} over
    a model axis of ``size`` ranks; ``instances`` {path: layers the leaf
    stacks}; ``remat``: the body's periods are recomputed in backward."""

    def __init__(self, size: int, entries, instances, remat: bool):
        self.size = size
        self.entries = dict(entries)
        self.instances = dict(instances)
        self.remat = remat

    def dim(self, path: str) -> Optional[int]:
        """The dim of ``path`` this rank holds a 1/size block of while it
        computes (None: the whole weight)."""
        e = self.entries.get(path)
        return None if e is None else e.dim

    @property
    def split(self):
        return sorted(p for p, e in self.entries.items() if e.dim is not None)

    def summary(self) -> str:
        """One line per kind: the split parameters' names with their count,
        then each reason for replication with the names it covers."""
        groups = {}
        for p, e in sorted(self.entries.items()):
            key = (e.kind, e.why)
            name = "/".join(p.split("/")[-2:]) if "/" in p else p
            groups.setdefault(key, {}).setdefault(name, 0)
            groups[key][name] += 1
        lines = [f"tensor parallel over {self.size} model ranks: "
                 f"{len(self.split)} of {len(self.entries)} parameters split"]
        for (kind, why), names in sorted(groups.items()):
            tail = f" ({why})" if why else ""
            lines.append(f"  {kind}: " + ", ".join(
                f"{n} x{c}" if c > 1 else n for n, c in names.items()) + tail)
        return "\n".join(lines)

    def all_reduces(self, microbatch: int = 1) -> int:
        """Model-group all-reduce calls of one train step, as the model's
        operators issue them (``models.common``): a split module's output
        sum in the forward and again in a checkpointed period's recompute,
        its input's gradient, and the gradient of each whole weight or
        gate it reads on this rank's heads or hidden units only. MLA sums
        the gradients of its three latents (``ql``, ``ckv``, ``k_pe``) in
        place of its input's; cross-attention also sums the encoder
        output's; SSD's gated norm sums its sum of squares forward (again
        in the recompute) and backward and its weight's gradient."""
        def whole(mod, *names):
            return sum(1 for n in names if f"{mod}/{n}" in self.entries
                       and self.dim(f"{mod}/{n}") is None)

        calls = {}
        for p, e in self.entries.items():
            if e.dim is None:
                continue
            if p in ("embed", "head"):
                # the embedding's sum, the logits' input gradient, the
                # CE's max, sums and argmax
                calls["vocab"] = 5
                continue
            mod, name = p.rsplit("/", 1)
            remat = int(self.remat and "/body/" in p)
            once = 2 + remat
            if mod.endswith("/moe"):
                shared = name.startswith("s")
                mod += "/shared" if shared else "/routed"
                once += int(not shared)           # the gates' gradient
            elif f"{mod}/wdkv" in self.entries:
                once += 2                         # MLA
            elif mod.endswith(("/attn", "/cross")):
                once += whole(mod, "wk", "wv", "bk", "bv", "qn", "kn") + int(
                    mod.endswith("/cross"))
            elif f"{mod}/a_log" in self.entries:
                once += 3 + remat + whole(mod, "wb", "wc", "conv_b", "conv_c")
            calls[mod] = self.instances[p] * once
        return sum(calls.values()) * microbatch


def tp_layout(cfg, mesh) -> TPLayout:
    """Which parameters of ``cfg``'s model (``models.lm.LM``) each rank
    computes with a block of over ``mesh``'s model axis.

    The split dim is the one ``rule_template`` names "M" and ``param_spec``
    shards; a module splits where the reference's hint shards its
    activation (``models.common.attention_q_spec`` on the query heads,
    ``hint_spec`` on the MLP's hidden units, the RG-LRU's channels and the
    vocabulary), so the port computes over the model axis where the
    reference's GSPMD program does:

    * dense attention, cross-attention and the encoder-decoder's encoder:
      the query heads, K/V when the KV heads divide too, else each rank
      reads the whole ``wk``/``wv`` (a block of ``param_spec`` may cut a
      head there);
    * MLA: its up-projections and ``wo`` on the query heads; the latent
      projections (``wdq``, ``wdkv``, ``wkr`` and their norms) run whole;
    * RG-LRU: its channels when the gate blocks divide too (each rank owns
      whole blocks of ``war``/``wai``);
    * SSD: its heads; ``wb``/``wc`` and their convolutions when the groups
      divide too, else each rank reads them whole; the gated norm's weight
      is read at each rank's slice;
    * the routed and shared experts where ``param_spec`` cuts their ffn dim
      (the reference shards those weights and no activation hint pins
      them).

    Everything else is replicated, with the reason."""
    from ..models.common import attention_q_spec, hint_spec
    from ..models.lm import LM
    from ..models.recurrent import _rglru_blocks

    _, _, model_ax, msize = mesh_axis_sizes(mesh)
    params = LM(cfg).abstract_params("meta")
    rules = logical_rules(mesh)
    flat = flatten_with_path(params)
    mods = {}
    for p, _ in flat:
        mod, _, name = p.rpartition("/")
        mods.setdefault(mod, set()).add(name)

    def hinted(width, logical):
        spec = hint_spec((1, 1, width), ("batch", None, logical), rules)
        return spec is not None and spec[2] == model_ax

    H, KV, D = cfg.n_heads, cfg.n_kv, cfg.head_dim
    heads = attention_q_spec((1, 1, H, D), rules) is not None
    qwhy = f"{H} query heads do not divide over {msize}"
    vocab = hinted(cfg.vocab, "vocab")
    blocks = _rglru_blocks(cfg)
    rglru = hinted(cfg.rnn_width, "mlp") and blocks % msize == 0
    rwhy = (f"rnn_width {cfg.rnn_width} or its {blocks} gate blocks do not "
            f"divide over {msize}")
    ssd = cfg.ssm_heads % msize == 0
    swhy = f"{cfg.ssm_heads} SSM heads do not divide over {msize}"
    entries, instances = {}, {}
    for p, leaf in flat:
        shape = tuple(leaf.shape)
        mod, _, name = p.rpartition("/")
        part = mod.rpartition("/")[2]
        tmpl = rule_template(p, len(shape))
        spec = param_spec(p, shape, mesh)
        cut = [d - len(shape) for d, e in enumerate(spec) if e == model_ax]
        dim = cut[0] if cut and tmpl[cut[0]] == "M" else None
        instances[p] = shape[0] if "/body/" in p else 1

        def split(kind, ok, why):
            if msize <= 1:
                return TPEntry("replicated", None, "no model axis")
            if not ok:
                return TPEntry("replicated", None, why)
            if dim is None:
                return TPEntry("replicated", None,
                               f"{shape} does not divide over {msize}")
            return TPEntry(kind, dim)

        if p in ("embed", "head"):
            e = split("vocab" if p == "embed" else "column", vocab,
                      f"{cfg.vocab} ids do not divide over {msize}")
        elif part == "attn" and "wdkv" in mods[mod]:
            if name in ("wuq", "wuk", "wuv"):
                e = split("column", heads, qwhy)
            elif name == "wo":
                e = split("row", heads, qwhy)
            else:
                e = TPEntry("replicated", None,
                            "a latent projection, whole on every rank")
        elif part == "mix" and "a_log" in mods[mod]:
            if name == "wout":
                e = split("row", ssd, swhy)
            elif name in ("wb", "wc", "conv_b", "conv_c"):
                e = split("column", ssd and cfg.ssm_groups % msize == 0,
                          f"{cfg.ssm_groups} SSM groups do not divide over "
                          f"{msize}: each rank reads B and C whole"
                          if ssd else swhy)
            elif name == "norm" and ssd and msize > 1:
                e = TPEntry("replicated", None, "one weight over all of "
                            "d_inner: each rank reads its slice")
            elif name == "norm":
                e = split("column", False, swhy)
            else:
                e = split("column", ssd, swhy)
        elif part == "mix":
            e = split("row" if name == "wout" else "column", rglru, rwhy)
        elif part in ("attn", "cross"):
            if name in ("wq", "bq"):
                e = split("column", heads, qwhy)
            elif name == "wo":
                e = split("row", heads, qwhy)
            elif name in ("wk", "wv", "bk", "bv"):
                e = split("column", heads and KV % msize == 0,
                          f"{KV} KV heads do not divide over {msize}: each "
                          f"rank reads the heads its query heads use"
                          if heads else qwhy)
            else:
                e = TPEntry("replicated", None, "one weight over every head")
        elif part == "mlp" and name in ("wi", "wg", "wo"):
            e = split("row" if name == "wo" else "column",
                      hinted(cfg.d_ff, "mlp"),
                      f"d_ff {cfg.d_ff} does not divide over {msize}")
        elif part == "moe" and name != "router":
            e = split("row" if name.endswith("wo") else "column", True, "")
        else:
            e = TPEntry("replicated", None, "not split over the model axis")
        entries[p] = e
    return TPLayout(msize, entries, instances, cfg.remat)


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------


def _entries(spec, ndim: int):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` array under ``spec``."""
    return tuple(s // mesh.axes_size(e) if e is not None else s
                 for s, e in zip(shape, _entries(spec, len(shape))))


def shard(t, spec, mesh, dims=None):
    """This rank's block of the full tensor ``t`` under ``spec`` (on
    ``dims`` only, when given): a copy, so the full tensor can be freed."""
    out = t
    for d, e in enumerate(_entries(spec, t.ndim)):
        if e is None or (dims is not None and d not in dims):
            continue
        n = mesh.axes_size(e)
        if n == 1:
            continue
        size = t.shape[d] // n
        out = out.narrow(d, mesh.index(e) * size, size)
    return out.clone() if out is not t else t


def gather(t, spec, mesh, dims=None, tag: str = ""):
    """The full tensor from this rank's block ``t`` under ``spec`` (over
    ``dims`` only, when given): one all-gather per sharded dim, over the
    ranks that hold the other blocks of that dim. Collective. Counted in
    ``runtime.STATS`` as "all_gather", "model/all_gather" over the model
    axis, with "/tag" after when given."""
    for d, e in enumerate(_entries(spec, t.ndim)):
        if e is None or (dims is not None and d not in dims):
            continue
        label = ("model/" if "model" in _axes(e) else "") + "all_gather"
        t = runtime.all_gather(t, mesh.group(e), dim=d,
                               label=label + (f"/{tag}" if tag else ""))
    return t


def _spec_map(shardings):
    return {p: s.spec for p, s in flatten_with_path(shardings)}


def shard_tree(tree, shardings):
    """Every leaf's block by the ``NamedSharding`` at its path."""
    specs, mesh = _spec_map(shardings), shardings_mesh(shardings)
    return tree_map_with_path(lambda p, leaf: shard(leaf, specs[p], mesh),
                              tree)


def gather_tree(tree, shardings):
    """Every leaf's full tensor from this rank's block. Collective."""
    specs, mesh = _spec_map(shardings), shardings_mesh(shardings)
    return tree_map_with_path(lambda p, leaf: gather(leaf, specs[p], mesh),
                              tree)


def shardings_mesh(shardings):
    """The mesh of a tree of NamedShardings (its first leaf's)."""
    for _, s in flatten_with_path(shardings):
        return s.mesh
    return None
