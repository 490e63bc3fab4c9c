"""Analog tile abstraction: one model weight mapped onto analog arrays.

Port of the JAX package's ``core/tile.py``. A tile (``TileState``, a dict
with a fixed key set per algorithm; unused slots are ``None``) holds
  W   — main analog array          P  — auxiliary (fast) analog array
  Qd  — digital SP-tracking array   Qt — E-RIDER's analog copy of Q
  H   — digital transfer buffer     c  — chopper sign, t — step counter
  scale — model weight = scale * analog weight
  dev_p/dev_w — per-element device parameters ({"gamma", "rho"})
  seed_p/seed_w — device seeds when the parameters are regenerated.

Tensors live on the weight's device; seeds are key data and stay on the
host, like every key of the port (see ``prng``).

``TileBank`` stores all tiles of a trainer as class-keyed stacks with
leaves ``(C, n, *member)``, exactly the JAX package's layout v4.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

import torch

from .. import prng
from ..kernels import ref as kref
from .device import PRESETS, DeviceConfig, abstract_device, sample_device
from .paths import TensorSpec, flatten_with_path, structure, tree_map

ALGORITHMS = ("sgd", "ttv1", "ttv2", "agad", "residual", "rider", "erider")


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Static hyper-parameters of an analog tile (hashable)."""

    algorithm: str = "erider"
    device_p: DeviceConfig = PRESETS["reram_om"]
    device_w: DeviceConfig = PRESETS["reram_om"]
    lr_p: float = 0.5        # alpha multiplier (fast / gradient array)
    lr_w: float = 0.05       # beta multiplier (transfer / main array)
    gamma: float = 0.1       # residual mixing scale
    eta: float = 0.5         # EMA stepsize (12)
    chopper_p: float = 0.05  # chopper flip probability (17)
    transfer_every: int = 1  # TT transfer period
    threshold: float = 1.0   # TT-v2 transfer threshold, units of dw_min(W)
    bl: int = 0              # pulse-train length cap (0 = uncapped)
    pulse_mode: str = "fused"
    target_range: float = 0.6  # fraction of tau used by the initial weights
    min_weight_range: float = 0.1  # scale floor
    state_dtype: Any = torch.float32
    # store (gamma, rho) as arrays (True) or regenerate them from a seed
    store_device: bool = True
    rng: str = "threefry"  # threefry (paper-grade) | hash (fused)
    # 'absmean' rescales each tile's gradient by its mean |g|
    grad_norm: str = "none"
    # grouped engine backend: 'vmap' (a loop over the members of a class,
    # per-tile keys) or 'fused' (one batched update per class stack with
    # per-tile hash noise; bit-identical to 'vmap' with rng='hash')
    update_backend: str = "vmap"
    # thresholded W-transfer through a digital buffer (residual/rider/erider)
    buffered_transfer: bool = False
    metrics: str = "full"  # full | pulses | none

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.metrics not in ("full", "pulses", "none"):
            raise ValueError(f"unknown metrics {self.metrics!r}")
        if self.update_backend not in ("vmap", "fused"):
            raise ValueError(f"unknown update_backend {self.update_backend!r}")
        if self.update_backend == "fused" and self.pulse_mode != "fused":
            raise ValueError("update_backend='fused' requires pulse_mode='fused'")


def _needs(algorithm: str, buffered: bool = False) -> Dict[str, bool]:
    a = algorithm
    return dict(
        P=a != "sgd",
        Qd=a in ("residual", "rider", "erider", "agad"),
        Qt=a == "erider",
        H=a in ("ttv2", "agad") or (buffered and a in ("residual", "rider", "erider")),
        chopper=a in ("agad", "erider"),
        dev_p=a != "sgd",
    )


class TileState(dict):
    """dict-backed tile state; fixed key set per algorithm."""


def dtype_name(dtype) -> str:
    """torch.float32 -> "float32" (JAX's ``jnp.dtype(d).name``)."""
    return str(dtype).replace("torch.", "")


def init_tile(key, w0: torch.Tensor, cfg: TileConfig,
              sp_estimate: Optional[torch.Tensor] = None) -> TileState:
    """Create a tile for a digitally-initialized weight ``w0`` on ``w0``'s
    device; ``scale`` maps w0 into ``target_range * tau`` of the device
    range."""
    need = _needs(cfg.algorithm, cfg.buffered_transfer)
    kp, kw, _ = prng.split(key, 3)
    dt = cfg.state_dtype
    dev = w0.device
    f32 = torch.float32

    tau = min(cfg.device_w.tau_min, cfg.device_w.tau_max)
    max_abs = torch.clamp_min(torch.max(torch.abs(w0.to(f32))),
                              cfg.min_weight_range)
    scale = kref.div(max_abs, cfg.target_range * tau)
    w = (w0.to(f32) / scale).to(dt)
    shape = tuple(w0.shape)

    st = TileState(
        W=w,
        t=torch.zeros((), dtype=torch.int32, device=dev),
        scale=scale.to(f32),
        dev_w=(sample_device(kw, shape, cfg.device_w, device=dev)
               if cfg.store_device else None),
        seed_w=None if cfg.store_device else prng.key_data(kw).clone(),
        P=torch.zeros(shape, dtype=dt, device=dev) if need["P"] else None,
        Qd=None,
        Qt=None,
        H=torch.zeros(shape, dtype=f32, device=dev) if need["H"] else None,
        c=torch.ones((), dtype=f32, device=dev) if need["chopper"] else None,
        prog=(torch.zeros((), dtype=torch.int32, device=dev)
              if cfg.algorithm == "erider" else None),
        dev_p=(sample_device(kp, shape, cfg.device_p, device=dev)
               if (need["dev_p"] and cfg.store_device) else None),
        seed_p=(None if (cfg.store_device or not need["dev_p"])
                else prng.key_data(kp).clone()),
    )
    if need["Qd"]:
        # a copy: the donated step writes Q in place, never the caller's
        q0 = (torch.zeros(shape, dtype=dt, device=dev) if sp_estimate is None
              else sp_estimate.to(dt, copy=True))
        st["Qd"] = q0
        if need["Qt"]:
            st["Qt"] = q0.clone()
        if cfg.algorithm == "residual" and sp_estimate is not None:
            # two-stage semantics (Alg. 4): P starts at the SP estimate
            st["P"] = q0.clone()
    return st


def abstract_tile(shape, cfg: TileConfig, device="cuda") -> TileState:
    """TensorSpec skeleton of a tile on ``device`` (a restore template; no
    allocation). Seeds are host leaves, as ``init_tile`` makes them."""
    need = _needs(cfg.algorithm, cfg.buffered_transfer)
    shape = tuple(shape)
    dt = cfg.state_dtype

    def arr(dtype=dt, s=shape):
        return TensorSpec(s, dtype, device)

    seed = TensorSpec((2,), torch.int64, "cpu")
    return TileState(
        W=arr(),
        t=arr(torch.int32, ()),
        scale=arr(torch.float32, ()),
        dev_w=abstract_device(shape, dt, device) if cfg.store_device else None,
        seed_w=None if cfg.store_device else seed,
        P=arr() if need["P"] else None,
        Qd=arr() if need["Qd"] else None,
        Qt=arr() if need["Qt"] else None,
        H=arr(torch.float32) if need["H"] else None,
        c=arr(torch.float32, ()) if need["chopper"] else None,
        prog=arr(torch.int32, ()) if cfg.algorithm == "erider" else None,
        dev_p=(abstract_device(shape, dt, device)
               if (need["dev_p"] and cfg.store_device) else None),
        seed_p=(None if (cfg.store_device or not need["dev_p"]) else seed),
    )


def expected_pulses(dw, dw_min: float, bl: int = 0):
    """Expected pulse count of an update (telemetry for Fig. 4)."""
    n = kref.div(torch.abs(dw.to(torch.float32)), dw_min)
    if bl:
        n = torch.clamp_max(n, float(bl))
    return torch.sum(n)


# ---------------------------------------------------------------------------
# batched tile engine: shape-grouped stacks of tiles
# ---------------------------------------------------------------------------


def group_name(shape, dtype, tag: str = "", ptag: str = "") -> str:
    """Stable group key of one (shape, dtype, rule template, policy):
    "g64x64_float32_nM_prider"."""
    dims = "x".join(str(int(d)) for d in shape)
    base = f"g{dims}_{dtype_name(dtype)}"
    if tag:
        base += f"_{tag}"
    if ptag:
        base += f"_p{ptag}"
    return base


def parse_group_name(name: str) -> Optional[tuple]:
    """Inverse of ``group_name``: "g64x64_float32_nM_prider" ->
    ((64, 64), "float32", "nM", "rider"); None if not a group key."""
    m = re.match(
        r"^g(\d+(?:x\d+)*)_([A-Za-z0-9]+?)(?:_([MDns]+))?(?:_p([a-z0-9]+))?$",
        name)
    if not m:
        return None
    shape = tuple(int(d) for d in m.group(1).split("x"))
    return shape, m.group(2), m.group(3) or "", m.group(4) or ""


def class_name(group_names) -> str:
    """Scan-class key: '+'-joined member group names (member order)."""
    return "+".join(group_names)


def parse_class_name(name: str) -> tuple:
    """Inverse of ``class_name``: member group names, in stack order."""
    return tuple(name.split("+"))


def _signature(state) -> tuple:
    return (structure(state),
            tuple((tuple(leaf.shape), dtype_name(leaf.dtype))
                  for _, leaf in flatten_with_path(state)))


def class_partition(groups: Dict[str, TileState], index, policies=None):
    """Partition grouped tile states into classes of identical structure,
    leaf shapes/dtypes and TilePolicy (not the rule template tag).
    Returns ((class_name, (group, ...)), ...), sorted by class name, members
    in ``index`` order."""
    policies = policies or {}
    by_sig: Dict[Any, list] = {}
    for g, _ in index:
        sig = (_signature(groups[g]), policies.get(g))
        by_sig.setdefault(sig, []).append(g)
    return tuple(sorted((class_name(gs), tuple(gs)) for gs in by_sig.values()))


def _stack_states(states):
    """Stack same-structure states along a new leading axis (a view for a
    singleton); TensorSpec leaves stack to a spec."""
    def stk(*ls):
        if isinstance(ls[0], TensorSpec):
            return TensorSpec((len(ls),) + ls[0].shape, ls[0].dtype,
                              ls[0].device)
        return ls[0].unsqueeze(0) if len(ls) == 1 else torch.stack(ls)
    return tree_map(stk, *states)


def _class_member(state, ci: int):
    """Member group ``ci`` of a class stack (a view)."""
    def sl(leaf):
        if isinstance(leaf, TensorSpec):
            return TensorSpec(leaf.shape[1:], leaf.dtype, leaf.device)
        return leaf[ci]
    return tree_map(sl, state)


class TileBank:
    """All analog tiles of a trainer, stored as class-keyed stacks.

    ``classes``: class key -> TileState whose leaves are ``(C, n, *member)``
    (C member groups of n tiles; per-tile scalars (C, n), seeds (C, n, 2)).
    ``index``: ((group, (member-path, ...)), ...); ``class_index``:
    ((class, (group, ...)), ...); ``policies``: {group: TilePolicy}.
    ``TileBank(groups, index, policies)`` re-keys per-group stacks into
    class storage; ``TileBank.from_classes`` wraps existing class stacks.
    """

    def __init__(self, groups: Dict[str, TileState], index, policies=None):
        index = tuple((g, tuple(paths)) for g, paths in index)
        policies = dict(policies or {})
        class_index = class_partition(groups, index, policies)
        classes = {cname: _stack_states([groups[g] for g in gnames])
                   for cname, gnames in class_index}
        self._init(classes, index, class_index, policies)

    @classmethod
    def from_classes(cls, classes: Dict[str, TileState], index, class_index,
                     policies=None) -> "TileBank":
        bank = cls.__new__(cls)
        bank._init(dict(classes), index, class_index, policies)
        return bank

    def _init(self, classes, index, class_index, policies):
        self.classes = dict(classes)
        self.index = tuple((g, tuple(paths)) for g, paths in index)
        self.class_index = tuple((c, tuple(gs)) for c, gs in class_index)
        self.policies = dict(policies or {})
        self._where = {p: (g, i) for g, paths in self.index
                       for i, p in enumerate(paths)}
        self._class_of = {g: (cname, ci)
                          for cname, gnames in self.class_index
                          for ci, g in enumerate(gnames)}
        self._groups_view = None

    def policy(self, group: str):
        """TilePolicy of one stack (None for policy-less banks)."""
        return self.policies.get(group)

    @property
    def groups(self) -> Dict[str, TileState]:
        """Per-group view {group: TileState with (n, *member) leaves}."""
        if self._groups_view is None:
            self._groups_view = {
                g: _class_member(self.classes[cname], ci)
                for g, (cname, ci) in self._class_of.items()}
        return self._groups_view

    def __len__(self) -> int:
        return len(self._where)

    def __contains__(self, path) -> bool:
        return (path in self._where or path in self._class_of
                or path in self.classes)

    def __iter__(self):
        return iter(self._where)

    def paths(self):
        return tuple(self._where)

    def __getitem__(self, path) -> TileState:
        """Per-tile view, a per-group view, or a whole class stack."""
        if path in self.classes and path not in self._class_of:
            return self.classes[path]
        if path in self._class_of:
            return self.groups[path]
        g, i = self._where[path]
        cname, ci = self._class_of[g]
        return tree_map(lambda leaf: leaf[ci, i], self.classes[cname])

    # -- tree walking (``core.paths``): class stacks in class_index order,
    # as the JAX package flattens a TileBank ---------------------------------
    def tree_children(self):
        return [(c, self.classes[c]) for c, _ in self.class_index]

    def tree_rebuild(self, classes) -> "TileBank":
        return TileBank.from_classes(classes, self.index, self.class_index,
                                     self.policies)

    def __repr__(self):
        return (f"TileBank({len(self._where)} tiles in "
                f"{len(self._class_of)} groups / {len(self.classes)} "
                f"classes: {[c for c, _ in self.class_index]})")


def group_tiles(shapes: Dict[str, tuple], cfg: TileConfig, policies=None):
    """Static grouping {path: weight shape} -> TileBank index layout, keyed
    on (shape, state dtype, sharding-rule template, policy tag); the policy
    tag appears only under a plan with more than one policy."""
    from ..distributed.sharding import rule_template, template_tag

    multi = policies is not None and len(set(policies.values())) > 1
    if multi:
        by_tag: Dict[str, set] = {}
        for pol in policies.values():
            by_tag.setdefault(pol.tag, set()).add(pol)
        clashes = {t: ps for t, ps in by_tag.items() if len(ps) > 1}
        if clashes:
            raise ValueError(
                f"distinct TilePolicies share a tag (rename one): {clashes}")

    by_group: Dict[str, list] = {}
    for p in sorted(shapes):
        tag = template_tag(rule_template(p, len(shapes[p])))
        pol = (policies or {}).get(p)
        dtype = pol.tile.state_dtype if pol is not None else cfg.state_dtype
        ptag = pol.tag if (multi and pol is not None) else ""
        by_group.setdefault(
            group_name(shapes[p], dtype, tag, ptag), []).append(p)
    return tuple((g, tuple(by_group[g])) for g in sorted(by_group))


def group_policies(index, policies) -> Optional[Dict[str, Any]]:
    """{group: TilePolicy} for a grouping produced by ``group_tiles``."""
    if not policies:
        return None
    return {g: policies[paths[0]] for g, paths in index}


def abstract_tile_group(shape, n: int, cfg: TileConfig, device="cuda") -> TileState:
    """TensorSpec skeleton of an ``n``-tile stacked group."""
    return tree_map(lambda s: TensorSpec((n,) + s.shape, s.dtype, s.device),
                    abstract_tile(shape, cfg, device))


def stack_tiles(per_tile: Dict[str, TileState], index, policies=None) -> TileBank:
    """Stack per-tile states along a new leading axis, per group."""
    groups = {}
    for g, paths in index:
        groups[g] = tree_map(lambda *leaves: torch.stack(leaves),
                             *(per_tile[p] for p in paths))
    return TileBank(groups, index, policies)
