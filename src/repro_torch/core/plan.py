"""AnalogPlan: per-path policies for heterogeneous devices and algorithms.

Port of the JAX package's ``core/plan.py``. ``TilePolicy`` is what one
parameter gets: a ``TileConfig`` or the ``DIGITAL`` sentinel. ``AnalogPlan``
is an ordered list of ``(pattern, policy)`` rules plus a default; the FIRST
matching rule wins. Patterns are globs (``**`` crosses ``/``), ``re:``
regexes (``re.search``) or ``(path, leaf) -> bool`` predicates. Leaves with
fewer than ``analog_min_ndim`` dims stay digital.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .device import PRESETS, DeviceConfig
from .paths import flatten_with_path, tree_map_with_path
from .tile import TileConfig, dtype_name


def _jax_repr(cfg: TileConfig) -> str:
    """``repr`` of the TileConfig as the JAX package spells it (its
    state_dtype is ``jnp.float32``), so unnamed policies hash to the same
    tag, and with it the same group keys, in both packages."""
    fields = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        r = (f"<class 'jax.numpy.{dtype_name(v)}'>"
             if isinstance(v, torch.dtype) else repr(v))
        fields.append(f"{f.name}={r}")
    return f"TileConfig({', '.join(fields)})"


@dataclasses.dataclass(frozen=True)
class TilePolicy:
    """One per-path analog policy: a TileConfig, or digital (tile=None).
    A non-empty ``name`` becomes the policy tag in group keys; unnamed
    policies hash their config into a 6-hex tag."""

    tile: Optional[TileConfig] = None
    name: str = ""

    @property
    def is_digital(self) -> bool:
        return self.tile is None

    @property
    def tag(self) -> str:
        """Short [a-z0-9]+ identifier used in group keys."""
        if self.tile is None:
            return "digital"
        if self.name:
            t = re.sub(r"[^a-z0-9]", "", self.name.lower())
            if t:
                return t
        return hashlib.md5(_jax_repr(self.tile).encode()).hexdigest()[:6]

    @classmethod
    def of(cls, algorithm: str = "erider", device_p=None, device_w=None,
           *, name: str = "", **hyperparams) -> "TilePolicy":
        """Devices may be DeviceConfigs or preset names; extra kwargs are
        TileConfig hyper-parameters."""
        if algorithm == "digital":
            return DIGITAL

        def dev(d):
            return PRESETS[d] if isinstance(d, str) else d

        device_p, device_w = dev(device_p), dev(device_w)
        if device_w is None:
            device_w = device_p if device_p is not None else PRESETS["reram_om"]
        if device_p is None:
            device_p = device_w
        return cls(TileConfig(algorithm=algorithm, device_p=device_p,
                              device_w=device_w, **hyperparams),
                   name or algorithm)

    def __repr__(self):
        if self.is_digital:
            return "TilePolicy(DIGITAL)"
        return (f"TilePolicy({self.name or self.tag}: {self.tile.algorithm}, "
                f"dw_min(p)={self.tile.device_p.dw_min})")


DIGITAL = TilePolicy(tile=None, name="digital")


def _glob_to_re(pattern: str) -> str:
    """Glob -> anchored regex: ``**/`` optionally crosses directories,
    ``**`` matches anything, ``*``/``?`` stay within one segment."""
    out, i = [], 0
    while i < len(pattern):
        c = pattern[i]
        if pattern.startswith("**/", i):
            out.append(r"(?:.*/)?")
            i += 3
        elif pattern.startswith("**", i):
            out.append(r".*")
            i += 2
        elif c == "*":
            out.append(r"[^/]*")
            i += 1
        elif c == "?":
            out.append(r"[^/]")
            i += 1
        else:
            out.append(re.escape(c))
            i += 1
    return "".join(out)


def compile_pattern(pattern) -> Callable[[str, Any], bool]:
    """Pattern (glob / "re:" regex / predicate) -> (path, leaf) predicate."""
    if callable(pattern):
        return pattern
    if pattern.startswith("re:"):
        rx = re.compile(pattern[3:])
        return lambda path, leaf: rx.search(path) is not None
    rx = re.compile(_glob_to_re(pattern))
    return lambda path, leaf: rx.fullmatch(path) is not None


def _as_policy(p) -> TilePolicy:
    if isinstance(p, TilePolicy):
        return p
    if isinstance(p, TileConfig):
        return TilePolicy(tile=p)
    if p == "digital" or p is None:
        return DIGITAL
    raise TypeError(f"not a TilePolicy/TileConfig/'digital': {p!r}")


@dataclasses.dataclass(frozen=True)
class AnalogPlan:
    """Ordered (pattern, TilePolicy) rules + default; first match wins."""

    rules: Tuple[Tuple[Any, TilePolicy], ...] = ()
    default: TilePolicy = DIGITAL
    analog_min_ndim: int = 2

    def __post_init__(self):
        object.__setattr__(
            self, "_matchers",
            tuple((compile_pattern(pat), pol) for pat, pol in self.rules))

    @classmethod
    def of(cls, *rules, default=DIGITAL, analog_min_ndim: int = 2) -> "AnalogPlan":
        return cls(rules=tuple((pat, _as_policy(pol)) for pat, pol in rules),
                   default=_as_policy(default),
                   analog_min_ndim=analog_min_ndim)

    @classmethod
    def single(cls, policy, analog_filter=None, analog_min_ndim: int = 2) -> "AnalogPlan":
        """One policy everywhere (optionally gated by a predicate)."""
        pat = analog_filter if analog_filter is not None else "**"
        return cls.of((pat, policy), analog_min_ndim=analog_min_ndim)

    def policy_for(self, path: str, leaf=None) -> TilePolicy:
        """First matching rule's policy (the default otherwise); a too-low-
        rank leaf is digital regardless (``leaf=None`` skips that guard)."""
        for match, pol in self._matchers:
            if match(path, leaf):
                found = pol
                break
        else:
            found = self.default
        if (not found.is_digital and leaf is not None
                and getattr(leaf, "ndim", 0) < self.analog_min_ndim):
            return DIGITAL
        return found

    def policies(self) -> Tuple[TilePolicy, ...]:
        out = []
        for _, pol in self.rules:
            if pol not in out:
                out.append(pol)
        if self.default not in out:
            out.append(self.default)
        return tuple(out)

    def __repr__(self):
        pats = [pat if isinstance(pat, str) else "<predicate>"
                for pat, _ in self.rules]
        return f"AnalogPlan({len(self.rules)} rules: {pats}, default={self.default.name})"


def plan_partition(params, plan: AnalogPlan):
    """Split a param tree by plan: (digital tree with None at analog slots,
    {path: leaf} analog dict, {path: TilePolicy} resolved policies)."""
    analog: Dict[str, Any] = {}
    policies: Dict[str, TilePolicy] = {}
    for p, leaf in flatten_with_path(params):
        pol = plan.policy_for(p, leaf)
        if not pol.is_digital:
            analog[p] = leaf
            policies[p] = pol
    digital = tree_map_with_path(
        lambda p, leaf: None if p in analog else leaf, params)
    return digital, analog, policies


# ---------------------------------------------------------------------------
# resolved policies as JSON (the JAX package's checkpoint manifest form)
# ---------------------------------------------------------------------------


def policy_to_json(pol: TilePolicy) -> dict:
    if pol.is_digital:
        return {"name": pol.name or "digital", "digital": True}
    d = dataclasses.asdict(pol.tile)
    d["state_dtype"] = dtype_name(pol.tile.state_dtype)
    return {"name": pol.name, "tag": pol.tag, "tile": d}


def policy_from_json(d: dict) -> TilePolicy:
    if d.get("digital"):
        return DIGITAL
    t = dict(d["tile"])
    t["device_p"] = DeviceConfig(**t["device_p"])
    t["device_w"] = DeviceConfig(**t["device_w"])
    t["state_dtype"] = getattr(torch, t["state_dtype"])
    return TilePolicy(tile=TileConfig(**t), name=d.get("name", ""))


# ---------------------------------------------------------------------------
# legacy (TileConfig, analog_filter) shim
# ---------------------------------------------------------------------------

_LEGACY_WARNED = False


def _reset_legacy_warning() -> None:
    """Test hook: re-arm the one-time deprecation warning."""
    global _LEGACY_WARNED
    _LEGACY_WARNED = False


def legacy_plan(tile: TileConfig, analog_filter) -> AnalogPlan:
    """Map the deprecated ``(cfg.tile, analog_filter)`` pair onto a one-rule
    plan, warning once per process."""
    global _LEGACY_WARNED
    if not _LEGACY_WARNED:
        _LEGACY_WARNED = True
        warnings.warn(
            "AnalogTrainer(cfg, analog_filter=...) with a single global "
            "TileConfig is deprecated; pass plan=repro_torch.api.AnalogPlan.of("
            "(pattern, TilePolicy), ...) instead",
            DeprecationWarning, stacklevel=3)
    return AnalogPlan.of((analog_filter, TilePolicy(tile=tile)),
                         analog_min_ndim=0)
