"""repro_torch.api — the user-facing training facade (port of ``repro.api``).

    from repro_torch.api import (AnalogPlan, AnalogTrainer, TilePolicy,
                                 DIGITAL, RERAM_HFO2_RIDER, ECRAM_ERIDER,
                                 lm_plan)

Rules are matched against parameter tree paths in order — the FIRST match
wins — as globs (``**`` crosses ``/``), ``re:``-prefixed regexes, or
``(path, leaf) -> bool`` predicates. ``lm_plan`` prepends the standard
digital exclusions (embeddings / vocab heads / positional tables).
"""
from __future__ import annotations

from .configs.base import DIGITAL_PATH_PATTERNS
from .core.device import PRESETS, DeviceConfig  # noqa: F401
from .core.plan import (  # noqa: F401
    DIGITAL, AnalogPlan, TilePolicy, plan_partition, policy_from_json,
    policy_to_json)
from .core.tile import TileConfig  # noqa: F401
from .core.trainer import AnalogTrainer, TrainerConfig  # noqa: F401

#: Few-state HfO2 ReRAM (hardest preset) under RIDER (Alg. 2).
RERAM_HFO2_RIDER = TilePolicy.of("rider", "reram_hfo2", name="reram-hfo2-rider")
#: Few-state HfO2 ReRAM under E-RIDER (Alg. 3, the headline method).
RERAM_HFO2_ERIDER = TilePolicy.of("erider", "reram_hfo2", name="reram-hfo2-erider")
#: ReRAM-OM preset under RIDER.
RERAM_OM_RIDER = TilePolicy.of("rider", "reram_om", name="reram-om-rider")
#: ReRAM-OM preset under E-RIDER.
RERAM_OM_ERIDER = TilePolicy.of("erider", "reram_om", name="reram-om-erider")
#: ECRAM-style device (~1000 states) under E-RIDER.
ECRAM_ERIDER = TilePolicy.of("erider", "ecram", name="ecram-erider")
#: ECRAM-style device under residual learning + ZS (two-stage, Alg. 4).
ECRAM_RESIDUAL = TilePolicy.of("residual", "ecram", name="ecram-residual")
#: High-precision softbounds device under TT-v2.
SOFTBOUNDS_TTV2 = TilePolicy.of("ttv2", "softbounds_2000", name="softbounds-ttv2")
#: Idealized symmetric device under plain analog SGD (reference).
IDEAL_SGD = TilePolicy.of("sgd", "ideal", name="ideal-sgd")


def lm_plan(*rules, default=DIGITAL, analog_min_ndim: int = 2) -> AnalogPlan:
    """Standard LM plan: embeddings / vocab heads / positional tables stay
    digital, then ``rules`` apply in order."""
    digital_rules = tuple(
        (f"re:(?i){pat}", DIGITAL) for pat in DIGITAL_PATH_PATTERNS)
    return AnalogPlan.of(*digital_rules, *rules, default=default,
                         analog_min_ndim=analog_min_ndim)


def plan_from_spec(spec: str, make_tile_cfg) -> AnalogPlan:
    """CLI ``--algorithm`` value -> lm_plan: one algorithm name, or
    comma-separated ``pattern=algorithm`` rules (globs, ``re:`` regexes or
    bare substrings); ``digital`` is a valid algorithm."""

    def policy(algo: str) -> TilePolicy:
        if algo == "digital":
            return DIGITAL
        return TilePolicy(make_tile_cfg(algo), name=algo)

    if "=" not in spec:
        return lm_plan(("**", policy(spec.strip())))
    rules = []
    for part in spec.split(","):
        pat, _, algo = (s.strip() for s in part.partition("="))
        if not any(ch in pat for ch in "*?") and not pat.startswith("re:"):
            pat = "re:" + pat  # bare name -> substring match
        rules.append((pat, policy(algo)))
    return lm_plan(*rules)
