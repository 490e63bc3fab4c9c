"""Sharding-rule templates of parameter paths.

Only the part tile grouping needs: group names carry the rule template tag
of their member weights (``core.tile.group_tiles``), so the port keeps the
JAX package's ``PARAM_RULES`` table and its two mesh-independent helpers.
Meshes, specs and sharded calls come with the distributed slice of the
port.
"""
from __future__ import annotations

import re
from typing import Tuple

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


def rule_template(path: str, ndim: int) -> Tuple:
    """Spec template of a parameter path, normalized to ``ndim`` dims
    (leading dims pad with None; body-scan params gain a leading None)."""
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
