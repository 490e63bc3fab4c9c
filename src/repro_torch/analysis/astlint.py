"""AST linter for the port's torch pitfalls (pass 2 of ``check_graphs``).

Port of the JAX package's ``analysis/astlint.py``: its rules translated to
torch, plus one of the port's own. Each targets a bug class that type
checkers and generic linters miss because the code is valid Python; it
just does the wrong thing on the card or breaks the port's bit parity:

``host-rng``
    ``np.random.*`` / stdlib ``random.*`` calls, and torch's process-wide
    generator: ``torch.manual_seed``, ``torch.rand*`` / ``randn*`` /
    ``randint*`` / ``randperm`` / ``bernoulli`` / ``normal`` /
    ``multinomial`` / ``poisson``, or an in-place sampler
    (``Tensor.uniform_`` ...) without ``generator=``. The port draws every
    random bit from a threaded key (``repro_torch.prng``); a global
    generator gives draws no key reproduces. Allowed under
    ``repro_torch/data/`` (host-side corpus synthesis).
``prngkey-reuse``
    The same ``prng.PRNGKey(<literal>)`` seed constructed at two sites in
    one module: the streams are identical, so "independent" noise is
    perfectly correlated.
``host-sync``
    Device-to-host reads: ``.item()`` anywhere; ``.tolist()``, ``.cpu()``,
    ``.numpy()`` and ``float()`` / ``int()`` / ``bool()`` of a ``torch.*``
    call inside the hot packages (``core``, ``kernels``, ``models``). Each
    one waits for the card and stalls the launch queue (the JAX rule is
    ``tracer-sync``).
``scalar-division``
    A tensor divided by a float literal, or a float literal divided by a
    tensor, in ``core`` and ``kernels``: torch's CUDA division by a scalar
    multiplies by its reciprocal (and ``c / t`` is ``t.reciprocal() * c``),
    which rounds differently from the true division the kernels and the
    JAX package do (``kernels.ref.div``). A power-of-two literal is exact
    either way and is not flagged.
``mutable-default-config``
    A mutable default (``[]`` / ``{}`` / ``set()`` or a ``default_factory``
    of list/dict/set) on a *static config* dataclass, one that is frozen
    or named ``*Config``: configs are hashed and shared; a mutable field
    either breaks hashing or is mutated under every holder.
``module-level-torch``
    A call at module scope that makes a tensor (``torch.tensor``,
    ``torch.zeros``, ...) or touches CUDA (``torch.cuda.*``): device work
    as an import side effect (the tests import every module on a machine
    with no card). Constants belong inside functions or as Python data.

Escapes, both deliberate host-code markers, not suppressions of real
bugs:

* a function whose body contains its own ``import numpy`` is host-side
  post-processing by construction; ``host-sync`` and ``host-rng`` are
  skipped inside it;
* a line containing ``graphlint: allow`` suppresses any finding on it; the
  port's own pragmas give their reason on the same line.

``lint_source`` is pure text -> findings (unit-testable); ``run_lint``
walks a source root.
"""
from __future__ import annotations

import ast
import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

RULES = ("host-rng", "prngkey-reuse", "host-sync", "scalar-division",
         "mutable-default-config", "module-level-torch")

PRAGMA = "graphlint: allow"

# packages where a hidden device->host read is a perf bug, not a wart
HOT_PACKAGES = ("repro_torch/core/", "repro_torch/kernels/",
                "repro_torch/models/")
# packages whose arithmetic is held bit for bit to the kernels and JAX
DIVISION_PACKAGES = ("repro_torch/core/", "repro_torch/kernels/")
# packages allowed to use host RNG (eager, host-side by design)
HOST_RNG_OK = ("repro_torch/data/",)

_MUTABLE_FACTORIES = ("list", "dict", "set")
_TORCH_SAMPLERS = ("manual_seed", "seed", "rand", "rand_like", "randn",
                   "randn_like", "randint", "randint_like", "randperm",
                   "bernoulli", "normal", "multinomial", "poisson")
_TENSOR_SAMPLERS = ("uniform_", "normal_", "bernoulli_", "random_",
                    "exponential_", "geometric_", "cauchy_", "log_normal_")
_HOST_READS = ("tolist", "cpu", "numpy")
_TENSOR_FACTORIES = (
    "tensor", "as_tensor", "from_numpy", "zeros", "ones", "empty", "full",
    "arange", "linspace", "logspace", "eye", "zeros_like", "ones_like",
    "empty_like", "full_like", "empty_strided", "stack", "cat") \
    + _TORCH_SAMPLERS


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    rule: str
    message: str

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name of an attribute/name chain ('np.random.normal'), or
    None for anything fancier (calls, subscripts)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _has_local_numpy_import(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Import):
            if any(a.name in ("numpy", "numpy.random") for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "numpy":
                return True
    return False


class _Aliases:
    """What do 'np', 'torch', 'random', 'prng'... mean in this module?"""

    def __init__(self, tree: ast.Module):
        self.numpy: set = set()
        self.torch: set = set()
        self.std_random: set = set()
        self.prngkey: set = set()      # names that ARE PRNGKey
        self.prng: set = set()         # names that are the port's prng
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    name = a.asname or a.name.split(".")[0]
                    if a.name == "numpy":
                        self.numpy.add(name)
                    elif a.name == "torch":
                        self.torch.add(name)
                    elif a.name == "random":
                        self.std_random.add(name)
                    elif a.name == "repro_torch.prng":
                        self.prng.add(a.asname or "repro_torch.prng")
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for a in node.names:
                    name = a.asname or a.name
                    if mod == "numpy" and a.name == "random":
                        self.numpy.add(name)  # "from numpy import random"
                    elif a.name == "prng" and (node.level or mod.startswith(
                            "repro_torch")):
                        self.prng.add(name)
                    elif a.name == "PRNGKey" and mod.split(".")[-1] == "prng":
                        self.prngkey.add(name)


def _is_prngkey_call(call: ast.Call, al: _Aliases) -> bool:
    chain = _attr_chain(call.func)
    if chain is None:
        return False
    if chain in al.prngkey:
        return True
    head, _, tail = chain.rpartition(".")
    return tail == "PRNGKey" and head in al.prng


def _dataclass_meta(cls: ast.ClassDef) -> Tuple[bool, bool]:
    """(is_dataclass, is_frozen) from the decorator list."""
    is_dc = frozen = False
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        chain = _attr_chain(target) or ""
        if chain.split(".")[-1] != "dataclass":
            continue
        is_dc = True
        if isinstance(dec, ast.Call):
            for kw in dec.keywords:
                if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
                    frozen = frozen or bool(kw.value.value)
    return is_dc, frozen


def _mutable_default(value: ast.AST) -> Optional[str]:
    """Describe a mutable default expression, or None if it's fine."""
    if isinstance(value, (ast.List, ast.Dict, ast.Set)):
        return f"literal {type(value).__name__.lower()} default"
    if isinstance(value, ast.Call):
        chain = _attr_chain(value.func) or ""
        if chain.split(".")[-1] in _MUTABLE_FACTORIES and not value.args:
            return f"{chain}() default"
        if chain.split(".")[-1] == "field":
            for kw in value.keywords:
                if kw.arg != "default_factory":
                    continue
                f = kw.value
                fname = _attr_chain(f) or ""
                if fname.split(".")[-1] in _MUTABLE_FACTORIES:
                    return f"default_factory={fname}"
                if isinstance(f, ast.Lambda) and _mutable_default(f.body):
                    return "default_factory=lambda returning a mutable"
    return None


def _float_literal(node: ast.AST) -> Optional[float]:
    """The value of a float literal (``2.5``, ``-2.5``), else None."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub,
                                                              ast.UAdd)):
        v = _float_literal(node.operand)
        return None if v is None else (-v if isinstance(node.op, ast.USub)
                                       else v)
    if isinstance(node, ast.Constant) and isinstance(node.value, float):
        return node.value
    return None


def _power_of_two(v: float) -> bool:
    if v == 0 or not math.isfinite(v):
        return False
    m, _ = math.frexp(abs(v))
    return m == 0.5


def _is_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp):
        return _is_literal(node.operand)
    return isinstance(node, ast.Constant)


def lint_source(source: str, path: str) -> List[LintFinding]:
    """Lint one module's source text. ``path`` is repo-relative and is
    used both for reporting and for package-scoped rules."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [LintFinding(path, e.lineno or 0, "parse-error", str(e.msg))]

    lines = source.splitlines()
    al = _Aliases(tree)
    norm = path.replace(os.sep, "/")
    hot = any(p in norm for p in HOT_PACKAGES)
    exact = any(p in norm for p in DIVISION_PACKAGES)
    rng_ok = any(p in norm for p in HOST_RNG_OK)
    findings: List[LintFinding] = []

    def emit(node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if 0 < line <= len(lines) and PRAGMA in lines[line - 1]:
            return
        findings.append(LintFinding(path, line, rule, message))

    # --- function bodies marked host-side by a local numpy import -------
    host_nodes = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and _has_local_numpy_import(fn):
            host_nodes.update(id(n) for n in ast.walk(fn))

    rng_msg = ("is host RNG: the draw comes from a process-wide generator, "
               "not the threaded key (use repro_torch.prng with a key)")

    # --- per-node rules -------------------------------------------------
    prng_seeds: Dict[object, int] = {}  # literal seed -> first lineno
    for node in ast.walk(tree):
        if exact and isinstance(node, ast.BinOp) \
                and isinstance(node.op, ast.Div):
            for lit, other in ((node.right, node.left),
                               (node.left, node.right)):
                v = _float_literal(lit)
                if v is not None and not _is_literal(other) \
                        and not _power_of_two(v):
                    emit(node, "scalar-division",
                         f"division by the float literal {v!r}: torch's "
                         "CUDA division by a scalar multiplies by its "
                         "reciprocal (use kernels.ref.div, or a power of "
                         "two)")
                    break
        if not isinstance(node, ast.Call):
            continue
        in_host_fn = id(node) in host_nodes
        chain = _attr_chain(node.func) or ""
        parts = chain.split(".")
        kws = {kw.arg for kw in node.keywords}

        # host-rng
        if not in_host_fn and not rng_ok:
            if len(parts) >= 2 and parts[0] in al.numpy \
                    and parts[1] == "random":
                emit(node, "host-rng", f"{chain}() {rng_msg}")
            elif len(parts) == 2 and parts[0] in al.std_random:
                emit(node, "host-rng", f"{chain}() {rng_msg}")
            elif parts[0] in al.torch and parts[-1] in _TORCH_SAMPLERS \
                    and (len(parts) == 2 or parts[1] == "cuda") \
                    and "generator" not in kws:
                emit(node, "host-rng", f"{chain}() {rng_msg}")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _TENSOR_SAMPLERS \
                    and "generator" not in kws:
                emit(node, "host-rng", f".{node.func.attr}() {rng_msg}")

        # prngkey-reuse: same literal seed at two sites
        if _is_prngkey_call(node, al) and node.args \
                and isinstance(node.args[0], ast.Constant):
            seed = node.args[0].value
            if seed in prng_seeds:
                emit(node, "prngkey-reuse",
                     f"PRNGKey({seed!r}) already constructed at line "
                     f"{prng_seeds[seed]}: identical seeds give identical "
                     "streams (split one key instead)")
            else:
                prng_seeds[seed] = node.lineno

        # host-sync
        if not in_host_fn and isinstance(node.func, ast.Attribute) \
                and not node.args:
            attr = node.func.attr
            if attr == "item":
                emit(node, "host-sync",
                     ".item() waits for the card and returns a Python "
                     "scalar: it stalls the launch queue")
            elif hot and attr in _HOST_READS:
                emit(node, "host-sync",
                     f".{attr}() in a hot package copies a tensor to the "
                     "host and waits for the card (keep it on the device, "
                     "or mark the function host-side with a local "
                     "`import numpy`)")
        if not in_host_fn and hot and isinstance(node.func, ast.Name) \
                and node.func.id in ("float", "int", "bool") \
                and node.args and isinstance(node.args[0], ast.Call):
            inner = _attr_chain(node.args[0].func) or ""
            if inner.split(".")[0] in al.torch:
                emit(node, "host-sync",
                     f"{node.func.id}({inner}(...)) reads the result to the "
                     "host (keep it a tensor, or compute with Python "
                     "scalars)")

    # --- mutable-default-config ----------------------------------------
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        is_dc, frozen = _dataclass_meta(node)
        if not is_dc or not (frozen or node.name.endswith("Config")):
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                why = _mutable_default(stmt.value)
                if why:
                    target = getattr(stmt.target, "id", "<field>")
                    emit(stmt, "mutable-default-config",
                         f"static config {node.name}.{target} has a mutable "
                         f"default ({why}): unhashable, and shared by every "
                         "holder (use a tuple / frozen value)")

    # --- module-level-torch ---------------------------------------------
    def scan_toplevel(body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.If, ast.Try)):
                for sub in ast.iter_child_nodes(stmt):
                    if isinstance(sub, ast.stmt):
                        scan_toplevel([sub])
                continue
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                parts = (_attr_chain(node.func) or "").split(".")
                if parts[0] not in al.torch or len(parts) < 2:
                    continue
                if parts[1] == "cuda" or (len(parts) == 2 and
                                          parts[1] in _TENSOR_FACTORIES):
                    emit(node, "module-level-torch",
                         f"{'.'.join(parts)}() at module scope makes a "
                         "tensor or touches CUDA at import time (move it "
                         "inside the function that needs it)")

    scan_toplevel(tree.body)

    return findings


def run_lint(root: str) -> List[LintFinding]:
    """Lint every ``*.py`` under ``root`` (deterministic order)."""
    findings: List[LintFinding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            full = os.path.join(dirpath, fname)
            rel = os.path.relpath(full, os.path.dirname(root.rstrip("/")))
            with open(full, encoding="utf-8") as f:
                findings.extend(lint_source(f.read(), rel))
    return findings
