"""The port's AST linter against the JAX package's: every case of
``tests/test_astlint.py`` replayed, the rules that carry over giving the
same (rule, line) under both linters on the same source, the torch-only
rules on their own cases, and ``src/repro_torch`` clean."""
import os

import pytest

from repro_torch.analysis import run_lint
from repro_torch.analysis.astlint import RULES, lint_source

jlint = pytest.importorskip("repro.analysis.astlint")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src", "repro_torch")

HOT = "src/repro_torch/core/fake.py"
COLD = "src/repro_torch/launch/fake.py"
DATA = "src/repro_torch/data/synthetic.py"
# the JAX rule names the port renamed
SAME_RULE = {"tracer-sync": "host-sync", "module-level-jnp":
             "module-level-torch"}


def _rules(src, path=HOT):
    return [f.rule for f in lint_source(src, path)]


def _pairs(findings):
    return [(SAME_RULE.get(f.rule, f.rule), f.line) for f in findings]


# ---------------------------------------------------------------------------
# the rules that carry over: one snippet, both linters, same (rule, line)
# ---------------------------------------------------------------------------

SHARED = {
    "np_random": ("import numpy as np\ndef f(): return np.random.normal()\n",
                  HOT, [("host-rng", 2)]),
    "stdlib_random": ("import random\ndef f(): return random.gauss(0, 1)\n",
                      HOT, [("host-rng", 2)]),
    "host_rng_in_data": (
        "import numpy as np\ndef f(): return np.random.normal()\n", DATA, []),
    "item_everywhere": ("def f(x): return x.item()\n", COLD,
                        [("host-sync", 1)]),
    "local_numpy_escape": ("def f(x):\n    import numpy as np\n"
                           "    return float(np.asarray(x).sum().item())\n",
                           HOT, []),
    "pragma": ("def f(x): return x.item()  # graphlint: allow\n", HOT, []),
    "mutable_frozen": ("import dataclasses\n"
                       "@dataclasses.dataclass(frozen=True)\n"
                       "class Thing:\n"
                       "    xs: tuple = ()\n"
                       "    ys: list = dataclasses.field(default_factory=list)\n",
                       HOT, [("mutable-default-config", 5)]),
    "config_suffix": ("from dataclasses import dataclass, field\n"
                      "@dataclass\n"
                      "class RunConfig:\n"
                      "    opts: dict = field(default_factory=dict)\n",
                      HOT, [("mutable-default-config", 4)]),
    "plain_dataclass": ("from dataclasses import dataclass, field\n"
                        "@dataclass\n"
                        "class Accum:\n"
                        "    vals: list = field(default_factory=list)\n",
                        HOT, []),
    "tuple_factory": ("import dataclasses\n"
                      "@dataclasses.dataclass(frozen=True)\n"
                      "class FooConfig:\n"
                      "    xs: tuple = dataclasses.field(default_factory=tuple)\n",
                      HOT, []),
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_rule_same_finding_as_jax(case):
    src, path, want = SHARED[case]
    jpath = path.replace("repro_torch", "repro")
    assert _pairs(lint_source(src, path)) == want
    assert _pairs(jlint.lint_source(src, jpath)) == want


# ---------------------------------------------------------------------------
# the JAX-only cases, translated to torch
# ---------------------------------------------------------------------------


def test_threaded_key_not_flagged():
    src = ("from repro_torch import prng\n"
           "def f(key): return prng.normal(key, (3,), 'cpu')\n")
    assert _rules(src) == []


def test_duplicate_literal_seed_flagged():
    src = ("from repro_torch import prng\n"
           "def f(): return prng.PRNGKey(0)\n"
           "def g(): return prng.PRNGKey(0)\n")
    fs = lint_source(src, HOT)
    assert [f.rule for f in fs] == ["prngkey-reuse"]
    assert fs[0].line == 3
    jsrc = src.replace("from repro_torch import prng", "import jax") \
        .replace("prng.PRNGKey", "jax.random.PRNGKey")
    assert [(f.rule, f.line) for f in jlint.lint_source(jsrc, HOT)] \
        == [("prngkey-reuse", 3)]


def test_distinct_seeds_and_nonliteral_ok():
    src = ("from .. import prng\n"
           "def f(): return prng.PRNGKey(0)\n"
           "def g(seed): return prng.PRNGKey(seed)\n"
           "def h(): return prng.PRNGKey(1)\n")
    assert _rules(src) == []


def test_from_import_prngkey_detected():
    src = ("from repro_torch.prng import PRNGKey\n"
           "a = PRNGKey(7)\nb = PRNGKey(7)\n")
    assert _rules(src) == ["prngkey-reuse"]


def test_host_reads_flagged_only_in_hot_packages():
    for call in ("x.cpu()", "x.tolist()", "x.numpy()"):
        src = f"def f(x): return {call}\n"
        assert _rules(src, HOT) == ["host-sync"], call
        assert _rules(src, COLD) == [], call


def test_float_of_torch_call_flagged():
    src = "import torch\ndef f(x): return float(torch.sum(x))\n"
    assert _rules(src) == ["host-sync"]
    assert _rules(src, COLD) == []
    # float() of plain python is fine
    assert _rules("def f(x): return float(len(x))\n") == []


def test_module_level_torch_call_flagged():
    assert _rules("import torch\nTABLE = torch.arange(16)\n") \
        == ["module-level-torch"]
    assert _rules("import torch\nOK = torch.cuda.is_available()\n") \
        == ["module-level-torch"]


def test_torch_attribute_access_at_module_level_ok():
    assert _rules("import torch\nDTYPE = torch.float32\n") == []
    assert _rules("import torch\nDEV = torch.device('cpu')\n") == []


def test_torch_inside_function_ok():
    assert _rules("import torch\ndef f(): return torch.arange(16)\n") == []


# ---------------------------------------------------------------------------
# torch-only rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("call", [
    "torch.manual_seed(0)", "torch.rand(3)", "torch.randn(2, 2)",
    "torch.randint(0, 5, (3,))", "torch.randperm(4)",
    "torch.bernoulli(x)", "torch.normal(x, 1.0)",
    "torch.multinomial(x, 1)", "x.uniform_()", "x.normal_(0, 1)"])
def test_global_generator_flagged(call):
    src = f"import torch\ndef f(x): return {call}\n"
    assert _rules(src) == ["host-rng"], call
    assert _rules(src, DATA) == [], call


def test_explicit_generator_not_flagged():
    src = ("import torch\n"
           "def f(x, g): return torch.rand(3, generator=g) + "
           "x.uniform_(generator=g)\n")
    assert _rules(src) == []


@pytest.mark.parametrize("expr, flagged", [
    ("x / 3.0", True), ("3.0 / x", True), ("x / -0.1", True),
    ("x / 2.0", False), ("1.0 / x", False), ("x / 0.25", False),
    ("1.0 / 4294967296.0", False), ("x / y", False), ("x / 3", False)])
def test_scalar_division(expr, flagged):
    src = f"def f(x, y): return {expr}\n"
    assert _rules(src) == (["scalar-division"] if flagged else []), expr
    assert _rules(src, "src/repro_torch/kernels/fake.py") \
        == (["scalar-division"] if flagged else []), expr
    # outside core/ and kernels/ the arithmetic is not held to the kernels
    assert _rules(src, "src/repro_torch/models/fake.py") == [], expr


def test_rule_names():
    assert set(RULES) == {"host-rng", "prngkey-reuse", "host-sync",
                          "scalar-division", "mutable-default-config",
                          "module-level-torch"}
    assert {SAME_RULE.get(r, r) for r in jlint.RULES} <= set(RULES)


# ---------------------------------------------------------------------------
# whole tree
# ---------------------------------------------------------------------------


def test_port_source_is_clean():
    findings = run_lint(SRC)
    assert findings == [], "\n".join(str(f) for f in findings)


def test_every_pragma_gives_its_reason():
    """Each ``graphlint: allow`` in the port carries a reason on its line."""
    for d, _, files in os.walk(SRC):
        for name in files:
            if not name.endswith(".py") or name == "astlint.py":
                continue
            with open(os.path.join(d, name)) as f:
                for i, line in enumerate(f, 1):
                    if "graphlint: allow" in line:
                        tail = line.split("graphlint: allow", 1)[1].strip()
                        assert tail.startswith("(") and len(tail) > 4, \
                            f"{name}:{i}"


def test_syntax_error_reported_not_raised():
    fs = lint_source("def f(:\n", HOT)
    assert len(fs) == 1 and fs[0].rule == "parse-error"
