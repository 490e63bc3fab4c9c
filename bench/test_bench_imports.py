"""What the benchmark loads: no JAX, nothing of the JAX package, and a
reference that loads nothing of the port.

Each check runs in a fresh interpreter, since the test process itself has
JAX loaded by other test files.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

PROBE = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
import importlib
from pathlib import Path
for name in {modules!r}:
    importlib.import_module(name)
from bench import run
for kind in ("drivers", "metrics", "counts"):
    for f in sorted(Path({root!r}, "bench", kind).glob("*.py")):
        run.load(f)
files = [getattr(m, "__file__", None) or "" for m in list(sys.modules.values())]
print(json.dumps({{"top": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "files": files}}))
"""


def _loaded(modules):
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT),
                        modules=list(modules))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax_and_no_jax_package():
    got = _loaded(["bench.run", "bench.drivers.train", "bench.control",
                   "bench.reference.follow", "repro_torch.launch.train",
                   "repro_torch.data"])
    assert not set(got["top"]) & set(FORBIDDEN), got["top"]
    root_benchmarks = str(ROOT / "benchmarks") + os.sep
    assert not [f for f in got["files"] if f.startswith(root_benchmarks)]


def test_reference_loads_nothing_of_the_port():
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT),
                        modules=["bench.reference.follow",
                                 "bench.reference.lm", "bench.reference.rng",
                                 "bench.checks", "bench.weights",
                                 "bench.generate"])
    # without the run's loaders: the reference and what it reads alone
    code = code.split("from bench import run")[0] + (
        "print(json.dumps({'top': sorted({m.split('.')[0] "
        "for m in sys.modules}), 'files': []}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1])["top"])
    assert "repro_torch" not in top and not top & set(FORBIDDEN), top


def test_run_without_a_card_exits_non_zero_and_prints_nothing():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "qwen2-0.5b.train.b16s1024", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=240,
        env=env, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
