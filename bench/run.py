"""Run one cell of the benchmark once and print its result line.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration file and its traffic mix come from
``BENCHMARK.json``; the mix's ``kind`` names the driver
(``bench/drivers/<kind>.py``); each per-layer metric is read by
``bench/metrics/<name>.py``. With ``--trace 0`` the line's metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics. The
last lines of standard error, and the line's last key ``checks``, give
each number compared with its limit (``bench.checks``).

It exits non-zero and prints no result without enough CUDA devices, when a
JAX module is loaded after the window, or when the run fails.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"


def configure() -> None:
    """The process's environment for a run, set before torch is imported:
    every cache the program or its libraries write stays in the checkout,
    at a fixed path, so the second run of a cell there builds nothing; no
    library loads JAX; the port and the benchmark import from the
    checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

# top-level module names that must never be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(path: Path):
    """The Python file ``path`` under ``bench/`` as a module of its package
    (a file's name may hold '-' and '.', which a module name may not)."""
    package = ".".join(path.resolve().parent.relative_to(ROOT).parts)
    name = f"{package}.{path.stem.replace('-', '_').replace('.', '_')}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_context(spec: dict, workload: str, seed: int, seconds: float,
                 trace: bool, device: str) -> SimpleNamespace:
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return SimpleNamespace(cell=cell, config=config, config_name=conf["name"],
                           mix=mix, seed=seed, seconds=seconds, trace=trace,
                           device=device, t0=T0)


def per_layer(spec: dict, ctx, result: dict) -> dict:
    """{name: {"value", "unit"}} of the cell's per-layer metrics whose
    readers find something to read."""
    rec = dict(result["record"], config=ctx.config, mix=ctx.mix,
               counts=load(BENCH / "counts" / f"{ctx.config_name}.py"))
    out = {}
    for m in spec["per_layer"]:
        value = load(BENCH / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(ctx, spec: dict):
    """Run the cell's driver; returns (the result line as a dict, the
    run's set-up and reference seconds)."""
    from bench import checks

    driver = load(BENCH / "drivers" / f"{ctx.mix['kind']}.py")
    result = driver.run(ctx)
    lim = checks.limits(ctx.cell["name"])
    values = result["values"]
    correct = checks.verdict(values, lim)
    if ctx.trace:
        metrics = per_layer(spec, ctx, result)
    else:
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in result["e2e"].items() if k in units}
    device = {"platform": "gpu", "count": ctx.cell["chips"],
              "memory_peak_bytes": result["peak_bytes"]}
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": device}
    tr = result["record"]["trace"]
    if ctx.trace and tr is not None:
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {n: {"value": values[n] if math.isfinite(values[n])
                          else repr(values[n]), "limit": lim[n]}
                      for n in checks.NAMES}
    return line, result["info"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    configure()
    import torch

    chips = next(w["chips"] for w in spec["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = cell_context(spec, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda")
    line, info = execute(ctx, spec)
    line["device"]["kind"] = torch.cuda.get_device_name(0)
    found = forbidden_modules()
    if found:
        print(f"bench: modules loaded that a run must not load: {found}",
              file=sys.stderr)
        return 3
    print(f"run {json.dumps(info)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
