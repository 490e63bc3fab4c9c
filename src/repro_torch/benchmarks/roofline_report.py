"""Aggregate the dry run's JSONs into the dry-run and roofline tables.

Port of the JAX package's ``benchmarks/roofline_report.py``, over the
cells ``repro_torch.launch.dryrun`` writes: the same columns and the same
CSV rows. Every status but "ok" and "skipped" is an error.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.benchmarks.roofline_report [--mesh pod2x16x16]
  PYTHONPATH=src python -m repro_torch.benchmarks.run --only roofline --device cpu
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

STATUSES = ("ok", "skipped")


def load_cells(out_dir: str = "results/dryrun", tag: str = ""):
    cells = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if (r.get("tag") or "") != tag:
            continue
        cells.append(r)
    return cells


def fmt_table(cells, mesh: str = "pod16x16") -> str:
    hdr = ("| arch | shape | status | mem/dev GB | t_comp s | t_mem s | "
           "t_coll s | bottleneck | useful | roofline frac |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in cells:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | skipped ({r['reason'][:40]}…) "
                         "| - | - | - | - | - | - | - |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR | - | - | - | - | - | - | - |")
            continue
        rf = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['memory']['peak_per_device_gb']:.2f} "
            f"| {rf['t_compute']:.3f} | {rf['t_memory']:.3f} | {rf['t_collective']:.3f} "
            f"| {rf['bottleneck']} | {rf['useful_ratio']:.2f} "
            f"| {rf['roofline_fraction']:.4f} |")
    return "\n".join(lines)


def run(quick: bool = True, out_dir: str = "results/dryrun") -> List[str]:
    cells = load_cells(out_dir)
    rows = []
    n = {s: sum(1 for c in cells if c["status"] == s) for s in STATUSES}
    n_err = sum(1 for c in cells if c["status"] not in STATUSES)
    rows.append(f"roofline_cells,0,ok={n['ok']};skipped={n['skipped']};"
                f"errors={n_err}")
    for c in cells:
        if c["status"] != "ok":
            continue
        rf = c["roofline"]
        rows.append(
            f"roofline_{c['arch']}_{c['shape']}_{c['mesh']},0,"
            f"bottleneck={rf['bottleneck']};frac={rf['roofline_fraction']:.4f};"
            f"useful={rf['useful_ratio']:.3f};mem_gb={c['memory']['peak_per_device_gb']}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    print(fmt_table(load_cells(args.dir, args.tag), args.mesh))
