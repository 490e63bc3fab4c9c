"""Benchmark harness — one module per paper table/figure.

Port of the JAX package's ``benchmarks/run.py``. Prints
``name,us_per_call,derived`` CSV rows. The default quick mode runs every
benchmark end to end at reduced scale; ``--full`` runs the paper-scale
sweeps. Runs on the card unless ``--device cpu`` is given; on the card it
first prints the card's name and power limit, with TF32 off in matmuls and
cuDNN (``common.cuda_numerics``).

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--full] [--only fig1,table12]

``roofline`` tabulates the dry run's JSONs under ``results/dryrun``
(``python -m repro_torch.launch.dryrun --all``); it needs no card.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

BENCHES = ("fig1", "fig2", "table12", "fig4", "ablations", "roofline")
# the reference's other row, not ported yet
LATER = {"tile_engine": "ROADMAP item 16b"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    quick = not args.full
    only = set(args.only.split(",")) if args.only else set(BENCHES)
    for name in sorted(only - set(BENCHES)):
        if name in LATER:
            sys.exit(f"{name}: not ported yet ({LATER[name]})")
        sys.exit(f"unknown benchmark {name!r}; choose from {', '.join(BENCHES)}")

    device = args.device
    if device == "cuda":
        from .common import card_line, cuda_numerics

        if not torch.cuda.is_available():
            sys.exit("no CUDA device (pass --device cpu to run on the CPU)")
        cuda_numerics()
        print(f"# card: {card_line()}", flush=True)
    else:
        print("# device: cpu", flush=True)
    print("name,us_per_call,derived")
    t_start = time.time()

    def emit(rows):
        for r in rows:
            print(r, flush=True)

    if "fig1" in only:
        from . import fig1_zs
        emit(fig1_zs.run(quick, device))
    if "fig2" in only:
        from . import fig2_sp_error
        emit(fig2_sp_error.run(quick, device))
    if "table12" in only:
        from . import table12_robustness
        emit(table12_robustness.run(quick, device))
    if "fig4" in only:
        from . import fig4_pulse_cost
        emit(fig4_pulse_cost.run(quick, device))
    if "ablations" in only:
        from . import fig5_table9_10_ablations
        emit(fig5_table9_10_ablations.run(quick, device))
    if "roofline" in only:
        # the dry run's cells (``launch.dryrun`` writes results/dryrun)
        from . import roofline_report
        emit(roofline_report.run(quick))

    print(f"total,{(time.time() - t_start) * 1e6:.0f},benchmarks_done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
