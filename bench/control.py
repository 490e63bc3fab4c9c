"""The readings that set the limits of ``bench.checks``, on the card.

  python3 bench/control.py --workload <cell> --seeds 11,12,13

For each seed, at the cell's own sizes, the plain reference runs the
cell's first two steps three times: as it is; as the control, computed
in float8 e4m3, the precision below the configuration's bfloat16
(``precision="fp8"``); and with the fault "half of the batch left out, the
mean taken over the rest" planted in it (``rows``). It prints one JSON
line a seed with the control's and the fault's numbers against the
reference's: the upper readings of each limit. A state left unchanged
reads 1 on ``first_gap`` and ``change_gap`` by their definition and needs
no run. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(config, mix, seed: int, device) -> dict:
    from bench import checks
    from bench.reference import follow

    analog = {p for g in config["tiles"]["groups"] for p in g}
    ref = follow.follow(config, mix, seed, device)
    ctl = follow.follow(config, mix, seed, device, precision="fp8")
    half = follow.follow(config, mix, seed, device, rows=mix["batch"] // 2)
    return {"seed": seed, "control": checks.gaps(ctl, ref, analog),
            "half_batch": checks.gaps(half, ref, analog),
            "reference_loss": ref["loss"],
            "left_out": sorted(set(ref["grad"])
                               - set(checks.compared_leaves(ref)))}


def main(argv=None) -> int:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((ROOT / "bench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    for seed in (int(s) for s in args.seeds.split(",")):
        line = readings(config, mix, seed, "cuda")
        line["workload"] = args.workload
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
