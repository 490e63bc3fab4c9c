"""The program's spans in one cell's traced steps (``bench/spans.py``).

  python3 bench/span_report.py --workload <cell> --seed <n> \
      [--seconds 10] [--out FILE]

Runs the cell as ``bench/run.py --trace 1`` does, the driver's profiler
recorder extended to reduce the program's own spans too, and prints one
JSON line: the run's line as ``run.py`` prints it (``line``), and
``spans`` (the tables of ``bench.spans.reduce``), ``span_metrics``
(``bench.spans.metrics``: ``fwd_bwd_ms``, ``update_ms``, ``attention_ms``,
``ssm_ms``, ``head_loss_ms``, ``keychain_idle_ms``) and ``coverage`` (the
shares of device time mapped to a launch, owned by the phases and, of
``train/fwd_bwd``, by the model spans). ``--out`` writes the same line to
a file. It exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run  # noqa: E402


def recorder_with_spans():
    """A subclass of the driver's ``trace.Recorder`` whose summary also
    holds ``spans``, ``bench.spans.reduce`` of the same events; the last
    one is kept as the class's ``last``."""
    from bench import spans, trace

    class SpanRecorder(trace.Recorder):
        last = None

        def summary(self, steps):
            out = super().summary(steps)
            out["spans"] = SpanRecorder.last = spans.reduce(
                self.prof.profiler.kineto_results.events(), steps)
            return out

    return SpanRecorder


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    run.configure()
    import torch

    from bench import spans, trace

    if not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 2
    ctx = run.cell_context(spec, args.workload, args.seed, args.seconds,
                           True, "cuda")
    # the driver looks the recorder up on ``bench.trace`` when it traces
    trace.Recorder = recorder = recorder_with_spans()
    line, info = run.execute(ctx, spec)
    line["device"]["kind"] = torch.cuda.get_device_name(0)
    out = {"workload": args.workload, "seed": args.seed, "info": info,
           "line": line}
    sp = recorder.last
    if sp is not None:
        out.update(spans=sp, span_metrics=spans.metrics(sp),
                   coverage=spans.coverage(sp))
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
