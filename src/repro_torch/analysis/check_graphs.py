"""Static-analysis gate of the port: graph contracts + AST lint, diffed
against a checked-in baseline.

Port of the JAX package's ``tools/check_graphs.py``, with the same modes,
report schema and diff semantics, against ``GRAPH_BASELINE_torch.json`` at
the repository root. The contracts trace each entrypoint once on ``meta``
(``analysis/graph_contracts.py``; ``--device cuda`` traces on the card).

  python -m repro_torch.analysis.check_graphs               # both passes
  python -m repro_torch.analysis.check_graphs --check       # + the diff
  python -m repro_torch.analysis.check_graphs --update-baseline
  python -m repro_torch.analysis.check_graphs --mutate restack \\
      --only train_step_fused                                # the gate bites
  python -m repro_torch.analysis.check_graphs --lint-only   # lint alone

``--check`` fails when:

  * any contract has violations,
  * a registered contract is missing from the baseline (stale baseline:
    rerun ``--update-baseline`` and commit the diff),
  * a baselined contract is no longer registered (coverage shrank),
  * a contract's limits are *looser* than the baselined ones (raised
    ceilings, grown allowlists, disabled checks), or
  * the linter reports a finding not present in the baseline.

``--mutate M`` exits 0 when every contract catches the mutant, 1 when
one escapes.

The JSON report (``--report``) is validated against ``REPORT_SCHEMA``
before writing, so downstream tooling can rely on its shape.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = str(Path(__file__).resolve().parents[3])
SRC = os.path.join(REPO, "src", "repro_torch")
BASELINE = os.path.join(REPO, "GRAPH_BASELINE_torch.json")

SCHEMA_VERSION = 1

REPORT_SCHEMA = {
    "type": "object",
    "required": ["version", "ok", "contracts", "lint"],
    "additionalProperties": False,
    "properties": {
        "version": {"const": SCHEMA_VERSION},
        "ok": {"type": "boolean"},
        "mutant": {"type": ["string", "null"]},
        "device": {"type": "string"},
        "contracts": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["name", "ok", "violations", "stats", "limits"],
                "additionalProperties": False,
                "properties": {
                    "name": {"type": "string"},
                    "ok": {"type": "boolean"},
                    "violations": {
                        "type": "array",
                        "items": {
                            "type": "object",
                            "required": ["rule", "detail"],
                            "additionalProperties": False,
                            "properties": {"rule": {"type": "string"},
                                           "detail": {"type": "string"}},
                        },
                    },
                    "stats": {"type": "object"},
                    "limits": {"type": "object"},
                },
            },
        },
        "lint": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["path", "line", "rule", "message"],
                "additionalProperties": False,
                "properties": {
                    "path": {"type": "string"},
                    "line": {"type": "integer", "minimum": 0},
                    "rule": {"type": "string"},
                    "message": {"type": "string"},
                },
            },
        },
        "baseline_failures": {"type": "array", "items": {"type": "string"}},
    },
}


def build_report(only=None, mutant=None, lint_only=False, device="meta"):
    from . import run_lint

    contracts = []
    if not lint_only:
        from . import graph_contracts as gc

        names = sorted(gc.CONTRACTS) if only is None else list(only)
        for name in names:
            if name not in gc.CONTRACTS:
                raise SystemExit(f"unknown contract {name!r}; have: "
                                 f"{', '.join(sorted(gc.CONTRACTS))}")
            res = gc.run_contract(name, mutant=mutant, device=device)
            entry = res.to_json()
            entry["limits"] = gc.CONTRACTS[name].limits_json()
            contracts.append(entry)

    lint = [f.to_json() for f in run_lint(SRC)]
    return {
        "version": SCHEMA_VERSION,
        "ok": all(c["ok"] for c in contracts) and not lint,
        "mutant": mutant,
        "device": device,
        "contracts": contracts,
        "lint": lint,
    }


def diff_baseline(report, baseline) -> list:
    """Failure strings for --check (empty = gate passes)."""
    from . import graph_contracts as gc
    from .contracts import loosened

    failures = []
    base_contracts = baseline.get("contracts", {})
    seen = set()
    for entry in report["contracts"]:
        name = entry["name"]
        seen.add(name)
        for v in entry["violations"]:
            failures.append(f"{name}: [{v['rule']}] {v['detail']}")
        if name not in base_contracts:
            failures.append(
                f"{name}: not in baseline (new contract? run "
                "--update-baseline and commit GRAPH_BASELINE_torch.json)")
            continue
        loose = loosened(gc.CONTRACTS[name],
                         base_contracts[name].get("limits", {}))
        for item in loose:
            failures.append(f"{name}: contract loosened: {item}")
    for name in base_contracts:
        if name not in seen:
            failures.append(
                f"{name}: in baseline but no longer registered "
                "(contract coverage shrank)")

    base_lint = {(f["path"], f["rule"], f["message"])
                 for f in baseline.get("lint", [])}
    for f in report["lint"]:
        if (f["path"], f["rule"], f["message"]) not in base_lint:
            failures.append(
                f"lint {f['path']}:{f['line']}: [{f['rule']}] {f['message']}")
    return failures


def baseline_from_report(report) -> dict:
    return {
        "version": SCHEMA_VERSION,
        "contracts": {
            c["name"]: {"limits": c["limits"], "stats": c["stats"]}
            for c in report["contracts"]
        },
        "lint": list(report["lint"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="diff against the baseline; nonzero on drift")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current run")
    ap.add_argument("--baseline", default=BASELINE)
    ap.add_argument("--report", default="", metavar="PATH",
                    help="write the schema-validated JSON report here")
    ap.add_argument("--only", action="append", metavar="NAME",
                    help="run only this contract (repeatable)")
    ap.add_argument("--lint-only", action="store_true",
                    help="AST lint pass only (no tracing)")
    ap.add_argument("--mutate", choices=("restack", "host_transfer", "f64",
                                         "no_donate"),
                    help="plant a defect in every built entrypoint; the "
                    "run must FAIL (mutation-testing the gate)")
    ap.add_argument("--device", default="meta",
                    help="where the entrypoints run: meta (default) or cuda")
    args = ap.parse_args(argv)

    report = build_report(only=args.only, mutant=args.mutate,
                          lint_only=args.lint_only, device=args.device)

    failures = []
    if args.check:
        if args.mutate:
            raise SystemExit("--check and --mutate are mutually exclusive")
        try:
            with open(args.baseline) as f:
                baseline = json.load(f)
        except FileNotFoundError:
            baseline = {"version": SCHEMA_VERSION, "contracts": {},
                        "lint": []}
        failures = diff_baseline(report, baseline)
        report["baseline_failures"] = failures
        report["ok"] = report["ok"] and not failures

    from ..serving.schema import validate
    validate(report, REPORT_SCHEMA)

    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)

    for entry in report["contracts"]:
        mark = "ok " if entry["ok"] else "FAIL"
        stats = entry["stats"]
        print(f"[{mark}] {entry['name']}: "
              f"ops={stats['ops']} "
              f"restacks={stats['restacks']} "
              f"aliased={stats['aliased_outputs']} "
              f"uploads={stats['uploads']} "
              f"host_reads={stats['host_transfer_ops']} "
              f"hbm={stats['hbm_bytes']:.0f}B "
              f"dtypes={','.join(stats['dtypes'])}")
        for v in entry["violations"]:
            print(f"       [{v['rule']}] {v['detail']}")
    if report["lint"]:
        print(f"{len(report['lint'])} lint finding(s):")
        for f in report["lint"]:
            print(f"  {f['path']}:{f['line']}: [{f['rule']}] {f['message']}")
    else:
        print("lint: clean")
    for msg in failures:
        print(f"BASELINE: {msg}")

    if args.update_baseline:
        if args.mutate:
            raise SystemExit("refusing to baseline a mutated run")
        if args.only or args.lint_only:
            raise SystemExit("baseline updates must run every contract")
        if not report["ok"]:
            raise SystemExit("refusing to baseline a failing run")
        with open(args.baseline, "w") as f:
            json.dump(baseline_from_report(report), f, indent=2,
                      sort_keys=True)
            f.write("\n")
        print(f"baseline written: {args.baseline}")

    if args.mutate:
        bad = [c["name"] for c in report["contracts"] if c["ok"]]
        if bad:
            print(f"MUTATION ESCAPED ({args.mutate}): {', '.join(bad)}")
            return 1
        print(f"mutation '{args.mutate}' caught by every contract")
        return 0

    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
