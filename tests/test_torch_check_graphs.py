"""The port's check_graphs CLI (``python -m repro_torch.analysis
.check_graphs``), replaying ``tests/test_check_graphs.py``: report schema,
baseline diff semantics, lint pass; and the committed
``GRAPH_BASELINE_torch.json`` against the registry."""
import copy
import json
import os
import subprocess
import sys

import pytest

from repro_torch.analysis import check_graphs as cg
from repro_torch.analysis import graph_contracts as gc
from repro_torch.analysis.contracts import loosened
from repro_torch.serving.schema import SchemaError, validate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_report():
    contracts = []
    for name in sorted(gc.CONTRACTS):
        contracts.append({
            "name": name, "ok": True, "violations": [],
            "stats": {"ops": 10, "restacks": 0, "aliased_outputs": 2,
                      "max_copy_bytes": 0, "host_transfer_ops": 0,
                      "uploads": 0, "upload_bytes": 0, "kernel_ops": 0,
                      "dtypes": ["float32"], "hbm_bytes": 1.0,
                      "collective_bytes": 0.0, "flops": 0.0},
            "limits": gc.CONTRACTS[name].limits_json(),
        })
    return {"version": cg.SCHEMA_VERSION, "ok": True, "mutant": None,
            "device": "meta", "contracts": contracts, "lint": []}


def test_report_schema_validates():
    report = _fake_report()
    validate(report, cg.REPORT_SCHEMA)
    bad = copy.deepcopy(report)
    del bad["contracts"][0]["stats"]
    with pytest.raises(SchemaError):
        validate(bad, cg.REPORT_SCHEMA)


def test_report_schema_matches_the_reference():
    """The same shape as the JAX tool's report (plus the device)."""
    spec = pytest.importorskip("importlib.util")
    mod_spec = spec.spec_from_file_location(
        "jax_check_graphs", os.path.join(REPO, "tools", "check_graphs.py"))
    jcg = spec.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(jcg)
    mine, ref = cg.REPORT_SCHEMA, jcg.REPORT_SCHEMA
    assert mine["required"] == ref["required"]
    assert set(mine["properties"]) == set(ref["properties"]) | {"device"}
    for key in ("contracts", "lint"):
        assert mine["properties"][key] == ref["properties"][key]


def test_baseline_roundtrip_passes():
    report = _fake_report()
    baseline = cg.baseline_from_report(report)
    assert cg.diff_baseline(report, baseline) == []


def test_new_violation_fails_check():
    report = _fake_report()
    baseline = cg.baseline_from_report(report)
    report["contracts"][0]["violations"].append(
        {"rule": "restack", "detail": "planted"})
    fails = cg.diff_baseline(report, baseline)
    assert any("restack" in f for f in fails)


def test_missing_and_extra_contracts_fail_check():
    report = _fake_report()
    baseline = cg.baseline_from_report(report)
    baseline["contracts"]["ghost"] = {"limits": {}, "stats": {}}
    fails = cg.diff_baseline(report, baseline)
    assert any("no longer registered" in f for f in fails)
    baseline2 = cg.baseline_from_report(report)
    del baseline2["contracts"][report["contracts"][0]["name"]]
    fails2 = cg.diff_baseline(report, baseline2)
    assert any("not in baseline" in f for f in fails2)


def test_loosened_limit_fails_check():
    report = _fake_report()
    baseline = cg.baseline_from_report(report)
    name = report["contracts"][0]["name"]
    baseline["contracts"][name]["limits"]["max_hbm_bytes"] = 1.0
    fails = cg.diff_baseline(report, baseline)
    assert any("loosened" in f and name in f for f in fails)


def test_new_lint_finding_fails_check():
    report = _fake_report()
    baseline = cg.baseline_from_report(report)
    report["lint"].append({"path": "repro_torch/core/x.py", "line": 3,
                           "rule": "host-sync", "message": "bad"})
    fails = cg.diff_baseline(report, baseline)
    assert any("host-sync" in f for f in fails)


def test_checked_in_baseline_matches_registry():
    """GRAPH_BASELINE_torch.json tracks the CONTRACTS registry: the same
    names, no limit looser than baselined, a clean lint."""
    with open(os.path.join(REPO, "GRAPH_BASELINE_torch.json")) as f:
        baseline = json.load(f)
    assert baseline["version"] == cg.SCHEMA_VERSION
    assert set(baseline["contracts"]) == set(gc.CONTRACTS)
    for name, entry in baseline["contracts"].items():
        assert loosened(gc.CONTRACTS[name], entry["limits"]) == []
        assert entry["limits"] == gc.CONTRACTS[name].limits_json()
    assert baseline["lint"] == []


def test_cli_lint_only_smoke():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.check_graphs",
         "--lint-only"], capture_output=True, text=True, env=env, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "lint: clean" in out.stdout


def test_cli_mutate_only_one_contract(tmp_path):
    """``--mutate M --only N``: the mutant caught, the report validated."""
    report = tmp_path / "r.json"
    assert cg.main(["--mutate", "host_transfer", "--only", "serve_step_lanes",
                    "--report", str(report)]) == 0
    data = json.loads(report.read_text())
    validate(data, cg.REPORT_SCHEMA)
    (entry,) = data["contracts"]
    assert not entry["ok"] and entry["violations"][0]["rule"] \
        == "host-transfer"
