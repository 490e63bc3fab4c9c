"""The port's serving telemetry and schemas against the JAX package's.

* Every case of the reference's ``tests/test_serve_latency_logging.py`` and
  ``tests/test_artifacts_manifest.py`` (each parametrized case on its own)
  replayed on ``repro_torch.serving``'s ``telemetry`` and ``schema``: each
  reference test function runs with its module's names bound to the
  port's. The manifest's engine case, which builds the reference's engine
  inside its body, is rewritten on the port's engine.
* The port's schema tables (the log envelope, every event schema, the
  manifest schema, the event list and the schema version) equal the
  reference's.
* A manifest and log lines written by the port validate under
  ``repro.serving.schema``, and the reference's under the port's.
"""
import importlib
import json
import types

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.serving import schema as jschema  # noqa: E402
from repro.serving import telemetry as jtelemetry  # noqa: E402
from repro_torch.serving import schema, telemetry  # noqa: E402

PORT_NAMES = {
    "schema": schema,
    "Telemetry": telemetry.Telemetry,
    "JsonLogger": telemetry.JsonLogger,
    "RequestTimeline": telemetry.RequestTimeline,
    "percentile": telemetry.percentile,
    "summarize": telemetry.summarize,
}
REFS = ("test_serve_latency_logging", "test_artifacts_manifest")
REWRITTEN = {"test_engine_run_writes_manifest_at_shutdown"}


def replay(module_name: str, names: dict) -> dict:
    """The reference test module's namespace with ``names`` rebound, every
    function of the module re-created over that namespace."""
    mod = importlib.import_module(module_name)
    g = dict(vars(mod))
    g.update(names)
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) and v.__module__ == mod.__name__:
            g[k] = types.FunctionType(v.__code__, g, v.__name__,
                                      v.__defaults__, v.__closure__)
    return g


def _cases():
    """(module, test name, parametrize kwargs, case id) of every reference
    case, a parametrized test expanded into its cases."""
    out = []
    for m in REFS:
        mod = importlib.import_module(m)
        for name in sorted(n for n in vars(mod) if n.startswith("test_")):
            if name in REWRITTEN:
                continue
            marks = [mk for mk in getattr(getattr(mod, name), "pytestmark", [])
                     if mk.name == "parametrize"]
            if not marks:
                out.append(pytest.param(m, name, {}, id=name))
                continue
            argnames, values = marks[0].args[:2]
            argnames = [a.strip() for a in argnames.split(",")]
            for i, v in enumerate(values):
                v = v if len(argnames) > 1 else (v,)
                out.append(pytest.param(m, name, dict(zip(argnames, v)),
                                        id=f"{name}[{i}]"))
    return out


@pytest.mark.parametrize("module, name, kwargs", _cases())
def test_reference_case_on_the_port(module, name, kwargs, tmp_path):
    fn = replay(module, PORT_NAMES)[name]
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        kwargs = dict(kwargs, tmp_path=tmp_path)
    fn(**kwargs)


def test_replay_covers_every_reference_case():
    # 9 latency-logging cases; 4 manifest tests + 2 x 9 tampered cases,
    # less the engine case rewritten below
    assert len(_cases()) == 9 + 4 + 2 * 9 - len(REWRITTEN)
    g = replay("test_artifacts_manifest", PORT_NAMES)
    assert g["Telemetry"] is telemetry.Telemetry
    assert g["schema"] is schema


def test_engine_run_writes_manifest_at_shutdown(tmp_path):
    """End to end: a real port ServeEngine run leaves a schema-valid
    manifest and log file behind (the reference's case on the port's
    engine and model)."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_workload
    from repro_torch.models.lm import LM
    from repro_torch.serving import EngineConfig, ServeEngine

    cfg = get_config("qwen2-0.5b", smoke=True)
    model = LM(cfg)
    params = model.init(prng.PRNGKey(0), "cpu")
    log = tmp_path / "log.jsonl"
    man = tmp_path / "manifest.json"
    ecfg = EngineConfig(lanes=2, page_size=4, num_pages=9, max_len=12,
                        stats_every=2, log_path=str(log),
                        manifest_path=str(man))
    engine = ServeEngine(model, params, ecfg, arch=cfg.name)
    workload = build_workload(cfg, requests=3, prompt_len=6, gen=4)
    results, summary = engine.run(workload)

    assert set(results) == {r.request_id for r in workload}
    assert all(len(v) == 4 for v in results.values())
    manifest = json.loads(man.read_text())
    schema.validate_manifest(manifest)
    jschema.validate_manifest(manifest)
    assert manifest["arch"] == cfg.name
    assert manifest["engine"]["mode"] == "continuous"
    assert manifest["workload"]["generated_tokens"] == 12
    assert manifest["throughput"]["prefills"] == 3
    assert manifest["artifacts"]["log"] == str(log)
    events = set()
    for line in log.read_text().strip().splitlines():
        obj = json.loads(line)
        schema.validate_log_line(obj)
        jschema.validate_log_line(obj)
        events.add(obj["event"])
    assert events == set(schema.LOG_EVENTS)


@pytest.mark.parametrize("name", ["SCHEMA_VERSION", "LOG_EVENTS",
                                  "LOG_ENVELOPE_SCHEMA", "EVENT_SCHEMAS",
                                  "MANIFEST_SCHEMA"])
def test_schema_tables_equal_the_reference(name):
    assert getattr(schema, name) == getattr(jschema, name)


def _drive(tel, lifetime=None):
    tel.request_submitted("r0", 8, 3)
    tel.request_admitted("r0", 0, 2, step=0, shared_pages=1, chunks=2)
    tel.prefill_batch(0, 8, 1)
    tel.first_token("r0")
    tel.token("r0")
    tel.token("r0")
    tel.request_finished("r0", 0, step=2)
    tel.engine_stats(step=2, active_lanes=0, waiting=0, free_pages=8)
    tel.run_summary(0.25, extras={"prefill_batches": 1, "prefill_chunks": 2,
                                  "retraces": 1, "prefix_hit_rate": 0.5})
    tel.steps, tel.prefills = 2, 1
    return tel.build_manifest(
        arch="qwen2-smoke",
        engine={"mode": "continuous", "lanes": 2, "page_size": 4,
                "num_pages": 9, "table_width": 4, "prefill_chunk": 8,
                "prefill_budget": 0, "prefix_share": True,
                "temperature": 0.0, "top_k": 0},
        checkpoint={"restored": True, "dir": "/ck", "algorithm": "erider"},
        wall_s=0.25, lifetime=lifetime)


LIFETIME = {"age_s": 31557600.0, "gdc": True, "t0_signature": "checkpoint",
            "drift_scale": {"c0": {"min": 1.1, "mean": 1.2, "max": 1.3}}}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_artifacts_validate_under_either_schema(writer):
    mod = telemetry if writer == "port" else jtelemetry
    tel = mod.Telemetry(clock=iter(float(i) for i in range(100)).__next__)
    manifest = _drive(tel, lifetime=dict(LIFETIME))
    lines = tel.logger.lines
    assert [l["event"] for l in lines] == [
        "request_submitted", "request_admitted", "prefill_batch",
        "request_finished", "engine_stats", "run_summary"]
    for s in (schema, jschema):
        s.validate_manifest(json.loads(json.dumps(manifest)))
        for line in lines:
            s.validate_log_line(json.loads(json.dumps(line)))
    # drift fails under both: a key neither schema knows
    bad = dict(manifest, bonus=1)
    for s in (schema, jschema):
        with pytest.raises(s.SchemaError, match="unexpected key"):
            s.validate_manifest(bad)
