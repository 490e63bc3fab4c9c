"""Checked-in schemas for the serving engine's observability contracts.

Port of the JAX package's ``serving/schema.py``: the same tables, so a
log line or manifest of either package validates under the other's.

Two artifacts are schema-bound:
  * every JSON log line the engine emits (``LOG_ENVELOPE_SCHEMA`` plus a
    per-event schema in ``EVENT_SCHEMAS``), and
  * the run-artifact manifest written at shutdown (``MANIFEST_SCHEMA``).

``validate`` is a dependency-free validator for the JSON-Schema subset the
contracts use (type / required / properties / additionalProperties / items /
enum / const / minimum) — CI does not install ``jsonschema``, and the tests
must be able to reject drift, not just parse.
"""
from __future__ import annotations

from typing import Any, Dict

SCHEMA_VERSION = 1


class SchemaError(ValueError):
    pass


_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "null": type(None),
}


def _type_ok(value, tname: str) -> bool:
    if tname == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if tname == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    return isinstance(value, _TYPES[tname])


def validate(instance, schema: Dict[str, Any], path: str = "$") -> None:
    """Raise SchemaError where ``instance`` violates ``schema``."""
    if "const" in schema and instance != schema["const"]:
        raise SchemaError(f"{path}: {instance!r} != const {schema['const']!r}")
    if "enum" in schema and instance not in schema["enum"]:
        raise SchemaError(f"{path}: {instance!r} not in {schema['enum']}")
    if "type" in schema:
        types = schema["type"] if isinstance(schema["type"], list) else [schema["type"]]
        if not any(_type_ok(instance, t) for t in types):
            raise SchemaError(f"{path}: {type(instance).__name__} is not {schema['type']}")
    if isinstance(instance, (int, float)) and not isinstance(instance, bool):
        if "minimum" in schema and instance < schema["minimum"]:
            raise SchemaError(f"{path}: {instance} < minimum {schema['minimum']}")
    if isinstance(instance, dict):
        for key in schema.get("required", ()):
            if key not in instance:
                raise SchemaError(f"{path}: missing required key {key!r}")
        props = schema.get("properties", {})
        extra = schema.get("additionalProperties", True)
        for key, value in instance.items():
            if key in props:
                validate(value, props[key], f"{path}.{key}")
            elif extra is False:
                raise SchemaError(f"{path}: unexpected key {key!r}")
            elif isinstance(extra, dict):
                validate(value, extra, f"{path}.{key}")
    if isinstance(instance, list) and "items" in schema:
        for i, item in enumerate(instance):
            validate(item, schema["items"], f"{path}[{i}]")


# ---------------------------------------------------------------------------
# log lines
# ---------------------------------------------------------------------------

_nonneg_number = {"type": "number", "minimum": 0}
_nonneg_int = {"type": "integer", "minimum": 0}
_req_id = {"type": "string"}

LOG_EVENTS = ("request_submitted", "request_admitted", "request_finished",
              "engine_stats", "run_summary", "prefill_batch")

LOG_ENVELOPE_SCHEMA = {
    "type": "object",
    "required": ["ts", "event"],
    "properties": {
        "ts": _nonneg_number,                       # seconds, monotonic origin
        "event": {"enum": list(LOG_EVENTS)},
    },
}

EVENT_SCHEMAS: Dict[str, Dict[str, Any]] = {
    "request_submitted": {
        "type": "object", "additionalProperties": False,
        "required": ["ts", "event", "request_id", "prompt_len",
                     "max_new_tokens", "arrival_step"],
        "properties": {
            "ts": _nonneg_number, "event": {"const": "request_submitted"},
            "request_id": _req_id, "prompt_len": _nonneg_int,
            "max_new_tokens": {"type": "integer", "minimum": 1},
            "arrival_step": _nonneg_int,
        },
    },
    "request_admitted": {
        "type": "object", "additionalProperties": False,
        "required": ["ts", "event", "request_id", "lane", "n_pages", "step"],
        "properties": {
            "ts": _nonneg_number, "event": {"const": "request_admitted"},
            "request_id": _req_id, "lane": _nonneg_int,
            # n_pages may be 0 when the whole footprint is prefix-shared
            "n_pages": _nonneg_int, "step": _nonneg_int,
            # optional (absent pre-PR9): CoW prefix sharing + chunked prefill
            "shared_pages": _nonneg_int,
            "chunks": {"type": "integer", "minimum": 1},
        },
    },
    "prefill_batch": {
        "type": "object", "additionalProperties": False,
        "required": ["ts", "event", "step", "bucket", "batch"],
        "properties": {
            "ts": _nonneg_number, "event": {"const": "prefill_batch"},
            "step": _nonneg_int,
            "bucket": {"type": "integer", "minimum": 1},   # padded chunk len
            "batch": {"type": "integer", "minimum": 1},    # real rows in call
        },
    },
    "request_finished": {
        "type": "object", "additionalProperties": False,
        "required": ["ts", "event", "request_id", "lane", "n_tokens",
                     "ttft_s", "tpot_s", "e2e_s", "step"],
        "properties": {
            "ts": _nonneg_number, "event": {"const": "request_finished"},
            "request_id": _req_id, "lane": _nonneg_int,
            "n_tokens": {"type": "integer", "minimum": 1},
            "ttft_s": _nonneg_number, "tpot_s": _nonneg_number,
            "e2e_s": _nonneg_number, "step": _nonneg_int,
        },
    },
    "engine_stats": {
        "type": "object", "additionalProperties": False,
        "required": ["ts", "event", "step", "active_lanes", "waiting",
                     "free_pages"],
        "properties": {
            "ts": _nonneg_number, "event": {"const": "engine_stats"},
            "step": _nonneg_int, "active_lanes": _nonneg_int,
            "waiting": _nonneg_int, "free_pages": _nonneg_int,
        },
    },
    "run_summary": {
        "type": "object", "additionalProperties": False,
        "required": ["ts", "event", "requests", "generated_tokens",
                     "wall_s", "tokens_per_s"],
        "properties": {
            "ts": _nonneg_number, "event": {"const": "run_summary"},
            "requests": _nonneg_int, "generated_tokens": _nonneg_int,
            "wall_s": _nonneg_number, "tokens_per_s": _nonneg_number,
            # optional engine extras (absent from standalone telemetry runs)
            "prefill_batches": _nonneg_int, "prefill_chunks": _nonneg_int,
            "retraces": _nonneg_int, "prefix_hit_rate": _nonneg_number,
        },
    },
}


def validate_log_line(line: Dict[str, Any]) -> None:
    validate(line, LOG_ENVELOPE_SCHEMA)
    validate(line, EVENT_SCHEMAS[line["event"]])


# ---------------------------------------------------------------------------
# run-artifact manifest
# ---------------------------------------------------------------------------

_latency_block = {
    "type": "object", "additionalProperties": False,
    "required": ["p50", "p99", "mean", "max"],
    "properties": {k: _nonneg_number for k in ("p50", "p99", "mean", "max")},
}

MANIFEST_SCHEMA = {
    "type": "object",
    "additionalProperties": False,
    "required": ["schema_version", "kind", "run_id", "created_unix", "arch",
                 "engine", "checkpoint", "workload", "latency_s",
                 "throughput", "artifacts", "status"],
    "properties": {
        "schema_version": {"const": SCHEMA_VERSION},
        "kind": {"const": "serve_run_manifest"},
        "run_id": {"type": "string"},
        "created_unix": _nonneg_number,
        "arch": {"type": "string"},
        "engine": {
            "type": "object", "additionalProperties": False,
            "required": ["mode", "lanes", "page_size", "num_pages",
                         "table_width"],
            "properties": {
                "mode": {"enum": ["continuous", "fixed"]},
                "lanes": {"type": "integer", "minimum": 1},
                "page_size": {"type": "integer", "minimum": 1},
                "num_pages": {"type": "integer", "minimum": 2},
                "table_width": {"type": "integer", "minimum": 1},
                # optional (absent pre-PR9): prefill-path feature toggles
                "prefill_chunk": _nonneg_int,
                "prefill_budget": _nonneg_int,
                "prefix_share": {"type": "boolean"},
                "temperature": _nonneg_number,
                "top_k": _nonneg_int,
            },
        },
        "checkpoint": {
            "type": "object", "additionalProperties": False,
            "required": ["restored", "dir", "algorithm"],
            "properties": {
                "restored": {"type": "boolean"},
                "dir": {"type": "string"},
                "algorithm": {"type": "string"},
            },
        },
        "workload": {
            "type": "object", "additionalProperties": False,
            "required": ["requests", "prompt_tokens", "generated_tokens"],
            "properties": {
                "requests": _nonneg_int, "prompt_tokens": _nonneg_int,
                "generated_tokens": _nonneg_int,
            },
        },
        "latency_s": {
            "type": "object", "additionalProperties": False,
            "required": ["ttft", "tpot", "e2e"],
            # "gap" (optional, absent pre-PR9): pooled inter-token intervals
            # across all requests — the jitter metric chunked prefill targets
            "properties": {"ttft": _latency_block, "tpot": _latency_block,
                           "e2e": _latency_block, "gap": _latency_block},
        },
        "throughput": {
            "type": "object", "additionalProperties": False,
            "required": ["tokens_per_s", "wall_s", "steps", "prefills"],
            "properties": {
                "tokens_per_s": _nonneg_number, "wall_s": _nonneg_number,
                "steps": _nonneg_int, "prefills": _nonneg_int,
                # optional prefill-path counters (absent pre-PR9)
                "prefill_batches": _nonneg_int, "prefill_chunks": _nonneg_int,
                "retraces": _nonneg_int,
            },
        },
        "artifacts": {
            "type": "object", "additionalProperties": False,
            "required": ["log"],
            "properties": {"log": {"type": ["string", "null"]}},
        },
        "status": {"enum": ["completed", "aborted"]},
        # optional (absent pre-lifetime): present only when the served
        # weights went through the lifetime subsystem (aged and/or GDC-corrected)
        "lifetime": {
            "type": "object", "additionalProperties": False,
            "required": ["age_s", "gdc", "t0_signature", "drift_scale"],
            "properties": {
                "age_s": _nonneg_number,
                "gdc": {"type": "boolean"},
                # where the t0 reference came from: stored by the training
                # driver, recomputed from an unaged restore, or GDC off
                "t0_signature": {"enum": ["checkpoint", "recomputed", "none"]},
                # per-scan-class summary of the per-matrix GDC scales
                "drift_scale": {
                    "type": "object",
                    "additionalProperties": {
                        "type": "object", "additionalProperties": False,
                        "required": ["min", "mean", "max"],
                        "properties": {
                            "min": _nonneg_number,
                            "mean": _nonneg_number,
                            "max": _nonneg_number,
                        },
                    },
                },
            },
        },
    },
}


def validate_manifest(manifest: Dict[str, Any]) -> None:
    validate(manifest, MANIFEST_SCHEMA)
