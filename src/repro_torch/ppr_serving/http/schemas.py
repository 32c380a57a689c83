"""Wire schemas of the HTTP serving tier — stdlib-JSON in, stdlib-JSON out.

Counterpart of ``repro.ppr_serving.http.schemas``, copied as it is (stdlib only).

No pydantic: tier-1 stays hermetic.  Each schema is a frozen dataclass with
an explicit ``parse`` that raises ``SchemaError`` (→ HTTP 400) with a message
naming the offending field, mirroring the descriptive-validation house style
of ``PPRService.submit``.  A FastAPI adapter can later map these 1:1 onto
pydantic models without touching the transport-agnostic app core.

``POST /v1/ppr`` request body::

    {"graph": "social", "vertex": 17, "k": 10,
     "precision": "auto",            # null/"f32" | bits | "Q1.25" | "auto"
     "quality_target": 0.95,         # only meaningful with "auto"
     "deadline_s": 0.05}             # admission-wait budget (optional)

Response body (200)::

    {"graph": ..., "vertex": ..., "k": ...,
     "precision": "Q1.25",           # resolved precision actually served
     "source": "wave" | "cache", "wave_id": ..., "latency_s": ...,
     "degraded": false,              # true ⇒ served under the SLO ceiling
     "recommendations": [{"vertex": 3, "score": 0.013}, ...]}

Errors are ``{"error": <message>, "code": <machine-readable>}`` with the code
mirroring ``QueryRejected.code`` where one exists.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Union

__all__ = ["SchemaError", "PPRRequestSchema", "recommendation_payload",
           "error_payload", "dumps"]


class SchemaError(ValueError):
    """Malformed request body — maps to HTTP 400."""


def _require(obj: Dict[str, Any], field: str, types, type_name: str):
    if field not in obj:
        raise SchemaError(f"missing required field {field!r}")
    v = obj[field]
    # bool is an int subclass; an explicit true/false vertex is a client bug
    if isinstance(v, bool) or not isinstance(v, types):
        raise SchemaError(f"field {field!r} must be {type_name}, "
                          f"got {type(v).__name__}")
    return v


def _optional(obj: Dict[str, Any], field: str, types, type_name: str,
              default=None):
    if field not in obj or obj[field] is None:
        return default
    v = obj[field]
    if isinstance(v, bool) or not isinstance(v, types):
        raise SchemaError(f"field {field!r} must be {type_name} or null, "
                          f"got {type(v).__name__}")
    return v


@dataclasses.dataclass(frozen=True)
class PPRRequestSchema:
    """Validated ``POST /v1/ppr`` body, still transport-side: precision stays
    the wire value (``submit`` owns format resolution and its errors)."""
    graph: str
    vertex: int
    k: int = 10
    precision: Union[None, int, str] = None
    quality_target: Optional[float] = None
    deadline_s: Optional[float] = None

    @classmethod
    def parse(cls, body: bytes) -> "PPRRequestSchema":
        if not body:
            raise SchemaError("empty request body (expected a JSON object)")
        try:
            obj = json.loads(body)
        except json.JSONDecodeError as e:
            raise SchemaError(f"request body is not valid JSON: {e}") from None
        if not isinstance(obj, dict):
            raise SchemaError(f"request body must be a JSON object, "
                              f"got {type(obj).__name__}")
        known = {"graph", "vertex", "k", "precision", "quality_target",
                 "deadline_s"}
        unknown = sorted(set(obj) - known)
        if unknown:
            raise SchemaError(f"unknown field(s) {unknown} "
                              f"(expected a subset of {sorted(known)})")
        return cls(
            graph=_require(obj, "graph", str, "a string"),
            vertex=_require(obj, "vertex", int, "an integer"),
            k=_optional(obj, "k", int, "an integer", default=10),
            precision=_optional(obj, "precision", (int, str),
                                "an integer bit-width or a string"),
            quality_target=_optional(obj, "quality_target", (int, float),
                                     "a number"),
            deadline_s=_optional(obj, "deadline_s", (int, float), "a number"),
        )


def recommendation_payload(rec, degraded: bool = False) -> Dict[str, Any]:
    """JSON-ready dict for a resolved ``Recommendation``."""
    return {
        "graph": rec.query.graph,
        "vertex": int(rec.query.vertex),
        "k": int(rec.query.k),
        "precision": rec.precision,
        "source": rec.source,
        "wave_id": int(rec.wave_id),
        "latency_s": float(rec.latency_s),
        "degraded": bool(degraded),
        "recommendations": [
            {"vertex": int(v), "score": float(s)}
            for v, s in zip(rec.vertices, rec.scores)
        ],
    }


def error_payload(message: str, code: str,
                  retry_after_s: Optional[float] = None) -> Dict[str, Any]:
    out: Dict[str, Any] = {"error": message, "code": code}
    if retry_after_s is not None:
        out["retry_after_s"] = float(retry_after_s)
    return out


def dumps(payload: Dict[str, Any]) -> bytes:
    return json.dumps(payload, separators=(",", ":")).encode("utf-8")
