"""HTTP serving tier over the futures API (counterpart of
``repro.ppr_serving.http``, copied module by module: stdlib asyncio only).

It serves ``submit() → PPRFuture`` + ``poll()``/``flush()`` over a network
with the control plane a production tier needs; the waves it drives run on
the service's device (the fused family: the fused-iteration CUDA kernel):

``server.py``     ``ServingApp`` (transport-agnostic routes + status mapping)
                  behind ``AsyncioHTTPTransport`` (stdlib asyncio streams,
                  HTTP/1.1 keep-alive — no new runtime deps, tier-1 stays
                  hermetic); ``PPRHTTPServer`` assembles app + admission +
                  pump with one lifecycle.  The transport seam is where a
                  FastAPI/uvicorn adapter lands later.
``admission.py``  Bounded wave-queue admission with hysteretic load shedding
                  (429 + Retry-After past the high-water mark), backpressure-
                  aware κ-deepening, and SLO-aware quality degradation —
                  ``precision="auto"`` resolves against a stepped-down
                  quality target while the queue is deep, recovering when it
                  drains.  Every decision lands in ``ServiceTelemetry``.
``pump.py``       The asyncio heartbeat calling ``poll()`` on deadline —
                  waves launch, futures resolve, parked handlers respond.
``schemas.py``    stdlib-JSON request/response schemas (``SchemaError`` →
                  400), shaped for a later 1:1 pydantic mapping.
``client.py``     Keep-alive asyncio JSON client for benches/tests/examples.
"""
from repro_torch.ppr_serving.http.admission import AdmissionConfig, AdmissionController
from repro_torch.ppr_serving.http.client import AsyncHTTPClient, http_request
from repro_torch.ppr_serving.http.pump import WavePump
from repro_torch.ppr_serving.http.schemas import (PPRRequestSchema, SchemaError,
                                                  error_payload,
                                                  recommendation_payload)
from repro_torch.ppr_serving.http.server import (AsyncioHTTPTransport, HTTPRequest,
                                                 HTTPResponse, PPRHTTPServer,
                                                 ServingApp)

__all__ = [
    "AdmissionConfig", "AdmissionController",
    "AsyncHTTPClient", "http_request",
    "WavePump",
    "PPRRequestSchema", "SchemaError",
    "error_payload", "recommendation_payload",
    "AsyncioHTTPTransport", "HTTPRequest", "HTTPResponse",
    "PPRHTTPServer", "ServingApp",
]
