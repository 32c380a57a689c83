"""The HTTP front door: transport-agnostic app core + asyncio transport.

Counterpart of ``repro.ppr_serving.http.server``, copied as it is (stdlib
asyncio; the routes, status mapping and bodies are the reference's).

Layering (so a FastAPI adapter can land later without touching policy):

    AsyncioHTTPTransport        stdlib asyncio streams, HTTP/1.1 keep-alive
        │  HTTPRequest → HTTPResponse
    ServingApp                  routes + status mapping + future awaiting
        │  PPRQuery → PPRFuture
    AdmissionController         shed / degrade / deepen (admission.py)
    WavePump                    drives poll() on deadline (pump.py)
    PPRService                  the futures API

Endpoints:

    POST /v1/ppr      submit one query; 200 with ranked recommendations,
                      400 bad request, 404 unknown graph, 429 + Retry-After
                      shed, 409 delta-invalidated, 410 graph-replaced,
                      504 deadline-exceeded (dropped at wave launch)
    GET  /v1/healthz  liveness + registered graphs + queue depth
    GET  /v1/stats    full ServiceTelemetry summary + admission + pump stats
    GET  /v1/metrics  the metrics registry in Prometheus text exposition
                      format (0.0.4); ``?format=json`` for the JSON dump
    GET  /v1/slo      SLO monitor status: per-spec state + per-window burn
                      rates + recent alert transitions (404 when the
                      service runs without an SLO monitor)
    GET  /v1/debug/traces   flight-recorder snapshot (last completed traces
                      + control-plane events); ``?n=K`` bounds both lists

Status mapping is the rejection-path contract: a ``QueryRejected`` future is
a *client-actionable* outcome (resubmit), never a 500 — and the future is
consumed (its exception read) on every path, so rejected queries cannot leak
pending futures or "exception was never retrieved" noise.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs

from repro_torch.obs import prometheus_text
from repro_torch.ppr_serving.futures import QueryRejected
from repro_torch.ppr_serving.http.admission import AdmissionConfig, AdmissionController
from repro_torch.ppr_serving.http.pump import WavePump
from repro_torch.ppr_serving.http.schemas import (PPRRequestSchema, SchemaError,
                                                  dumps, error_payload,
                                                  recommendation_payload)
from repro_torch.ppr_serving.service import AUTO_KEY, PPRQuery

__all__ = ["HTTPRequest", "HTTPResponse", "ServingApp",
           "AsyncioHTTPTransport", "PPRHTTPServer"]

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 409: "Conflict", 410: "Gone",
            429: "Too Many Requests", 500: "Internal Server Error",
            504: "Gateway Timeout"}

#: QueryRejected.code → HTTP status (the rejection-path contract)
_REJECT_STATUS = {"graph-replaced": 410, "delta-invalidated": 409,
                  "deadline-exceeded": 504}


@dataclasses.dataclass(frozen=True)
class HTTPRequest:
    method: str
    path: str
    headers: Dict[str, str]            # keys lower-cased
    body: bytes = b""


@dataclasses.dataclass(frozen=True)
class HTTPResponse:
    status: int
    payload: Dict[str, Any]            # JSON body (ignored when body is set)
    headers: Tuple[Tuple[str, str], ...] = ()
    # non-JSON responses (the Prometheus text exposition) set the raw body
    # and its content type; ``payload`` then goes unrendered
    body: Optional[bytes] = None
    content_type: str = "application/json"


class ServingApp:
    """Routes HTTP requests onto the futures API.  Transport-agnostic: any
    adapter that can build an ``HTTPRequest`` and render an ``HTTPResponse``
    (asyncio streams today, FastAPI/uvicorn later) serves the same policy."""

    def __init__(self, service, admission: Optional[AdmissionController] = None,
                 pump: Optional[WavePump] = None):
        self.service = service
        self.admission = admission
        self.pump = pump
        self.requests = 0

    # ------------------------------------------------------------------
    async def handle(self, req: HTTPRequest) -> HTTPResponse:
        self.requests += 1
        path, _, query_string = req.path.partition("?")
        params = {k: v[-1] for k, v in parse_qs(query_string).items()}
        route = (req.method.upper(), path)
        if route == ("POST", "/v1/ppr"):
            return await self._handle_ppr(req)
        if route == ("GET", "/v1/healthz"):
            return self._handle_healthz()
        if route == ("GET", "/v1/stats"):
            return self._handle_stats()
        if route == ("GET", "/v1/metrics"):
            return self._handle_metrics(params)
        if route == ("GET", "/v1/slo"):
            return self._handle_slo(params)
        if route == ("GET", "/v1/debug/traces"):
            return self._handle_traces(params)
        if path in ("/v1/ppr", "/v1/healthz", "/v1/stats", "/v1/metrics",
                    "/v1/slo", "/v1/debug/traces"):
            return HTTPResponse(405, error_payload(
                f"method {req.method} not allowed on {path}",
                "method-not-allowed"))
        return HTTPResponse(404, error_payload(
            f"no route {req.method} {path} "
            f"(have POST /v1/ppr, GET /v1/healthz, GET /v1/stats, "
            f"GET /v1/metrics, GET /v1/slo, GET /v1/debug/traces)",
            "unknown-route"))

    # ------------------------------------------------------------------
    async def _handle_ppr(self, req: HTTPRequest) -> HTTPResponse:
        try:
            spec = PPRRequestSchema.parse(req.body)
        except SchemaError as e:
            return HTTPResponse(400, error_payload(str(e), "bad-request"))

        if self.admission is not None:
            retry_after = self.admission.admit(graph=spec.graph)
            if retry_after is not None:
                return HTTPResponse(
                    429,
                    error_payload(
                        "admission queue is over its high-water mark — load "
                        "shed; retry after the hinted backoff",
                        "shed", retry_after_s=retry_after),
                    headers=(("Retry-After", f"{retry_after:.3f}"),))

        # the degradation decision the response reports: taken at submit
        # time, when resolution happens — not when the wave later runs
        ceiling = self.service.controller.target_ceiling
        degraded = False
        if spec.precision == AUTO_KEY and ceiling is not None:
            requested = (self.service.controller.config.default_target
                         if spec.quality_target is None
                         else float(spec.quality_target))
            degraded = ceiling < requested

        q = PPRQuery(graph=spec.graph, vertex=spec.vertex, k=spec.k,
                     precision=spec.precision,
                     quality_target=spec.quality_target,
                     deadline=spec.deadline_s)
        try:
            fut = self.service.submit(q)
        except KeyError as e:
            return HTTPResponse(404, error_payload(
                str(e).strip('"\''), "unknown-graph"))
        except ValueError as e:
            return HTTPResponse(400, error_payload(str(e), "bad-request"))

        try:
            rec = await self._await_future(fut)
        except QueryRejected as e:
            status = _REJECT_STATUS.get(e.code, 409)
            return HTTPResponse(status, error_payload(str(e), e.code))
        return HTTPResponse(200, recommendation_payload(rec, degraded=degraded))

    async def _await_future(self, fut):
        """Bridge a ``PPRFuture`` into the event loop: the pump resolves it
        from its poll cycles; this handler just parks until then."""
        loop = asyncio.get_running_loop()
        af: asyncio.Future = loop.create_future()

        def _done(f) -> None:
            def _transfer() -> None:
                if af.cancelled():
                    f.exception()      # consume: a gone client must not leak
                    return
                exc = f.exception()
                if exc is not None:
                    af.set_exception(exc)
                else:
                    af.set_result(f.result())
            # resolution happens inside pump/handler code already on this
            # loop, but threadsafe scheduling keeps an engine-thread future
            # resolution (a later offload) from corrupting the loop
            loop.call_soon_threadsafe(_transfer)

        fut.add_done_callback(_done)
        return await af

    # ------------------------------------------------------------------
    def _handle_healthz(self) -> HTTPResponse:
        svc = self.service
        return HTTPResponse(200, {
            "status": "ok",
            "graphs": list(svc.graphs),
            "queue_depth": svc.queue_depth(),
            "shedding": bool(self.admission.shedding) if self.admission else False,
            "degrading": bool(self.admission.degrading) if self.admission else False,
        })

    def _handle_stats(self) -> HTTPResponse:
        out: Dict[str, Any] = dict(self.service.telemetry_summary())
        if self.admission is not None:
            out.update({f"admission_{k}": v
                        for k, v in self.admission.stats().items()})
        if self.pump is not None:
            out["pump_cycles"] = self.pump.cycles
            out["pump_waves_launched"] = self.pump.waves_launched
        return HTTPResponse(200, out)

    def _handle_metrics(self, params: Dict[str, str]) -> HTTPResponse:
        """The bounded metrics registry — Prometheus text exposition by
        default (what a scraper ingests), ``?format=json`` for the flat
        JSON snapshot."""
        registry = self.service.telemetry.registry
        if params.get("format") == "json":
            return HTTPResponse(200, registry.as_dict())
        return HTTPResponse(
            200, {}, body=prometheus_text(registry).encode("utf-8"),
            content_type="text/plain; version=0.0.4; charset=utf-8")

    def _handle_slo(self, params: Dict[str, str]) -> HTTPResponse:
        """SLO monitor status: per-spec state, per-window burn rates, totals,
        plus the most recent alert transitions out of the flight recorder.
        Ticks the monitor first so a curl during a flood sees current burn,
        not the last heartbeat's."""
        slo = getattr(self.service, "slo", None)
        if slo is None:
            return HTTPResponse(404, error_payload(
                "this service runs without an SLO monitor — construct it "
                "with PPRService(slo=True) or pass --slo to ppr_run",
                "slo-monitoring-off"))
        slo.tick()
        out: Dict[str, Any] = slo.status()
        recorder = getattr(self.service, "recorder", None)
        if recorder is not None:
            n = 32
            if "n" in params:
                try:
                    n = max(0, int(params["n"]))
                except ValueError:
                    return HTTPResponse(400, error_payload(
                        f"n must be an integer, got {params['n']!r}",
                        "bad-request"))
            out["recent_events"] = recorder.events_of_kind(
                "slo_burning", "slo_recovered", "slo_advisory", n=n)
        return HTTPResponse(200, out)

    def _handle_traces(self, params: Dict[str, str]) -> HTTPResponse:
        """Flight-recorder snapshot: the last completed query/wave traces and
        control-plane events, ``?n=K`` limiting both lists."""
        recorder = getattr(self.service, "recorder", None)
        if recorder is None:
            return HTTPResponse(404, error_payload(
                "this service has no flight recorder", "no-recorder"))
        n: Optional[int] = None
        if "n" in params:
            try:
                n = max(0, int(params["n"]))
            except ValueError:
                return HTTPResponse(400, error_payload(
                    f"n must be an integer, got {params['n']!r}",
                    "bad-request"))
        snap = recorder.snapshot(n_traces=n, n_events=n)
        snap["tracing"] = getattr(self.service, "tracer", None) is not None
        return HTTPResponse(200, snap)


# ---------------------------------------------------------------------------
# asyncio streams transport
# ---------------------------------------------------------------------------
class AsyncioHTTPTransport:
    """Minimal HTTP/1.1 server over ``asyncio.start_server``: request-line +
    headers + Content-Length bodies, keep-alive by default, JSON responses.
    Deliberately small — the transport interface (``start``/``stop`` +
    ``host``/``port``) is the seam a production ASGI adapter replaces."""

    def __init__(self, app: ServingApp, host: str = "127.0.0.1",
                 port: int = 0):
        self.app = app
        self.host = host
        self.port = port               # 0 → ephemeral; real port after start()
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # ------------------------------------------------------------------
    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                try:
                    resp = await self.app.handle(req)
                except Exception as e:   # a handler bug must answer, not hang
                    resp = HTTPResponse(500, error_payload(
                        f"internal error: {e!r}", "internal"))
                self._write_response(writer, resp)
                await writer.drain()
                if req.headers.get("connection", "").lower() == "close":
                    break
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass                         # client went away mid-request
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader
                            ) -> Optional[HTTPRequest]:
        line = await reader.readline()
        if not line or line in (b"\r\n", b"\n"):
            return None
        parts = line.decode("latin1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0], parts[1]
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin1").partition(":")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0") or 0)
        body = await reader.readexactly(length) if length else b""
        return HTTPRequest(method=method, path=path, headers=headers,
                           body=body)

    @staticmethod
    def _write_response(writer: asyncio.StreamWriter,
                        resp: HTTPResponse) -> None:
        body = resp.body if resp.body is not None else dumps(resp.payload)
        reason = _REASONS.get(resp.status, "Unknown")
        head = [f"HTTP/1.1 {resp.status} {reason}",
                f"Content-Type: {resp.content_type}",
                f"Content-Length: {len(body)}"]
        head.extend(f"{k}: {v}" for k, v in resp.headers)
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin1") + body)


# ---------------------------------------------------------------------------
class PPRHTTPServer:
    """Batteries-included assembly: app + admission + pump + transport with
    one lifecycle.  ``port=0`` binds an ephemeral port (tests/benches read
    ``server.port`` after ``start``)."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 admission: Optional[AdmissionConfig] = None,
                 pump_interval_s: float = 0.005):
        self.service = service
        self.admission = AdmissionController(service,
                                             admission or AdmissionConfig())
        self.pump = WavePump(service, self.admission,
                             interval_s=pump_interval_s)
        self.app = ServingApp(service, self.admission, self.pump)
        self.transport = AsyncioHTTPTransport(self.app, host=host, port=port)

    @property
    def host(self) -> str:
        return self.transport.host

    @property
    def port(self) -> int:
        return self.transport.port

    async def start(self) -> None:
        await self.transport.start()
        self.pump.start()

    async def stop(self) -> None:
        await self.transport.stop()    # stop accepting before final flush
        await self.pump.stop()

    async def serve_forever(self) -> None:
        await self.start()
        try:
            await asyncio.Event().wait()     # until cancelled (Ctrl-C)
        finally:
            await self.stop()
