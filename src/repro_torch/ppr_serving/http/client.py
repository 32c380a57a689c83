"""Tiny asyncio HTTP/1.1 JSON client — the load half of the serving tier.

Counterpart of ``repro.ppr_serving.http.client``, copied as it is (stdlib only).

Exists so a traffic generator, the e2e tests and ``chip_smoke.py`` can drive
the real server over real sockets without a new runtime dependency.  One ``AsyncHTTPClient`` holds one keep-alive
connection — a closed-loop "user"; open N of them for N-way concurrency.
Not a general HTTP client: JSON bodies, Content-Length framing, no TLS.
"""
from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, Optional, Tuple

__all__ = ["AsyncHTTPClient", "http_request"]


class AsyncHTTPClient:
    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def _connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass
            self._reader = self._writer = None

    async def request(self, method: str, path: str,
                      body: Optional[Dict[str, Any]] = None
                      ) -> Tuple[int, Dict[str, str], Dict[str, Any]]:
        """One request/response on the keep-alive connection; reconnects
        once if the server closed it between requests.  Returns
        ``(status, headers, json_payload)``."""
        payload = b"" if body is None else json.dumps(body).encode("utf-8")
        for attempt in (0, 1):
            if self._writer is None:
                await self._connect()
            try:
                self._write_request(method, path, payload)
                await self._writer.drain()
                return await self._read_response()
            except (ConnectionResetError, BrokenPipeError,
                    asyncio.IncompleteReadError):
                await self.close()
                if attempt:
                    raise
        raise RuntimeError("unreachable")

    # ------------------------------------------------------------------
    def _write_request(self, method: str, path: str, payload: bytes) -> None:
        head = [f"{method} {path} HTTP/1.1",
                f"Host: {self.host}:{self.port}",
                "Content-Type: application/json",
                f"Content-Length: {len(payload)}"]
        self._writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin1")
                           + payload)

    async def _read_response(self
                             ) -> Tuple[int, Dict[str, str], Dict[str, Any]]:
        status_line = await self._reader.readline()
        if not status_line:
            raise asyncio.IncompleteReadError(b"", None)
        status = int(status_line.decode("latin1").split()[1])
        headers: Dict[str, str] = {}
        while True:
            h = await self._reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin1").partition(":")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0") or 0)
        raw = await self._reader.readexactly(length) if length else b""
        if not raw:
            return status, headers, {}
        # /v1/metrics serves Prometheus text exposition, not JSON — hand
        # non-JSON bodies back as decoded text instead of crashing
        if "application/json" in headers.get("content-type",
                                             "application/json"):
            return status, headers, json.loads(raw)
        return status, headers, raw.decode("utf-8")


async def http_request(host: str, port: int, method: str, path: str,
                       body: Optional[Dict[str, Any]] = None
                       ) -> Tuple[int, Dict[str, str], Dict[str, Any]]:
    """One-shot convenience wrapper: connect, request, close."""
    client = AsyncHTTPClient(host, port)
    try:
        return await client.request(method, path, body)
    finally:
        await client.close()
