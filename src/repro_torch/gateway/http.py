"""Minimal stdlib-asyncio HTTP/1.1 server — the gateway's socket layer.

No framework, no dependencies: ``asyncio.start_server`` plus a hand-rolled
HTTP/1.1 request parser and response writer. Deliberately small surface —
what the OpenAI-compatible front end needs and nothing more:

  * keep-alive connections, ``Content-Length`` bodies (no request-side
    chunked encoding — SDK clients don't send it; it's a 400);
  * fixed responses (``Content-Length``) and streamed responses
    (``Transfer-Encoding: chunked``, used for SSE) from one ``Response``
    type carrying an optional async chunk iterator;
  * graceful drain: ``drain()`` stops accepting (listener closed, new
    requests on live connections get 503 + ``Connection: close``), waits
    for in-flight requests to finish writing, then closes what remains.

Shared state and locking
------------------------
The server itself runs on one event loop, but ``drain()``/``aclose()`` are
routinely called from OTHER threads' coroutines in tests and from signal
handlers in ``launch/serve``, so the connection table, in-flight counter,
and drain flag keep the serving layer's ``# guarded-by:`` contract (the
reference package's lint checker RA301 enforces it there): every access
sits inside ``with self._lock`` — lock holds are tiny and never span an
``await``.
"""
from __future__ import annotations

import asyncio
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, List, Optional, Tuple

from repro_torch.gateway.protocol import ProtocolError

MAX_BODY_BYTES = 8 * 1024 * 1024  # a chat transcript, not an upload endpoint

_STATUS_TEXT = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    408: "Request Timeout", 429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


@dataclass
class HttpRequest:
    method: str
    path: str
    headers: Dict[str, str]  # keys lower-cased
    body: bytes = b""

    def json(self) -> Dict[str, Any]:
        """Parse the body as a JSON object; malformed input is a 400."""
        try:
            obj = json.loads(self.body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ProtocolError(400, f"request body is not valid JSON: {e}") from e
        if not isinstance(obj, dict):
            raise ProtocolError(400, "request body must be a JSON object")
        return obj


@dataclass
class Response:
    """One HTTP response. ``body`` for fixed payloads; ``chunks`` (an async
    byte iterator) switches the writer to chunked transfer — SSE streams
    ride this. ``headers`` never includes framing headers; the writer owns
    ``Content-Length``/``Transfer-Encoding``/``Connection``."""

    status: int = 200
    headers: List[Tuple[str, str]] = field(default_factory=list)
    body: bytes = b""
    content_type: str = "application/json"
    chunks: Optional[AsyncIterator[bytes]] = None

    @classmethod
    def json_response(cls, payload: Dict[str, Any], status: int = 200,
                      headers: Optional[List[Tuple[str, str]]] = None) -> "Response":
        return cls(status, list(headers or []), json.dumps(payload).encode())


Handler = Callable[[HttpRequest], Awaitable[Response]]


class GatewayHttpServer:
    """``asyncio`` HTTP/1.1 listener delegating every request to ``handler``."""

    def __init__(self, handler: Handler, host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        self.host = host
        self.port = port  # rebound to the real port after start() when 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: Dict[asyncio.StreamWriter, bool] = {}  # guarded-by: _lock — writer -> mid-request
        self._inflight = 0  # guarded-by: _lock — requests parsed, response not yet written
        self._draining = False  # guarded-by: _lock
        self._requests_served = 0  # guarded-by: _lock
        self._lock = threading.Lock()  # connection table + drain state

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(self._serve_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def requests_served(self) -> int:
        with self._lock:
            return self._requests_served

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    async def drain(self, timeout: float = 10.0) -> bool:
        """Graceful shutdown, phase one: stop accepting (listener closed,
        fresh requests answered 503), wait for every in-flight request to
        finish writing, then close idle connections, and only then wait for
        the listener to finish closing. Returns True when the server drained
        clean within ``timeout``.

        The order matters: since Python 3.12.1 ``Server.wait_closed()``
        waits for every live connection, so awaiting it while an idle
        keep-alive connection is still open would block until the client
        hangs up."""
        with self._lock:
            self._draining = True
        if self._server is not None:
            self._server.close()
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._lock:
                if self._inflight == 0:
                    break
            await asyncio.sleep(0.01)
        with self._lock:
            clean = self._inflight == 0
            writers = list(self._conns)
        for w in writers:  # drained (or timed out): drop what's left
            w.close()
        if self._server is not None:
            # every connection is closing now; their handlers exit at their
            # next read or write, which is what wait_closed() waits for
            try:
                await asyncio.wait_for(self._server.wait_closed(),
                                       max(1.0, deadline - time.perf_counter()))
            except asyncio.TimeoutError:
                clean = False
        return clean

    async def aclose(self, timeout: float = 10.0) -> bool:
        return await self.drain(timeout=timeout)

    # -- connection handling ---------------------------------------------------

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        with self._lock:
            if self._draining:
                writer.close()
                return
            self._conns[writer] = False
        try:
            while True:
                try:
                    request = await self._read_request(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break  # client went away between requests
                except asyncio.LimitOverrunError:
                    await self._write_simple(writer, 431, b"", close=True)
                    break
                except ProtocolError as e:
                    from repro_torch.gateway.errors import map_exception

                    status, headers, body = map_exception(e)
                    await self._write_response(
                        writer, Response(status, headers, body), close=True
                    )
                    break
                if request is None:
                    break  # clean EOF at a request boundary
                with self._lock:
                    draining = self._draining
                    if not draining:
                        self._conns[writer] = True
                        self._inflight += 1
                if draining:
                    from repro_torch.gateway.errors import draining_unavailable

                    status, headers, body = draining_unavailable()
                    await self._write_response(
                        writer, Response(status, headers, body), close=True
                    )
                    break
                try:
                    response = await self._dispatch(request)
                    close = (
                        request.headers.get("connection", "").lower() == "close"
                    )
                    await self._write_response(writer, response, close=close)
                finally:
                    with self._lock:
                        self._inflight -= 1
                        self._requests_served += 1
                        self._conns[writer] = False
                if close:
                    break
        except (ConnectionError, asyncio.CancelledError):
            pass  # mid-write disconnects are the client's prerogative
        finally:
            with self._lock:
                self._conns.pop(writer, None)
            writer.close()

    async def _dispatch(self, request: HttpRequest) -> Response:
        try:
            return await self.handler(request)
        except Exception as e:  # noqa: BLE001 — every failure gets a wire shape
            from repro_torch.gateway.errors import map_exception

            status, headers, body = map_exception(e)
            return Response(status, headers, body)

    # -- parsing ---------------------------------------------------------------

    async def _read_request(self, reader: asyncio.StreamReader) -> Optional[HttpRequest]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            if not e.partial:
                return None  # clean close between requests
            raise
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise ProtocolError(400, f"malformed request line: {lines[0]!r}")
        method, target = parts[0], parts[1]
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            name, sep, value = line.partition(":")
            if not sep:
                raise ProtocolError(400, f"malformed header line: {line!r}")
            headers[name.strip().lower()] = value.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise ProtocolError(400, "chunked request bodies are not supported")
        body = b""
        if "content-length" in headers:
            try:
                length = int(headers["content-length"])
            except ValueError:
                raise ProtocolError(400, "invalid Content-Length") from None
            if length < 0 or length > MAX_BODY_BYTES:
                raise ProtocolError(400, f"Content-Length out of range: {length}")
            body = await reader.readexactly(length)
        path = target.split("?", 1)[0]
        return HttpRequest(method, path, headers, body)

    # -- writing ---------------------------------------------------------------

    async def _write_response(self, writer: asyncio.StreamWriter,
                              response: Response, *, close: bool = False) -> None:
        reason = _STATUS_TEXT.get(response.status, "Unknown")
        head = [f"HTTP/1.1 {response.status} {reason}"]
        names = {n.lower() for n, _ in response.headers}
        if "content-type" not in names:
            head.append(f"Content-Type: {response.content_type}")
        for name, value in response.headers:
            head.append(f"{name}: {value}")
        if response.chunks is None:
            head.append(f"Content-Length: {len(response.body)}")
            head.append(f"Connection: {'close' if close else 'keep-alive'}")
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
            writer.write(response.body)
            await writer.drain()
            return
        head.append("Transfer-Encoding: chunked")
        head.append(f"Connection: {'close' if close else 'keep-alive'}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        await writer.drain()
        async for chunk in response.chunks:
            if not chunk:
                continue
            writer.write(f"{len(chunk):x}\r\n".encode("latin-1") + chunk + b"\r\n")
            await writer.drain()
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    async def _write_simple(self, writer: asyncio.StreamWriter, status: int,
                            body: bytes, *, close: bool) -> None:
        await self._write_response(writer, Response(status, [], body), close=close)
