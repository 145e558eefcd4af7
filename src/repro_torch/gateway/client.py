"""Minimal stdlib HTTP client for the gateway: JSON calls + SSE reassembly.

``http.client`` based (synchronous — the traffic harness drives it from a
thread pool, which is also how real SDK clients behave), with just enough
SSE parsing to reassemble a streamed completion back into the exact text a
non-streamed call returns: the byte-parity contract the gateway tests pin.
"""
from __future__ import annotations

import http.client
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class GatewayReply:
    """One HTTP exchange, with streamed events reassembled."""

    status: int
    headers: Dict[str, str]  # lower-cased names
    body: bytes
    events: List[Dict[str, Any]] = field(default_factory=list)  # SSE data objects
    done: bool = False  # saw the `data: [DONE]` terminator

    def json(self) -> Dict[str, Any]:
        return json.loads(self.body.decode("utf-8"))

    @property
    def text(self) -> Optional[str]:
        """The completion text: from the JSON body (non-streamed) or
        reassembled from the chunk deltas (streamed). None on errors."""
        if self.status != 200:
            return None
        if self.events:
            parts: List[str] = []
            for ev in self.events:
                choice = (ev.get("choices") or [{}])[0]
                if "delta" in choice:  # chat chunk
                    parts.append(choice["delta"].get("content", ""))
                else:  # text_completion chunk
                    parts.append(choice.get("text", ""))
            return "".join(parts)
        payload = self.json()
        choice = (payload.get("choices") or [{}])[0]
        if "message" in choice:
            return choice["message"].get("content")
        return choice.get("text")


def parse_sse(raw: bytes) -> Tuple[List[Dict[str, Any]], bool]:
    """Split an SSE byte stream into its JSON data events; returns
    (events, saw_done)."""
    events: List[Dict[str, Any]] = []
    done = False
    for block in raw.split(b"\n\n"):
        for line in block.split(b"\n"):
            if not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):]
            if data.strip() == b"[DONE]":
                done = True
            else:
                events.append(json.loads(data.decode("utf-8")))
    return events, done


class GatewayClient:
    """One keep-alive connection to a gateway. Not thread-safe — give each
    harness worker its own instance (mirrors per-user SDK clients)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._conn: Optional[http.client.HTTPConnection] = None

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "GatewayClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- raw request -----------------------------------------------------------

    def request(self, method: str, path: str,
                payload: Optional[Dict[str, Any]] = None) -> GatewayReply:
        conn = self._connection()
        body = None if payload is None else json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"} if body else {}
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()  # drains chunked SSE bodies too
        except (http.client.HTTPException, ConnectionError, OSError):
            self.close()  # poisoned keep-alive connection; next call redials
            raise
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
        if resp.will_close:
            self.close()
        if hdrs.get("content-type", "").startswith("text/event-stream"):
            events, done = parse_sse(raw)
            return GatewayReply(resp.status, hdrs, raw, events, done)
        return GatewayReply(resp.status, hdrs, raw)

    # -- the two OpenAI surfaces -----------------------------------------------

    def chat(self, content: str, *, system: Optional[str] = None,
             stream: bool = False, **fields) -> GatewayReply:
        messages = [{"role": "user", "content": content}]
        if system is not None:
            messages.insert(0, {"role": "system", "content": system})
        return self.request(
            "POST", "/v1/chat/completions",
            {"messages": messages, "stream": stream, **fields},
        )

    def completion(self, prompt: str, *, stream: bool = False,
                   **fields) -> GatewayReply:
        return self.request(
            "POST", "/v1/completions", {"prompt": prompt, "stream": stream, **fields}
        )

    def healthz(self) -> GatewayReply:
        return self.request("GET", "/healthz")

    def cache_stats(self) -> GatewayReply:
        return self.request("GET", "/v1/cache/stats")
