"""OpenAI-compatible wire protocol: JSON bodies <-> ``CacheRequest``.

The gateway is a drop-in ``base_url`` replacement (the llm-cache /
GPT-Semantic-Cache proxy pattern): an unmodified OpenAI-SDK-shaped client
POSTs ``/v1/chat/completions`` or ``/v1/completions`` and gets back the
standard ``chat.completion`` / ``text_completion`` objects — or, with
``"stream": true``, the standard ``data:``-framed SSE chunk stream ending
in ``data: [DONE]``. This module owns both directions of that translation
plus the SSE framing; it never touches a socket.

Cache-specific knobs ride as OPTIONAL top-level extension fields the
OpenAI schema ignores: ``priority`` (int), ``deadline_ms`` (float),
``ttl_s`` (float), ``use_cache`` / ``force_fresh`` / ``cache_l1`` /
``cache_l2`` / ``allow_stale`` (bools), ``max_stale_s`` (float, bounds
the stale-if-error window). Unknown fields are ignored, wrong TYPES are a 400 —
silently coercing them would serve an answer the client didn't ask for.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.request import CacheRequest, CacheResponse


class ProtocolError(Exception):
    """A malformed request, mapped by the gateway to an HTTP error.

    ``status`` is the HTTP status code; ``err_type``/``code`` land in the
    OpenAI-style JSON error body."""

    def __init__(self, status: int, message: str, err_type: str = "invalid_request_error",
                 code: Optional[str] = None):
        super().__init__(message)
        self.status = status
        self.err_type = err_type
        self.code = code


def error_body(message: str, err_type: str, code: Optional[str] = None) -> bytes:
    """OpenAI-style JSON error envelope."""
    return json.dumps(
        {"error": {"message": message, "type": err_type, "param": None, "code": code}}
    ).encode()


# -- request parsing -----------------------------------------------------------


def _field(body: Dict[str, Any], name: str, types, default):
    val = body.get(name, default)
    if val is default:
        return default
    if types is float and isinstance(val, int) and not isinstance(val, bool):
        val = float(val)  # JSON has one number type; ints are fine for floats
    if not isinstance(val, types) or isinstance(val, bool) and types is not bool:
        raise ProtocolError(400, f"'{name}' must be {getattr(types, '__name__', types)}")
    return val


def _common_knobs(body: Dict[str, Any]) -> Dict[str, Any]:
    """Shared OpenAI params + cache extension fields -> CacheRequest kwargs."""
    deadline_ms = _field(body, "deadline_ms", float, None)
    kw = dict(
        model=_field(body, "model", str, None),
        max_tokens=_field(body, "max_tokens", int, 256),
        temperature=_field(body, "temperature", float, 0.0),
        stream=_field(body, "stream", bool, False),
        priority=_field(body, "priority", int, 0),
        deadline_s=None if deadline_ms is None else deadline_ms / 1e3,
        ttl_s=_field(body, "ttl_s", float, None),
        use_cache=_field(body, "use_cache", bool, True),
        force_fresh=_field(body, "force_fresh", bool, False),
        cache_l1=_field(body, "cache_l1", bool, True),
        cache_l2=_field(body, "cache_l2", bool, True),
        # stale-if-error opt-in (resilience): serve an expired entry instead
        # of a 503 when every backend is down, bounded by max_stale_s
        allow_stale=_field(body, "allow_stale", bool, False),
        max_stale_s=_field(body, "max_stale_s", float, None),
    )
    if kw["max_tokens"] <= 0:
        raise ProtocolError(400, "'max_tokens' must be positive")
    if kw["max_stale_s"] is not None and kw["max_stale_s"] < 0:
        raise ProtocolError(400, "'max_stale_s' must be non-negative")
    return kw


def render_messages(messages: List[Dict[str, Any]]) -> str:
    """Deterministically flatten a chat transcript into the cache prompt.

    The cache keys on semantic similarity of the WHOLE conversation, so the
    rendering must be stable across requests: ``role: content`` lines in
    order. (A system prompt change therefore changes the cache key — the
    conservative choice for correctness.)"""
    lines = []
    for i, msg in enumerate(messages):
        if not isinstance(msg, dict):
            raise ProtocolError(400, f"messages[{i}] must be an object")
        role, content = msg.get("role"), msg.get("content")
        if not isinstance(role, str) or not isinstance(content, str):
            raise ProtocolError(
                400, f"messages[{i}] needs string 'role' and 'content' fields"
            )
        lines.append(f"{role}: {content}")
    return "\n".join(lines)


def parse_chat_request(body: Dict[str, Any]) -> CacheRequest:
    """``/v1/chat/completions`` body -> ``CacheRequest``."""
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        raise ProtocolError(400, "'messages' must be a non-empty array")
    return CacheRequest(render_messages(messages), **_common_knobs(body))


def parse_completion_request(body: Dict[str, Any]) -> CacheRequest:
    """``/v1/completions`` body -> ``CacheRequest``. A single-element array
    prompt is accepted (SDKs send it); true batch prompts are rejected —
    the service batches across HTTP requests, not within one."""
    prompt = body.get("prompt")
    if isinstance(prompt, list) and len(prompt) == 1 and isinstance(prompt[0], str):
        prompt = prompt[0]
    if not isinstance(prompt, str) or not prompt:
        raise ProtocolError(
            400, "'prompt' must be a non-empty string (or a 1-element string array)"
        )
    return CacheRequest(prompt, **_common_knobs(body))


# -- response building ---------------------------------------------------------


def _usage(prompt: str, text: str) -> Dict[str, int]:
    p, c = len(prompt.split()), len((text or "").split())
    return {"prompt_tokens": p, "completion_tokens": c, "total_tokens": p + c}


def completion_body(
    resp: CacheResponse, request: CacheRequest, *, chat: bool
) -> Dict[str, Any]:
    """Non-streamed ``chat.completion`` / ``text_completion`` object."""
    created = int(time.time())
    rid = f"{'chatcmpl' if chat else 'cmpl'}-{resp.request_id}"
    if chat:
        choice: Dict[str, Any] = {
            "index": 0,
            "message": {"role": "assistant", "content": resp.text},
            "finish_reason": "stop",
        }
        obj = "chat.completion"
    else:
        choice = {"index": 0, "text": resp.text, "finish_reason": "stop"}
        obj = "text_completion"
    return {
        "id": rid,
        "object": obj,
        "created": created,
        "model": resp.model,
        "choices": [choice],
        "usage": _usage(request.prompt, resp.text or ""),
    }


def stream_chunk_body(
    resp: CacheResponse, *, chat: bool, text: Optional[str], first: bool, final: bool
) -> Dict[str, Any]:
    """One SSE chunk object. Chat streams open with a role-only delta and
    close with an empty delta + ``finish_reason`` (the OpenAI framing);
    completion streams just carry text chunks."""
    created = int(time.time())
    rid = f"{'chatcmpl' if chat else 'cmpl'}-{resp.request_id}"
    if chat:
        delta: Dict[str, Any] = {}
        if first:
            delta["role"] = "assistant"
        if text:
            delta["content"] = text
        choice: Dict[str, Any] = {
            "index": 0,
            "delta": delta,
            "finish_reason": "stop" if final else None,
        }
        obj = "chat.completion.chunk"
    else:
        choice = {
            "index": 0,
            "text": text or "",
            "finish_reason": "stop" if final else None,
        }
        obj = "text_completion"
    return {"id": rid, "object": obj, "created": created, "model": resp.model,
            "choices": [choice]}


def sse_event(payload: Dict[str, Any]) -> bytes:
    return b"data: " + json.dumps(payload).encode() + b"\n\n"


SSE_DONE = b"data: [DONE]\n\n"


def cache_headers(resp: CacheResponse) -> List[Tuple[str, str]]:
    """The gateway's cache-status header contract."""
    headers = [
        ("X-Cache", resp.cache_status),
        ("X-Cache-Level", resp.resolved_level),
        ("X-Service-Latency-Ms", f"{resp.latency_s * 1e3:.2f}"),
        ("X-Request-Id", str(resp.request_id)),
    ]
    if resp.similarity is not None and resp.from_cache:
        headers.insert(2, ("X-Cache-Similarity", f"{resp.similarity:.4f}"))
    return headers
