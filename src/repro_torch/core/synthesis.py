"""Response synthesis for generative caching (§3).

The paper offers two options for a generative hit: "provide a combination of
all answers obtained from the cache or perform a summarization of the answers".
``combine`` implements both — template combination (deterministic, no model)
and summarization via a pluggable summarizer callable (one of the zoo models
behind the serving engine, or any callable str -> str).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from repro_torch.core.vector_store import Entry


def combine(
    query: str,
    sources: List[Tuple[float, Entry]],
    mode: str = "template",
    summarizer: Optional[Callable[[str], str]] = None,
) -> str:
    ordered = sorted(sources, key=lambda se: -se[0])
    if mode == "concat":
        return "\n\n".join(e.response for _, e in ordered)
    if mode == "template":
        parts = [f"[combined from {len(ordered)} cached answers]"]
        for s, e in ordered:
            parts.append(f"- (sim={s:.3f}) Re: {e.query}\n{e.response}")
        return "\n".join(parts)
    if mode == "summarize":
        if summarizer is None:
            raise ValueError("summarize mode requires a summarizer callable")
        joined = "\n\n".join(e.response for _, e in ordered)
        return summarizer(
            f"Summarize the following cached answers into one response to: {query}\n\n{joined}"
        )
    raise ValueError(f"unknown synthesis mode {mode!r}")
