"""Cross-process trace correlation for the event streams (a copy of
``hmsc_tpu/obs/trace.py``, which imports nothing but the standard library;
the port keeps its own).

A :class:`TraceContext` is minted at each top-level entry point — here the
serving engine and each HTTP request carrying an ``X-Hmsc-Trace`` header —
and propagated to child processes through the environment
(``HMSC_TPU_TRACE_CTX``, the same variable as the JAX package's, so the two
join one trace).  Every event a :class:`~hmsc_tpu_torch.obs.events.RunTelemetry`
writes while a context is bound gains three ADDITIVE fields:

- ``trace`` — the trace id, constant across every process the causal chain
  touches (supervisor → worker ranks, job queue → bucket worker → tenant
  streams, autopilot drop → refit worker → epoch commit → serving flip).
- ``span``  — this process/phase's own span id.
- ``parent`` — the span id of whoever spawned it (absent at the root).

The propagation model is the W3C ``traceparent`` one: a parent serialises
``<trace>:<its own span>`` into the env/header; the child mints a FRESH
span id and records the carried span as its ``parent``.  Assembling the
chain is therefore a pure read-side join on ``trace`` (the hub's
``traces()`` view) — no coordination, no extra collectives, and schema-v1
readers simply ignore the extra keys.  When no context is bound, event
bytes are unchanged.

Ids come from ``os.urandom`` — host-side entropy only, never drawn from
any sampler RNG stream, so tracing is draw-stream invariant by
construction.
"""

from __future__ import annotations

import binascii
import os
from dataclasses import dataclass

__all__ = ["TraceContext", "TRACE_ENV", "mint", "from_header",
           "current_context", "inherit_or_mint", "trace_env"]

# env var carrying "<trace_id>:<parent span_id>" across process spawns
TRACE_ENV = "HMSC_TPU_TRACE_CTX"


def _hex(nbytes: int) -> str:
    return binascii.hexlify(os.urandom(nbytes)).decode("ascii")


@dataclass(frozen=True)
class TraceContext:
    """One node of a cross-process causal chain (immutable)."""

    trace_id: str
    span_id: str
    parent_id: str | None = None

    def child(self) -> "TraceContext":
        """A same-trace child span (new span id, parent = this span)."""
        return TraceContext(self.trace_id, _hex(8), self.span_id)

    def header(self) -> str:
        """Wire form handed to children: ``<trace>:<this span>`` — the
        receiver mints its own span via :func:`from_header`."""
        return f"{self.trace_id}:{self.span_id}"

    def fields(self) -> dict:
        """The additive event fields this context contributes."""
        f = {"trace": self.trace_id, "span": self.span_id}
        if self.parent_id:
            f["parent"] = self.parent_id
        return f


def mint() -> TraceContext:
    """A fresh root context (new trace id, no parent)."""
    return TraceContext(_hex(16), _hex(8), None)


def from_header(header: str | None) -> TraceContext | None:
    """A child context of a serialised ``<trace>:<span>`` header (fresh
    span id, carried span as parent).  Malformed/empty headers yield
    ``None`` — a torn env var must never kill the run it annotates."""
    if not header:
        return None
    parts = str(header).split(":")
    if len(parts) != 2 or not parts[0] or not parts[1]:
        return None
    return TraceContext(parts[0], _hex(8), parts[1])


def current_context(env=None) -> TraceContext | None:
    """The context carried by the (process) environment, if any."""
    env = os.environ if env is None else env
    return from_header(env.get(TRACE_ENV))


def inherit_or_mint(env=None) -> TraceContext:
    """Entry-point rule: join the spawning parent's trace when the env
    carries one, otherwise start a fresh root trace."""
    ctx = current_context(env)
    return ctx if ctx is not None else mint()


def trace_env(ctx: TraceContext | None, env: dict | None = None) -> dict:
    """An env overlay propagating ``ctx`` to a child process (merged over
    ``env``); with ``ctx=None`` returns ``env`` unchanged — spawn sites
    stay trace-agnostic."""
    out = dict(env or {})
    if ctx is not None:
        out[TRACE_ENV] = ctx.header()
    return out
