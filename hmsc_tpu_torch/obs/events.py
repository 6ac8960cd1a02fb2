"""Structured telemetry event stream (the part of ``hmsc_tpu/obs/events.py``
the serving engine uses, copied: that module imports nothing but the
standard library, and the port keeps its own).

Events are JSON objects, one per line of ``events-p<rank>.jsonl``; every
event carries ``seq``/``t``/``wall``/``proc``/``kind``/``name`` (``t`` is
monotonic seconds since the telemetry started):

- ``kind="run"`` — lifecycle marks (``serve_start``, ``epoch_flip``).
- ``kind="span"`` — a timed stage, emitted at close: ``{"sid", "parent",
  "depth", "thread", "t0", "dur_s", ...}``; spans nest per thread.
- ``kind="metric"`` — point measurements (``kernel_build``, ``query``).

While a :class:`~hmsc_tpu_torch.obs.trace.TraceContext` is bound, events
gain its ``trace``/``span``/``parent`` fields.  The aggregates (span
counts and totals) are kept even with ``enabled=False``; disabling only
stops retaining and writing events.  Nothing here touches device data.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["RunTelemetry", "SCHEMA_VERSION", "events_path"]

SCHEMA_VERSION = 2

# in-memory cap for sink-less telemetry: events beyond it are counted
# (``dropped_events``) but not retained
_MAX_BUFFER = 100_000


def events_path(dirpath: str, proc: int = 0) -> str:
    """The event-stream file for process ``proc`` under a directory."""
    return os.path.join(os.fspath(dirpath), f"events-p{int(proc)}.jsonl")


class _Span:
    """Handle returned by :meth:`RunTelemetry.span`; ``fields`` may be
    extended inside the block, ``dur_s`` is valid after it."""

    __slots__ = ("name", "fields", "sid", "parent", "depth", "t0", "dur_s",
                 "_telem")

    def __init__(self, telem, name, fields):
        self._telem = telem
        self.name = name
        self.fields = fields
        self.dur_s = 0.0

    def __enter__(self):
        self._telem._open_span(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._telem._close_span(self)
        return False


class RunTelemetry:
    """Thread-safe event buffer and span aggregates."""

    def __init__(self, proc: int = 0, enabled: bool = True):
        self.proc = int(proc)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._sink_lock = threading.Lock()       # serialises disk flushes
        self._local = threading.local()          # per-thread span stack
        self._t0 = time.perf_counter()
        self._seq = 0
        self._sid = 0
        self._buffer: list[dict] = []
        self._sink_path: str | None = None
        self._spans: dict[str, dict] = {}        # name -> count/total/max
        self._trace = None                       # bound TraceContext | None
        self.n_events = 0
        self.dropped_events = 0

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def emit(self, kind: str, name: str, **fields) -> None:
        """Record one event (JSON-serialisable field values only)."""
        with self._lock:
            self._append_locked(kind, name, fields)

    def _append_locked(self, kind, name, fields) -> None:
        self.n_events += 1
        if not self.enabled:
            return
        if len(self._buffer) >= _MAX_BUFFER:
            self.dropped_events += 1
            return
        ev = {"seq": self._seq, "t": round(self._now(), 6),
              "wall": round(time.time(), 3), "proc": self.proc,
              "kind": kind, "name": name}
        if self._trace is not None:
            ev.update(self._trace.fields())
        ev.update(fields)
        self._seq += 1
        self._buffer.append(ev)

    def set_trace(self, ctx) -> None:
        """Bind a TraceContext (or ``None`` to unbind) for later events."""
        with self._lock:
            self._trace = ctx

    def _record(self, name, dur_s, fields) -> None:
        agg = self._spans.setdefault(
            name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += dur_s
        agg["max_s"] = max(agg["max_s"], dur_s)
        self._append_locked("span", name, fields)

    def observe(self, name: str, dur_s: float, **fields) -> None:
        """Record a pre-measured duration as a span, for stages whose start
        and end live on different threads (the engine's ``queue_wait``)."""
        dur_s = float(dur_s)
        with self._lock:
            fields = dict(fields, sid=self._sid, parent=None, depth=0,
                          thread=threading.get_ident(),
                          t0=round(self._now() - dur_s, 6),
                          dur_s=round(dur_s, 6))
            self._sid += 1
            self._record(name, dur_s, fields)

    def span(self, name: str, **fields) -> _Span:
        """Context manager timing one stage; nesting is tracked per
        thread."""
        return _Span(self, name, fields)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _open_span(self, sp: _Span) -> None:
        st = self._stack()
        with self._lock:
            sp.sid = self._sid
            self._sid += 1
        sp.parent = st[-1].sid if st else None
        sp.depth = len(st)
        st.append(sp)
        sp.t0 = self._now()

    def _close_span(self, sp: _Span) -> None:
        sp.dur_s = self._now() - sp.t0
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        with self._lock:
            fields = dict(sp.fields, sid=sp.sid, parent=sp.parent,
                          depth=sp.depth, thread=threading.get_ident(),
                          t0=round(sp.t0, 6), dur_s=round(sp.dur_s, 6))
            self._record(sp.name, sp.dur_s, fields)

    @property
    def has_sink(self) -> bool:
        return self._sink_path is not None

    def attach_sink(self, path: str, truncate: bool = False) -> None:
        """Bind the JSONL file :meth:`flush` appends to (``truncate``
        starts it fresh)."""
        path = os.fspath(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        if truncate:
            with open(path, "w"):
                pass
        self._sink_path = path

    def flush(self) -> None:
        """Append the buffered events to the sink (no-op without one); a
        failed write drops and counts them, never raises."""
        with self._sink_lock:
            with self._lock:
                if self._sink_path is None or not self._buffer:
                    return
                batch, self._buffer = self._buffer, []
            try:
                with open(self._sink_path, "a") as f:
                    for ev in batch:
                        f.write(json.dumps(ev) + "\n")
            except OSError:
                with self._lock:
                    self.dropped_events += len(batch)

    def totals(self) -> dict:
        """``{span name: {"count", "total_s", "max_s"}}`` so far."""
        with self._lock:
            return {k: dict(v) for k, v in self._spans.items()}
