"""Serving telemetry for the port: the event stream and trace contexts
(copies of the JAX package's standard-library ``obs/events.py`` and
``obs/trace.py`` parts the serving engine uses)."""

from .events import RunTelemetry, SCHEMA_VERSION, events_path
from .trace import TraceContext, from_header, inherit_or_mint

__all__ = ["RunTelemetry", "SCHEMA_VERSION", "events_path", "TraceContext",
           "from_header", "inherit_or_mint"]
