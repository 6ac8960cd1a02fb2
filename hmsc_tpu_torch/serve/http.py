"""``python -m hmsc_tpu_torch serve`` — stdlib HTTP + JSON front end over
:class:`~hmsc_tpu_torch.serve.engine.ServingEngine` (port of
``hmsc_tpu/serve/http.py``).

``ThreadingHTTPServer`` handles each connection on its own thread, and
every handler thread funnels its query through ``engine.submit``, so
concurrent HTTP requests micro-batch into shared device calls exactly like
in-process callers.

Endpoints::

    POST /predict   {"X": [[...]], "units": {level: [...]}?, "Yc": ...?,
                     "expected": true?, "mcmc_step": 1?,
                     "quantiles": [0.05, 0.5, 0.95]?}
                    -> {"mean": [[...]], "sd": [[...]], "n_draws": N}
                       (+ "quantiles"/"q" when requested)
    POST /gradient  {"focal": "x1", "ngrid": 20?, "expected": true?}
    POST /flip      {"source": "<path>"?, "warmup": true?}  — admin: hot-
                    reload the served posterior and flip to it atomically
    GET  /healthz   liveness + posterior shape + generation
    GET  /statz     engine stats (counters, cache, span aggregates)
    GET  /metrics   501: the Prometheus export needs the report module
                    (ROADMAP A9)

A request carrying an ``X-Hmsc-Trace`` header joins the caller's trace.
"""

from __future__ import annotations

import json

__all__ = ["make_server", "serve_main"]


def _json_body(handler):
    n = int(handler.headers.get("Content-Length") or 0)
    raw = handler.rfile.read(n) if n else b"{}"
    try:
        doc = json.loads(raw.decode() or "{}")
    except ValueError as e:
        raise ValueError(f"request body is not valid JSON: {e}") from e
    if not isinstance(doc, dict):
        raise ValueError("request body must be a JSON object")
    return doc


def make_server(engine, host: str = "127.0.0.1", port: int = 0):
    """A ready-to-run ``ThreadingHTTPServer`` bound to ``engine`` (port 0
    picks a free port; read it back from ``server.server_address``)."""
    import http.server

    import numpy as np

    from ..obs.trace import from_header

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: ARG002 — BaseHTTP API
            pass

        def _send(self, code: int, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — BaseHTTP API
            if self.path == "/healthz":
                self._send(200, {"ok": True, "n_draws": engine.n_draws,
                                 "ns": engine.ns, "nc": engine.nc,
                                 "epoch": engine.epoch,
                                 "generation": engine.generation,
                                 "last_flip_wall": engine.last_flip_wall,
                                 "draw_shards": engine.draw_shards,
                                 "buckets": list(engine.buckets)})
            elif self.path == "/statz":
                self._send(200, engine.stats())
            elif self.path == "/metrics":
                self._send(501, {"error": "the Prometheus export needs the "
                                          "report module, not ported yet "
                                          "(ROADMAP A9)"})
            else:
                self._send(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):  # noqa: N802 — BaseHTTP API
            tctx = from_header(self.headers.get("X-Hmsc-Trace") or "")
            try:
                doc = _json_body(self)
                if self.path == "/predict":
                    X = np.asarray(doc["X"], dtype=np.float32)
                    Yc = doc.get("Yc")
                    if Yc is not None:
                        # JSON has no NaN literal: null marks unobserved
                        Yc = np.asarray(
                            [[np.nan if v is None else float(v) for v in row]
                             for row in Yc], dtype=np.float32)
                    out = engine.predict(
                        X, units=doc.get("units"), Yc=Yc,
                        expected=bool(doc.get("expected", True)),
                        mcmc_step=int(doc.get("mcmc_step", 1)),
                        quantiles=doc.get("quantiles"))
                elif self.path == "/gradient":
                    out = engine.gradient(
                        doc["focal"],
                        non_focal_variables=doc.get("non_focal"),
                        ngrid=int(doc.get("ngrid", 20)),
                        expected=bool(doc.get("expected", True)))
                elif self.path == "/flip":
                    self._send(200, engine.reload(
                        doc.get("source"),
                        warmup=bool(doc.get("warmup", True)),
                        trace=tctx))
                    return
                else:
                    self._send(404,
                               {"error": f"unknown path {self.path!r}"})
                    return
                if tctx is not None:
                    engine.telem.emit(
                        "metric", "query", path=self.path,
                        epoch=out.get("epoch"),
                        generation=out.get("generation"),
                        **tctx.fields())
                    if engine.telem.has_sink:
                        engine.telem.flush()
                self._send(200, {
                    "mean": np.asarray(out["mean"]).tolist(),
                    "sd": np.asarray(out["sd"]).tolist(),
                    **({"grid": np.asarray(out["grid"]).tolist()}
                       if "grid" in out else {}),
                    **({"quantiles": np.asarray(out["quantiles"]).tolist(),
                        "q": out["q"]}
                       if "quantiles" in out else {}),
                    "n_draws": engine.n_draws,
                    "generation": out["generation"],
                    "epoch": out["epoch"],
                    **({"trace": tctx.trace_id} if tctx is not None else {}),
                })
            except (KeyError, ValueError, NotImplementedError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:   # noqa: BLE001 — a failed query must
                # answer 500, never take down the server loop
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return http.server.ThreadingHTTPServer((host, int(port)), Handler)


def serve_main(argv=None) -> int:
    """``python -m hmsc_tpu_torch serve <artifact>`` — long-lived posterior
    serving from a compacted artifact directory (either package's)."""
    import argparse
    import logging
    import signal

    from .engine import DEFAULT_BUCKETS, ServingEngine

    ap = argparse.ArgumentParser(
        prog="python -m hmsc_tpu_torch serve",
        description="serve batched posterior predictions over HTTP from a "
                    "compacted serving artifact, on the CUDA card")
    ap.add_argument("source", help="compacted artifact directory "
                                   "(compact_posterior)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--buckets",
                    default=",".join(str(b) for b in DEFAULT_BUCKETS),
                    help="comma-separated padded query-row buckets")
    ap.add_argument("--coalesce-ms", type=float, default=2.0,
                    help="micro-batch coalescing window (milliseconds)")
    ap.add_argument("--draw-thin", type=int, default=1,
                    help="serve every Nth pooled draw")
    ap.add_argument("--telemetry-dir", default=None,
                    help="write the serving event stream "
                         "(events-p0.jsonl) here")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip building one predict plan per bucket at "
                         "startup")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    # the JAX package's fleet, heartbeat, Prometheus and draw-mesh options
    for flag in ("--fleet", "--heartbeat-dir", "--heartbeat-interval-s",
                 "--prom", "--draw-shards", "--replica-rank"):
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = [f for f in ("fleet", "heartbeat_dir", "heartbeat_interval_s",
                         "prom", "draw_shards", "replica_rank")
             if getattr(args, f) is not None]
    if given:
        raise NotImplementedError(
            f"serve: {', '.join('--' + g.replace('_', '-') for g in given)} "
            "(fleets, heartbeats, Prometheus export, draw meshes) are not "
            "ported yet (ROADMAP A9)")

    log = logging.getLogger("hmsc_tpu_torch.serve")
    engine = ServingEngine(
        args.source,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        coalesce_ms=args.coalesce_ms, draw_thin=args.draw_thin,
        telemetry=args.telemetry_dir, device=args.device)
    if not args.no_warmup:
        n = engine.warmup()
        log.info("serve: built %d predict plans (buckets %s)", n,
                 list(engine.buckets))
    server = make_server(engine, args.host, args.port)
    host, port = server.server_address[:2]
    log.info("serve: %d draws x %d species ready on http://%s:%d",
             engine.n_draws, engine.ns, host, port)

    def _term(signum, frame):  # noqa: ARG001 — signal API
        raise KeyboardInterrupt
    old_term = signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        log.info("serve: interrupted, shutting down")
    finally:
        signal.signal(signal.SIGTERM, old_term)
        server.server_close()
        engine.close()
    return 0
