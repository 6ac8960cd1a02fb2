"""Long-lived posterior serving engine (port of ``hmsc_tpu/serve/engine.py``):
open a fitted posterior once, answer batched prediction queries at low
latency on the card.

A fitted posterior is staged to the device once as one stacked (n_draws,
...) batch, and every query is answered by the hand-written serving
kernels (:mod:`~hmsc_tpu_torch.serve.kernels`: B9a fused predict, B9b
conditional refinement, B9c draw quantiles).  Three mechanisms keep the
device-call count low and the per-call work bounded:

- **Shape buckets.**  Query row counts are padded up to a small fixed set
  of bucket sizes, so any query size maps onto a handful of launch plans.
- **An LRU launch-plan cache.**  A plan is a bucket's preallocated pinned
  host and device buffers for one (config, bucket, staged shapes) key;
  entries beyond ``cache_size`` are evicted least-recently-used.
  ``stats()["cache"]`` counts hits and misses: after :meth:`warmup`,
  steady traffic at its configs builds no plan (zero misses).
- **Micro-batching.**  Concurrent queries are coalesced within a bounded
  window (``coalesce_ms``, or until the largest bucket fills) into one
  device call per bucket; results are split back per request.

**Epoch flips**: everything a query touches lives in one immutable
generation object, and :meth:`ServingEngine.reload` swaps the engine's
reference to it atomically; a request is dispatched against the
generation it was validated on.

The engine's worker thread launches on the engine's device and its own
CUDA stream; a request's future resolves only after its results' copy to
the host has synchronised.  Each device call draws a fresh Philox seed
from the engine's generator.  Nothing is captured in a CUDA graph yet
(ROADMAP).  Per-request telemetry: ``queue_wait`` / ``pad`` / ``dispatch``
/ ``fetch`` spans and an optional JSONL sink.
"""

from __future__ import annotations

import collections
import contextlib
import os
import queue as _queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..mcmc.sampler import resolve_device
from ..obs import RunTelemetry, events_path, inherit_or_mint
from .artifact import ServingArtifact, load_artifact, load_run_posterior
from .kernels import make_conditional_kernel, make_predict_kernel

__all__ = ["ServingEngine", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

_STOP = object()


class _Request:
    __slots__ = ("config", "n_rows", "arrays", "future", "t_submit",
                 "staged")

    def __init__(self, config, n_rows, arrays, future, staged):
        self.config = config          # kernel config key (kind + statics)
        self.n_rows = n_rows
        self.arrays = arrays          # dict of per-row host arrays
        self.future = future
        self.staged = staged          # the generation it was validated on
        self.t_submit = time.perf_counter()


class _Staged:
    """One immutable serving generation: the staged device tensors plus
    every piece of model metadata a query resolves against."""

    __slots__ = ("gen", "epoch", "hM", "artifact", "ns", "nc", "nr",
                 "n_draws", "fam", "any_probit", "any_normal",
                 "any_poisson", "level_names", "unit_lut", "new_unit",
                 "ym_host", "ys_host", "Beta", "sigma", "lams", "etas",
                 "fam_d", "ym", "ys", "shape_key")


class _Plan:
    """A bucket's launch plan: the kernel function and preallocated input
    and output buffers, host-side pinned on the card (one lock: the worker
    and :meth:`ServingEngine.warmup` may share a plan)."""

    def __init__(self, fn, st, config, bucket, device):
        self.fn = fn
        self.lock = threading.Lock()
        cuda = device.type == "cuda"
        b, ns = int(bucket), st.ns

        def pair(shape, dtype):
            host = torch.empty(shape, dtype=dtype, pin_memory=cuda)
            return host, (torch.empty(shape, dtype=dtype, device=device)
                          if cuda else host)

        self.X = pair((b, st.nc), torch.float32)
        self.uidx = pair((st.nr, b), torch.int32)
        self.cond = config[0] == "cond"
        if self.cond:
            self.Yc = pair((b, ns), torch.float32)
            self.mask = pair((b, ns), torch.float32)
        nq = len(config[2]) if config[0] == "predict" and len(config) > 2 \
            else 0
        self.outs = [pair((b, ns), torch.float32),
                     pair((b, ns), torch.float32)]
        if nq:
            self.outs.append(pair((nq, b, ns), torch.float32))
        self.event = torch.cuda.Event() if cuda else None


class ServingEngine:
    """Serve predictions from a fitted posterior (see module docstring).

    ``source`` is a :class:`~hmsc_tpu_torch.post.Posterior`, a
    :class:`~hmsc_tpu_torch.serve.artifact.ServingArtifact`, or the path
    of a compacted artifact directory (either package's).  ``hM`` is needed
    only for gradient queries on an artifact.  ``device=None`` serves on the
    card and raises without one; pass ``device="cpu"`` to run the kernels'
    plain versions.

    Serving scope: shared-design models without a reduced-rank term,
    random levels with unit loadings (``x_dim == 0``).  Queries at training
    units gather their posterior Eta rows; unknown units use the mean-field
    zero row (the ``predict_eta_mean`` semantics).  ``draw_shards > 1``
    (the draw axis over several cards) is ROADMAP A9.
    """

    def __init__(self, source, hM=None, *, buckets=DEFAULT_BUCKETS,
                 coalesce_ms: float = 2.0, cache_size: int = 32,
                 draw_thin: int = 1, draw_shards: int | None = None,
                 telemetry=None, seed: int = 0, device=None):
        if draw_shards is not None and int(draw_shards) > 1:
            raise NotImplementedError(
                "draw_shards > 1 (the posterior's draws over several cards) "
                "is not ported yet (ROADMAP A9)")
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.max_bucket = self.buckets[-1]
        self.coalesce_s = float(coalesce_ms) / 1e3
        self.cache_size = int(cache_size)
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # the worker thread selects the card by index
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._rng = np.random.default_rng(seed)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

        # falsy = aggregates only, True = in-memory events, a directory =
        # events + JSONL sink
        self.telem = RunTelemetry(proc=0, enabled=bool(telemetry))
        if telemetry:
            self.telem.set_trace(inherit_or_mint())
        if telemetry and not isinstance(telemetry, bool):
            self.telem.attach_sink(events_path(telemetry, 0), truncate=True)
            self.telem.emit("run", "serve_start", buckets=list(self.buckets),
                            coalesce_ms=float(coalesce_ms))

        self._source = source
        self._hM0 = hM
        self._draw_thin = int(draw_thin)
        self._reload_lock = threading.Lock()
        self._staged = self._build_staged(source, hM, self._draw_thin, 0)
        self._last_flip_wall = time.time()

        self._lock = threading.Lock()
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._hits = 0
        self._misses = 0
        self._n_requests = 0
        self._n_batches = 0
        self._n_device_calls = 0
        self._rows_served = 0
        self._rows_padded = 0

        self._queue: _queue.Queue = _queue.Queue()
        self._closed = False
        self._failed = None           # the worker's fatal error, if any
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="hmsc-serve-batcher")
        self._worker.start()

    # ------------------------------------------------------------------
    # generation accessors
    # ------------------------------------------------------------------

    @property
    def hM(self):
        return self._staged.hM

    @property
    def artifact(self):
        return self._staged.artifact

    @property
    def epoch(self):
        """The served epoch index (``None``: no run-directory source)."""
        return self._staged.epoch

    @property
    def generation(self) -> int:
        """Monotonic reload counter (0 = the initial staging)."""
        return self._staged.gen

    @property
    def last_flip_wall(self) -> float:
        return self._last_flip_wall

    @property
    def n_draws(self):
        return self._staged.n_draws

    @property
    def draw_shards(self) -> int:
        return 1

    @property
    def ns(self):
        return self._staged.ns

    @property
    def nc(self):
        return self._staged.nc

    @property
    def nr(self):
        return self._staged.nr

    @property
    def level_names(self):
        return list(self._staged.level_names)

    @property
    def any_probit(self):
        return self._staged.any_probit

    @property
    def any_normal(self):
        return self._staged.any_normal

    @property
    def any_poisson(self):
        return self._staged.any_poisson

    # ------------------------------------------------------------------
    # posterior staging
    # ------------------------------------------------------------------

    def _build_staged(self, source, hM, draw_thin, gen) -> _Staged:
        st = _Staged()
        st.gen = int(gen)
        st.epoch = None
        if isinstance(source, str) or hasattr(source, "__fspath__"):
            p = os.fspath(source)
            if not os.path.exists(os.path.join(p, "serving.json")):
                load_run_posterior(p, hM)          # raises: ROADMAP A9
            source = load_artifact(p)
        st.hM = hM

        if isinstance(source, ServingArtifact):
            meta = source.meta["model"]
            if meta["nc_rrr"] > 0 or meta["x_is_list"]:
                raise NotImplementedError(
                    "serving: reduced-rank terms and species-specific "
                    "designs are not servable — use hmsc_tpu_torch.predict "
                    "on the posterior")
            levels = source.meta["levels"]
            if any(lv["x_dim"] > 0 for lv in levels):
                raise NotImplementedError(
                    "serving: covariate-dependent random levels (xDim > 0) "
                    "are not servable")
            # stored(): bf16 artifacts stage their draws as bf16 (the
            # kernels widen in registers), f32 ones from the memmap
            pooled = {name: source.stored(name)[::draw_thin]
                      for name in (["Beta", "sigma"]
                                   + [f"Eta_{r}" for r in range(len(levels))]
                                   + [f"Lambda_{r}"
                                      for r in range(len(levels))])}
            st.ns = int(meta["ns"])
            st.nc = int(meta["nc"])
            st.fam = np.asarray(meta["distr"], dtype=np.int32)
            ym = np.asarray(meta["y_scale_m"], dtype=np.float32)
            ys = np.asarray(meta["y_scale_s"], dtype=np.float32)
            st.level_names = [lv["name"] for lv in levels]
            unit_lists = [lv["units"] for lv in levels]
            st.artifact = source
        else:                               # a Posterior
            post = source
            hM = st.hM = post.hM if hM is None else hM
            spec = post.spec
            if hM.nc_rrr > 0 or hM.x_is_list:
                raise NotImplementedError(
                    "serving: reduced-rank terms and species-specific "
                    "designs are not servable — use hmsc_tpu_torch.predict "
                    "on the posterior")
            if any(spec.levels[r].x_dim > 0 for r in range(spec.nr)):
                raise NotImplementedError(
                    "serving: covariate-dependent random levels (xDim > 0) "
                    "are not servable")
            pooled = {"Beta": post.pooled("Beta", thin=draw_thin),
                      "sigma": post.pooled("sigma", thin=draw_thin)}
            for r in range(spec.nr):
                pooled[f"Eta_{r}"] = post.pooled(f"Eta_{r}", thin=draw_thin)
                pooled[f"Lambda_{r}"] = post.pooled(f"Lambda_{r}",
                                                    thin=draw_thin)
            st.ns = int(hM.ns)
            st.nc = int(hM.nc)
            st.fam = np.asarray(hM.distr[:, 0], dtype=np.int32)
            m, s = hM.y_scale_par
            ym = np.asarray(m, dtype=np.float32)
            ys = np.asarray(s, dtype=np.float32)
            st.level_names = list(hM.rl_names)
            unit_lists = [list(hM.pi_names[r]) for r in range(spec.nr)]
            st.artifact = None

        st.nr = len(st.level_names)
        st.n_draws = int(pooled["Beta"].shape[0])
        st.any_probit = bool((st.fam == 2).any())
        st.any_normal = bool((st.fam == 1).any())
        st.any_poisson = bool((st.fam == 3).any())
        st.ym_host, st.ys_host = ym, ys
        # unit label -> Eta row; unknown labels get the appended zero row
        # (index np_r): the mean-field new-unit semantics
        st.unit_lut = [{str(u): i for i, u in enumerate(us)}
                       for us in unit_lists]
        st.new_unit = [len(us) for us in unit_lists]

        dev = self.device
        with self.telem.span("stage", n_draws=st.n_draws, gen=st.gen):
            def _stage(a):
                if torch.is_tensor(a):            # bf16 bits from stored()
                    return a.contiguous().to(dev)
                a = np.ascontiguousarray(a, dtype=np.float32)
                if not a.flags.writeable:         # a read-only memmap
                    a = a.copy()
                return torch.from_numpy(a).to(dev)

            st.Beta = _stage(pooled["Beta"])
            st.sigma = _stage(pooled["sigma"])
            lams, etas = [], []
            for r in range(st.nr):
                lam = _stage(pooled[f"Lambda_{r}"])
                if lam.dim() == 4:
                    lam = lam[..., 0].contiguous()
                lams.append(lam)
                eta = _stage(pooled[f"Eta_{r}"])
                zero = torch.zeros_like(eta[:, :1])
                etas.append(torch.cat([eta, zero], dim=1))
            st.lams = tuple(lams)
            st.etas = tuple(etas)
            st.fam_d = torch.from_numpy(st.fam).to(dev)
            st.ym = torch.from_numpy(ym).to(dev)
            st.ys = torch.from_numpy(ys).to(dev)
            if dev.type == "cuda":
                # the worker's stream reads what the default stream wrote
                torch.cuda.synchronize(dev)
        # launch plans are rebuilt only when a staged shape or dtype, or a
        # static of the kernels, changed: a same-shape flip reuses them
        st.shape_key = (
            (st.nr, st.any_probit, st.any_normal, st.any_poisson),
        ) + tuple((tuple(a.shape), str(a.dtype))
                  for a in (st.Beta, st.sigma, *st.lams, *st.etas))
        return st

    # ------------------------------------------------------------------
    # epoch flip
    # ------------------------------------------------------------------

    def reload(self, source=None, *, warmup: bool = True,
               trace=None) -> dict:
        """Hot-reload the served posterior and flip to it atomically.

        ``source=None`` re-stages the engine's original source; pass an
        explicit source to re-point the engine.  The new generation is
        fully staged (and, by default, its predict plans built when the
        staged shapes changed) before the swap, so the flip itself is one
        reference assignment: queries already submitted finish on the old
        generation.  Returns a summary dict."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        with self._reload_lock:
            old = self._staged
            src = self._source if source is None else source
            new = self._build_staged(
                src, self._hM0 if source is None else None,
                self._draw_thin, old.gen + 1)
            shapes_changed = new.shape_key != old.shape_key
            if shapes_changed and warmup:
                for b in self.buckets:
                    self._launch(new, ("predict", True),
                                 self._kernel(new, ("predict", True), b),
                                 *self._zero_args(new))
            self._staged = new                  # the atomic flip
            self._last_flip_wall = time.time()
            if source is not None:
                self._source = source
                self._hM0 = None
        self.telem.emit("run", "epoch_flip", gen=new.gen,
                        old_epoch=old.epoch, epoch=new.epoch,
                        n_draws=new.n_draws,
                        shapes_changed=bool(shapes_changed),
                        **(trace.fields() if trace is not None else {}))
        if self.telem.has_sink:
            self.telem.flush()
        return {"old_epoch": old.epoch, "epoch": new.epoch,
                "generation": new.gen, "n_draws": new.n_draws,
                "shapes_changed": bool(shapes_changed),
                "last_flip_wall": self._last_flip_wall}

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, X, *, units=None, Yc=None, expected: bool = True,
               mcmc_step: int = 1, quantiles=None) -> Future:
        """Enqueue one prediction query; returns a Future resolving to
        ``{"mean": (q, ns), "sd": (q, ns)}`` — plus ``{"quantiles":
        (nq, q, ns), "q": [...]}`` when ``quantiles`` is given.

        ``X`` is the (q, nc) design block (model scale, intercept
        included).  ``units`` optionally maps level name -> q unit labels
        (training labels gather their posterior Eta rows; unknown labels
        serve mean-field).  ``Yc`` (q, ns) with NaN for unobserved cells
        switches to conditional prediction refined by ``mcmc_step`` Gibbs
        iterations.  ``expected=False`` samples responses.  ``quantiles``
        (marginal prediction only) is a sequence of probabilities in
        [0, 1]; each distinct tuple is its own launch-plan config."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        st = self._staged
        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        q = X.shape[0]
        if X.shape[1] != st.nc:
            raise ValueError(
                f"query X has {X.shape[1]} columns, the model has "
                f"nc={st.nc} covariates (intercept included)")
        uidx = np.empty((st.nr, q), dtype=np.int32)
        for r in range(st.nr):
            lut, new = st.unit_lut[r], st.new_unit[r]
            if units is None or st.level_names[r] not in units:
                uidx[r] = new
            else:
                labels = units[st.level_names[r]]
                if len(labels) != q:
                    raise ValueError(
                        f"units[{st.level_names[r]!r}] has {len(labels)} "
                        f"labels for {q} query rows")
                uidx[r] = [lut.get(str(u), new) for u in labels]
        arrays = {"X": X, "uidx": uidx}
        qs = ()
        if quantiles is not None:
            qs = tuple(float(v) for v in np.atleast_1d(
                np.asarray(quantiles, dtype=np.float64)))
            if not qs or any(not (0.0 <= v <= 1.0) for v in qs):
                raise ValueError(
                    f"quantiles must be probabilities in [0, 1], got "
                    f"{quantiles!r}")
            if Yc is not None:
                raise NotImplementedError(
                    "serving: quantiles are marginal-prediction only "
                    "(conditional queries return mean/sd)")
        if Yc is not None:
            Yc = np.atleast_2d(np.asarray(Yc, dtype=np.float32))
            if Yc.shape != (q, st.ns):
                raise ValueError(
                    f"Yc has shape {Yc.shape}, expected ({q}, {st.ns})")
            if st.any_poisson:
                raise NotImplementedError(
                    "serving: conditional prediction conditions on probit/"
                    "normal cells only; Poisson models need the offline "
                    "predict(Yc=...) (ROADMAP A8b)")
            Ycs = (Yc - st.ym_host[None, :]) / st.ys_host[None, :]
            mask = (~np.isnan(Ycs)).astype(np.float32)
            arrays["Yc"] = np.nan_to_num(Ycs, nan=0.0).astype(np.float32)
            arrays["mask"] = mask
            config = ("cond", bool(expected), int(mcmc_step))
        elif qs:
            config = ("predict", bool(expected), qs)
        else:
            config = ("predict", bool(expected))
        req = _Request(config, q, arrays, Future(), st)
        with self._lock:
            self._n_requests += 1
        self._queue.put(req)
        if self._failed is not None:      # the worker is gone: no hang
            self._fail_queued()
        return req.future

    def predict(self, X, **kw) -> dict:
        """Synchronous :meth:`submit`."""
        return self.submit(X, **kw).result()

    def gradient(self, focal_variable: str, non_focal_variables=None,
                 ngrid: int = 20, expected: bool = True) -> dict:
        """Serve an environmental-gradient query: the
        :func:`~hmsc_tpu_torch.predict.construct_gradient` design for
        ``focal_variable``, answered through the predict plans (gradient
        units serve mean-field).  Returns ``{"grid", "mean", "sd"}``."""
        hM = self._staged.hM
        if hM is None:
            raise ValueError(
                "gradient queries need the fitted Hmsc model (formula + "
                "training covariates); construct the engine with hM=")
        from ..predict.gradient import construct_gradient
        from ..utils.formula import design_matrix

        grad = construct_gradient(hM, focal_variable,
                                  non_focal_variables, ngrid=ngrid)
        Xn, _ = design_matrix(hM.x_formula, grad["XDataNew"])
        out = self.predict(np.asarray(Xn, dtype=np.float32),
                           expected=expected)
        out["grid"] = np.asarray(grad["XDataNew"][focal_variable])
        return out

    def warmup(self, *, expected: bool = True, conditional: bool = False,
               mcmc_step: int = 1) -> int:
        """Build one launch plan per bucket for the given config (and the
        conditional one when asked) and launch it once, so a first query
        finds its plan ready.  Returns the number of plans built."""
        st = self._staged
        built = 0
        configs = [("predict", bool(expected))]
        if conditional:
            configs.append(("cond", bool(expected), int(mcmc_step)))
        for config in configs:
            for b in self.buckets:
                with self._lock:
                    fresh = (config, b, st.shape_key) not in self._cache
                plan = self._kernel(st, config, b)
                if fresh:
                    built += 1
                    self._launch(st, config, plan, *self._zero_args(st))
        return built

    def stats(self) -> dict:
        """Serving counters, launch-plan cache counts, span aggregates."""
        st = self._staged
        with self._lock:
            cache = {"hits": self._hits, "misses": self._misses,
                     "size": len(self._cache),
                     "capacity": self.cache_size}
            counts = {"requests": self._n_requests,
                      "batches": self._n_batches,
                      "device_calls": self._n_device_calls,
                      "rows_served": self._rows_served,
                      "rows_padded": self._rows_padded}
        return {"n_draws": st.n_draws, "ns": st.ns,
                "epoch": st.epoch, "generation": st.gen,
                "last_flip_wall": self._last_flip_wall,
                "buckets": list(self.buckets),
                "coalesce_ms": self.coalesce_s * 1e3,
                "device": str(self.device),
                "draw_shards": 1, "n_devices": 1, "mesh": None,
                "cache": cache, **counts,
                "spans": self.telem.totals()}

    def close(self) -> None:
        """Stop the batching worker (pending requests fail)."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(_STOP)
        self._worker.join(timeout=10.0)
        while True:
            try:
                item = self._queue.get_nowait()
            except _queue.Empty:
                break
            if item is not _STOP and not item.future.done():
                item.future.set_exception(
                    RuntimeError("ServingEngine closed"))
        self.telem.flush()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # ------------------------------------------------------------------
    # launch plans
    # ------------------------------------------------------------------

    def _kernel(self, st, config, bucket: int) -> _Plan:
        key = (config, int(bucket), st.shape_key)
        with self._lock:
            plan = self._cache.get(key)
            if plan is not None:
                self._hits += 1
                self._cache.move_to_end(key)
                return plan
            self._misses += 1
        if config[0] == "predict":
            q = config[2] if len(config) > 2 else ()
            fn = make_predict_kernel(nr=st.nr, expected=config[1],
                                     quantiles=q)
        else:
            fn = make_conditional_kernel(nr=st.nr, mcmc_step=config[2],
                                         expected=config[1])
        plan = _Plan(fn, st, config, bucket, self.device)
        self.telem.emit("metric", "kernel_build",
                        config=list(map(str, config)), bucket=int(bucket))
        with self._lock:
            self._cache[key] = plan
            self._cache.move_to_end(key)
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)
        return plan

    def _bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if b >= rows:
                return b
        return self.max_bucket

    def _zero_args(self, st):
        """A warmup launch's arguments: no query rows (all padding)."""
        return (0, np.zeros((0, st.nc), np.float32),
                np.zeros((st.nr, 0), np.int32),
                np.zeros((0, st.ns), np.float32),
                np.zeros((0, st.ns), np.float32))

    def _launch(self, st, config, plan, n, X, uidx, Yc=None, mask=None):
        """One device call through a plan: rows ``[:n]`` filled from the
        query block, the rest padded (zero covariates, the mean-field unit);
        returns host copies of the outputs' first ``n`` rows."""
        seed = int(self._rng.integers(0, 2**31 - 1))
        with plan.lock:
            Xh, uh = plan.X[0].numpy(), plan.uidx[0].numpy()
            Xh[:n] = X
            Xh[n:] = 0.0
            uh[:] = np.asarray(st.new_unit, dtype=np.int32).reshape(-1, 1)
            uh[:, :n] = uidx
            ins = [plan.X, plan.uidx]
            if plan.cond:
                for buf, a in ((plan.Yc, Yc), (plan.mask, mask)):
                    h = buf[0].numpy()
                    h[:n] = a
                    h[n:] = 0.0
                    ins.append(buf)
            on_card = self.device.type == "cuda"
            with (torch.cuda.stream(self._stream) if on_card
                  else contextlib.nullcontext()):
                for host, d in ins:
                    if d is not host:
                        d.copy_(host, non_blocking=True)
                args = (st.Beta, st.sigma, st.lams, st.etas, st.fam_d,
                        st.ym, st.ys, plan.X[1], plan.uidx[1])
                if plan.cond:
                    args = args + (plan.Yc[1], plan.mask[1])
                plan.fn(*args, seed, out=[d for _, d in plan.outs])
                for host, d in plan.outs:
                    if d is not host:
                        host.copy_(d, non_blocking=True)
                if plan.event is not None:
                    plan.event.record()
            if plan.event is not None:
                plan.event.synchronize()
            res = [h.numpy() for h, _ in plan.outs]
            return ([res[0][:n].copy(), res[1][:n].copy()]
                    + ([res[2][:, :n].copy()] if len(res) > 2 else []))

    # ------------------------------------------------------------------
    # coalescing worker
    # ------------------------------------------------------------------

    def _fail_queued(self) -> None:
        err = RuntimeError(f"ServingEngine worker failed: {self._failed!r}")
        while True:
            try:
                item = self._queue.get_nowait()
            except _queue.Empty:
                return
            if item is not _STOP and not item.future.done():
                item.future.set_exception(err)

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._serve()
        except BaseException as e:
            # a dead worker fails every queued future, never leaves one
            # waiting; the error still reaches the thread's excepthook
            self._failed = e
            self._fail_queued()
            raise

    def _serve(self) -> None:
        pending: collections.deque = collections.deque()
        while True:
            item = pending.popleft() if pending else self._queue.get()
            if item is _STOP:
                break
            batch, rows = [item], item.n_rows
            deadline = time.perf_counter() + self.coalesce_s
            stop = False
            while rows < self.max_bucket:
                wait = deadline - time.perf_counter()
                if wait <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=wait)
                except _queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                # same config AND generation: a batch never mixes epochs
                if nxt.config == item.config \
                        and nxt.staged is item.staged:
                    batch.append(nxt)
                    rows += nxt.n_rows
                else:
                    pending.append(nxt)
                    break
            try:
                self._dispatch(batch)
            except Exception as e:   # noqa: BLE001 — a query fails its
                # futures, never the serving loop
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)
            if stop:
                break
        while pending:
            req = pending.popleft()
            req.future.set_exception(RuntimeError("ServingEngine closed"))

    def _dispatch(self, batch: list) -> None:
        st = batch[0].staged
        config = batch[0].config
        now = time.perf_counter()
        for req in batch:
            self.telem.observe("queue_wait", now - req.t_submit,
                               rows=req.n_rows)
        total = sum(req.n_rows for req in batch)
        cond = config[0] == "cond"
        with self.telem.span("pad", rows=total) as sp:
            X = np.concatenate([req.arrays["X"] for req in batch], axis=0)
            uidx = np.concatenate([req.arrays["uidx"] for req in batch],
                                  axis=1)
            Yc = mask = None
            if cond:
                Yc = np.concatenate([req.arrays["Yc"] for req in batch])
                mask = np.concatenate([req.arrays["mask"] for req in batch])
            calls = []
            for c0 in range(0, total, self.max_bucket):
                n = min(self.max_bucket, total - c0)
                calls.append((c0, n, self._bucket_for(n)))
            sp.fields["padded"] = sum(b - n for _, n, b in calls)

        outs = []
        for c0, n, b in calls:
            plan = self._kernel(st, config, b)
            with self.telem.span("dispatch", bucket=b, rows=n):
                sl = slice(c0, c0 + n)
                outs.append(self._launch(
                    st, config, plan, n, X[sl], uidx[:, sl],
                    None if Yc is None else Yc[sl],
                    None if mask is None else mask[sl]))
        with self.telem.span("fetch", rows=total):
            mean = np.concatenate([o[0] for o in outs], axis=0)
            sd = np.concatenate([o[1] for o in outs], axis=0)
            has_q = len(outs[0]) > 2
            quants = (np.concatenate([o[2] for o in outs], axis=1)
                      if has_q else None)

        with self._lock:
            self._n_batches += 1
            self._n_device_calls += len(calls)
            self._rows_served += total
            self._rows_padded += sum(b - n for _, n, b in calls)
        off = 0
        for req in batch:
            res = {"mean": mean[off:off + req.n_rows],
                   "sd": sd[off:off + req.n_rows],
                   "generation": st.gen, "epoch": st.epoch}
            if has_q:
                res["quantiles"] = quants[:, off:off + req.n_rows]
                res["q"] = list(config[2])
            req.future.set_result(res)
            off += req.n_rows
        if self.telem.has_sink:
            self.telem.flush()
