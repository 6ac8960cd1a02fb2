"""Posterior serving on the card (port of ``hmsc_tpu/serve``): the
hand-written serving kernels, shape-bucketed micro-batching, and compacted
serving artifacts in the JAX package's format.

- :mod:`.kernels` — the linear predictor, marginal and conditional
  prediction over the B9a-c kernels (shared with offline ``predict``);
- :mod:`.artifact` — ``compact_posterior`` / ``load_artifact``: one
  contiguous draw-major block per parameter (optional bfloat16 with the
  cast error recorded);
- :mod:`.engine` — :class:`ServingEngine`: shape buckets, the LRU
  launch-plan cache, bounded-window micro-batching, telemetry spans;
- :mod:`.http` — ``python -m hmsc_tpu_torch serve``: stdlib HTTP + JSON.
"""

from .artifact import (ServingArtifact, compact_posterior, load_artifact,
                       load_run_posterior, resolve_run_epoch)
from .engine import DEFAULT_BUCKETS, ServingEngine
from .http import make_server, serve_main
from .kernels import (linear_predictor, make_conditional_kernel,
                      make_predict_kernel)

__all__ = [
    "ServingEngine", "DEFAULT_BUCKETS",
    "ServingArtifact", "compact_posterior", "load_artifact",
    "load_run_posterior", "resolve_run_epoch",
    "make_server", "serve_main",
    "linear_predictor", "make_predict_kernel", "make_conditional_kernel",
]
