"""Serving kernels (port of ``hmsc_tpu/serve/kernels.py``): plain functions
on tensors that call the hand-written kernels of :mod:`hmsc_tpu_torch.ops.serve`
(B9a fused predict, B9b conditional refinement, B9c draw quantiles) — the
kernel for tensors on the card, its plain PyTorch version for tensors on
the CPU.

- :func:`linear_predictor` — the (n_draws, ny, ns) linear predictor (B9a
  with the identity link and no back-scaling);
- :func:`make_predict_kernel` — marginal prediction for a query block:
  Eta rows gathered per query unit (a reserved zero row serves mean-field
  "new unit" queries), linear predictor, link, back-scaling, mean and sd
  over draws, and optionally full-draw quantiles;
- :func:`make_conditional_kernel` — conditional prediction: each query
  row's factors refreshed by ``mcmc_step`` Gibbs iterations of (Eta, Z)
  against its observed cells (reference ``predict.R:181-198``).

The JAX factories take the families present (``any_probit`` ...) as
static structure; the kernels here branch per column on the family codes,
so the factories take only what changes the launches.  The draw-sharded
variants (``make_sharded_*``) wait for ROADMAP A9.
"""

from __future__ import annotations

import torch

from ..ops.serve import (FAM_NORMAL, draw_quantiles, serve_conditional,
                         serve_predict)

__all__ = ["linear_predictor", "make_predict_kernel",
           "make_conditional_kernel"]


def linear_predictor(Xn, x_is_list, Beta, *, nc_nrrr=None, XRRR=None,
                     wRRR=None, etas=(), pis=(), xrows=(), lams=()):
    """(n_draws, ny, ns) linear predictor ``X Beta + sum_r Eta_r[pi_r]
    Lambda_r`` for a shared design (tensors on one device; ``pis`` the
    per-level row indices into ``etas``).  Per-species designs, the
    reduced-rank term and covariate-dependent levels raise, naming their
    ROADMAP items."""
    if x_is_list:
        raise NotImplementedError("per-species X lists are not ported yet "
                                  "(ROADMAP A5)")
    if XRRR is not None or wRRR is not None or nc_nrrr is not None:
        raise NotImplementedError("reduced-rank regression is not ported "
                                  "yet (ROADMAP A7)")
    if any(l.dim() == 4 for l in lams) or any(
            x is not None and x.shape[-1] > 1 for x in xrows):
        raise NotImplementedError("covariate-dependent random levels "
                                  "(x_dim > 0) are not ported yet "
                                  "(ROADMAP A5)")
    ns = Beta.shape[2]
    dev = Beta.device
    fam = torch.full((ns,), FAM_NORMAL, dtype=torch.int32, device=dev)
    zero = torch.zeros(ns, dtype=torch.float32, device=dev)
    uidx = (torch.stack([torch.as_tensor(p, device=dev) for p in pis])
            .to(torch.int32) if pis else
            torch.zeros((0, Xn.shape[0]), dtype=torch.int32, device=dev))
    sigma = torch.ones(Beta.shape[0], ns, dtype=Beta.dtype, device=dev)
    _, _, L = serve_predict(Xn, uidx.contiguous(), Beta, sigma, list(lams),
                            list(etas), fam, zero, zero + 1.0,
                            expected=True, moments=False, draws=True)
    return L


def make_predict_kernel(*, nr: int, expected: bool, quantiles: tuple = ()):
    """Marginal prediction for one padded query block.

    Returns ``fn(Beta, sigma, lams, etas, fam, ym, ys, X, unit_idx, seed,
    out=None) -> (mean, sd[, qs])`` with ``Beta (n, nc, ns)``, ``sigma (n,
    ns)``, ``lams[r] (n, nf_r, ns)``, ``etas[r] (n, np_r + 1, nf_r)`` (the
    last row all zero: the mean-field new unit), ``X (B, nc)``,
    ``unit_idx (nr, B)`` int32 rows into each level's Eta, and ``seed``
    keying the sampled responses.  ``out`` optionally holds preallocated
    (mean, sd[, qs]).  A non-empty ``quantiles`` adds the (nq, B, ns)
    full-draw quantiles (B9c over B9a's draws)."""
    quantiles = tuple(float(q) for q in quantiles)

    def kernel(Beta, sigma, lams, etas, fam, ym, ys, X, unit_idx, seed,
               out=None):
        if len(lams) != nr:
            raise ValueError(f"predict kernel built for {nr} levels, got "
                             f"{len(lams)}")
        mean, sd, y = serve_predict(
            X, unit_idx, Beta, sigma, list(lams), list(etas), fam, ym, ys,
            expected=expected, draws=bool(quantiles), seed=seed,
            out=None if out is None else out[:2])
        if quantiles:
            qs = draw_quantiles(y, quantiles,
                                out=None if out is None else out[2])
            return mean, sd, qs
        return mean, sd

    return kernel


def make_conditional_kernel(*, nr: int, mcmc_step: int, expected: bool):
    """Conditional prediction: refine each query row's latent factors
    against its observed ``Yc`` cells, then predict.

    Signature ``fn(Beta, sigma, lams, etas, fam, ym, ys, X, unit_idx, Yc,
    mask, seed, out=None) -> (mean, sd)``; ``Yc (B, ns)`` is on the model's
    (y-scaled) Z scale with NaNs zeroed, ``mask (B, ns)`` is 1 on observed
    cells.  Each query row is its own unit in every level: its factors
    start from the gathered posterior rows (zeros for new units) under the
    N(0, 1) prior, exact for non-spatial levels.  Probit and normal observed
    cells condition; other families contribute no likelihood weight."""

    def kernel(Beta, sigma, lams, etas, fam, ym, ys, X, unit_idx, Yc, mask,
               seed, out=None):
        if len(lams) != nr:
            raise ValueError(f"conditional kernel built for {nr} levels, "
                             f"got {len(lams)}")
        return serve_conditional(X, unit_idx, Yc, mask, Beta, sigma,
                                 list(lams), list(etas), fam, ym, ys,
                                 mcmc_step=mcmc_step, expected=expected,
                                 seed=seed, out=out)

    return kernel
