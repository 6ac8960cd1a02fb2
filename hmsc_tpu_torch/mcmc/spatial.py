"""Spatially structured latent factors: the Eta draws and the GP-range
(alpha) grid sampler (port of ``hmsc_tpu/mcmc/spatial.py``; reference
``R/updateEta.R:110-196``, ``R/updateAlpha.R:3-86``).  Chains are the
leading batch axis.

- ``Full`` — exact GP: the (nf np)^2 coupled precision (block-diagonal
  iW(alpha_h) plus the per-unit factor coupling) is assembled densely and
  factorised (``chol_spd`` + ``sample_mvn_prec``: library factorisations,
  as the JAX package leaves them to XLA).
- ``NNGP`` — the Vecchia precision, stored as neighbour-index/coefficient
  grids.  Up to ``_NNGP_DENSE_MAX`` coefficients (np nf) the precision is
  densified (kernel B8c writes iW = RiW' RiW in one launch) and drawn like
  Full; above it a matrix-free conjugate-gradient sampler
  applies the factor only (kernel B8a): perturbation optimisation, so the
  solution has the full conditional's law up to the CG tolerance, warm
  started from the current Eta.
- ``GPP`` — the knot-based predictive process: the precision ``P = A - M
  F^{-1} M'`` by double Woodbury, with per-unit nf x nf blocks ``A``
  (kernel B8d-1 writes their inverses and factors) and the (nf nK)^2 knot
  correction ``H`` (kernel B8d-2); ``H``'s Cholesky and its triangular
  solves are library calls, as the JAX package leaves them to XLA, but in
  float64: ``H``'s condition number reaches ~2e7 at a large alpha, and in
  float32 (the JAX package's) the draw is off by a few percent of its
  standard deviation there.  At
  alpha = 0 a factor's knot terms are switched off (``idD = 1``, ``M1 =
  0``: ``W = I``).

The alpha sampler and the interweaving moves read the prior quadratics
``eta' iW eta`` over the alpha grid or at each factor's alpha: batched
products for Full, kernel B8b for NNGP, kernel B8d-3 for GPP.

Under a precision policy (the EtaSpatial and Interweave blocks of the
spatial class, :mod:`hmsc_tpu_torch.mcmc.precision`) the level's grids are
read from their bfloat16 shadows (``mixed.staged_level``), as the JAX
package's policy'd blocks read them: Full gathers iW from its shadow and
widens it; dense NNGP and the at-alpha NNGP quadratics run B8c's and B8b's
bf16-grid forms; GPP widens the staged ``idDg`` back to float32 and runs
B8d-1..3 unchanged on it (the float64 knot grids are not staged:
``precision.py``, C4).  The CG draw (B8a) reads the float32
grids, as the JAX ``vecchia_ops`` does.

On the card the whole CG draw (the right-hand side, the loop, the true
residual) is one launch of kernel B8a, each chain's cluster stopping at
its own convergence, with no host read.  On the CPU the loop runs on the
host: it reads the chains' convergence back with one ``.item()`` at a
time, and chains that have converged are frozen (their iterates no longer
change), which is what the JAX package's ``while_loop`` does under
``vmap``.  The first read comes at the largest per-chain count of the
level's previous draw (warm started, consecutive draws need similar
counts), the next ones every ``_CG_CHECK_EVERY`` iterations after it.  A
CG draw appends its counts to the caller's ``cg_log`` list when one is
given (``sample_mcmc`` reports them; on the CPU the next draw of the level
reads its first check there; on the card they stay on the device until
the run ends).

On a site mesh (``shard=``, the JAX package's site branches) an NNGP
level's rows are split over the ranks: the CG draw's loop runs on the host
(``cg_frozen``), each ``P x`` one launch pair of kernel B8e on the rank's
rows and one ``all_reduce`` of the full-width partials, the iterate full
width and replicated; the dense draw gathers the grids at each factor's
alpha and runs B8c as on one card; the prior quadratics run B8b over the
rank's units and sum the partials over the ranks.  Full and GPP levels are
refused on a site mesh before the first sweep.
"""

from __future__ import annotations

import torch

from ..ops import mixed
from ..ops.linalg import chol_spd, sample_mvn_prec
from ..ops.spatial import (cg_frozen, gpp_knot, gpp_m1_at, gpp_quad_at,
                           gpp_quad_grid, gpp_unit, nngp_quad_at,
                           nngp_quad_grid, nngp_riw_dense, vecchia_cg,
                           vecchia_pmv, vecchia_riw_t, vecchia_site_pmv,
                           vecchia_site_riw_t)
from .structs import GibbsState, LevelState, ModelData, ModelSpec
from .updaters import _level_gram, _noise, _site, lambda_effective

__all__ = ["update_eta_spatial", "update_alpha", "vecchia_cg_draw",
           "gpp_factor", "gpp_draw", "eta_quad_grid", "eta_quad_at",
           "eta_ones_forms_at"]

# above this many (units x factors) coefficients, NNGP Eta switches from the
# dense joint Cholesky to the matrix-free CG sampler (the JAX package's
# crossover, hmsc_tpu/mcmc/spatial.py:52); the tests set it to reach CG at
# small sizes
_NNGP_DENSE_MAX = 256
# the JAX package's CG contract (spatial.py:290-349)
CG_TOL = 1e-5
CG_MAXITER = 500
# iterations between two host reads of the chains' convergence, after the
# first read
_CG_CHECK_EVERY = 8


# ---------------------------------------------------------------------------
# the Eta draws
# ---------------------------------------------------------------------------

def update_eta_spatial(spec: ModelSpec, data: ModelData, state: GibbsState,
                       r: int, rng=None, S=None, noise=None,
                       cg_log: list | None = None,
                       shard=None) -> LevelState:
    """Eta_r | rest for a spatial level.  ``noise``: the dense draws
    ``{"eps": (C, nf np)}`` (factor-major), for the CG sampler ``{"eps1":
    (C, np, nf), "xi": (C, ny, ns)}``, for GPP ``{"eps1": (C, np, nf),
    "eps2": (C, nf nK)}`` (full width on a site mesh too).  A CG draw
    appends ``(r, iterations the loop ran, the largest per-chain count,
    per-chain iterations (C,))`` to ``cg_log``."""
    lvd, lv, ls = data.levels[r], state.levels[r], spec.levels[r]
    if _site(shard) and ls.spatial != "NNGP":
        raise NotImplementedError(f"a {ls.spatial} level on a site mesh is "
                                  "not ported yet (ROADMAP A9.3d)")
    if ls.spatial == "GPP":
        return _eta_gpp(spec, data, state, r, rng, S, noise)
    npr, nf = ls.n_units, ls.nf_max
    if ls.spatial == "NNGP" and npr * nf > _NNGP_DENSE_MAX:
        if _site(shard):
            return _eta_nngp_cg_site(spec, data, state, r, rng, S, noise,
                                     shard, cg_log=cg_log)
        return _eta_nngp_cg(spec, data, state, r, rng, S, noise,
                            cg_log=cg_log)
    LiSL, F = _level_gram(spec, data, lvd, ls, lv, state.iSigma, S, shard)
    C = F.shape[0]
    if ls.spatial == "Full":
        iWg = mixed.staged_level("iWg", r, lvd.iWg)
        iW = iWg[lv.alpha_idx.long()].to(F.dtype)        # (C, nf, np, np)
    else:
        iW = _nngp_dense_iW(lvd, lv.alpha_idx, r, shard)

    # the (nf np)^2 precision, factor-major: blkdiag(iW_h) + the unit-
    # diagonal factor coupling LiSL_u at (h np + u, g np + u)
    big = F.new_zeros((C, nf, npr, nf, npr))
    for h in range(nf):
        big[:, h, :, h, :] = iW[:, h]
    ui = torch.arange(npr, device=F.device)
    # the indexed view is (np, C, nf, nf): advanced indices move first
    big[:, :, ui, :, ui] += LiSL.transpose(0, 1)
    big = big.reshape(C, nf * npr, nf * npr)
    rhs = F.transpose(1, 2).reshape(C, nf * npr)         # factor-major vec
    L = chol_spd(big)
    eps = _noise(noise, "eps", lambda: rng.normal(rhs.shape, rhs.dtype))
    eta = sample_mvn_prec(L, rhs, eps).reshape(C, nf, npr).transpose(1, 2)
    # on a site mesh the dense solve runs replicated on the full-width
    # grams with the replicated draw; the rank keeps its units
    if _site(shard):
        return lv.replace(Eta=shard.slice_site(eta, 1))
    return lv.replace(Eta=eta.contiguous())


def _staged_nngp(lvd, r):
    """The level's NNGP grids as a policy'd block reads them: ``(coef,
    D)``, the bfloat16 shadows where staged (else the level's own)."""
    return (mixed.staged_level("nn_coef", r, lvd.nn_coef),
            mixed.staged_level("nn_D", r, lvd.nn_D))


def _gpp_level(lvd, r):
    """The GPP level as a policy'd block reads it: ``idDg`` its bf16 shadow
    widened back to float32 where staged (the float64 knot grids are never
    staged, ``precision.py``, C4), else the level itself."""
    idD = mixed.staged_level("idDg", r, lvd.idDg)
    return lvd if idD is lvd.idDg else lvd.replace(idDg=idD.float())


def _nngp_dense_iW(lvd, alpha_idx, r=0, shard=None):
    """iW = RiW' RiW for each chain's factors, (C, nf, np, np): kernel B8c,
    its gram included (its bf16-grid form from staged grids).  On a site
    mesh the rank holds a block of the grids: the coefficients and
    variances at each factor's alpha are gathered to full width and B8c
    reads them as a grid of C nf points, point ``c nf + f`` the chain's
    factor's, with the level's whole neighbour structure
    (``LevelData.nn_full``)."""
    if _site(shard):
        a = alpha_idx.long()
        C, nf = alpha_idx.shape
        coef = shard.gather_site(lvd.nn_coef[a], 2)      # (C, nf, np, k)
        D = shard.gather_site(lvd.nn_D[a], 2)            # (C, nf, np)
        nn_idx, nn_n, rev_ptr, rev_pos = lvd.nn_full
        full = lvd.replace(nn_idx=nn_idx, nn_n=nn_n, rev_ptr=rev_ptr,
                           rev_pos=rev_pos,
                           nn_coef=coef.reshape(C * nf, *coef.shape[2:]),
                           nn_D=D.reshape(C * nf, -1))
        points = torch.arange(C * nf, dtype=torch.int32,
                              device=alpha_idx.device).reshape(C, nf)
        return nngp_riw_dense(full, points)
    coef, D = _staged_nngp(lvd, r)
    return nngp_riw_dense(lvd, alpha_idx.contiguous(), coef, D)


def _eta_nngp_cg(spec, data, state, r, rng, S, noise, tol=CG_TOL,
                 maxiter=CG_MAXITER, cg_log=None):
    """Matrix-free NNGP Eta draw (the JAX package's ``_eta_nngp_cg``).

    The full-conditional precision is ``P = blkdiag_f(RiW_f' RiW_f) +
    unitdiag(LiSL_u)``.  Solving ``P x = F + RiW' eps1 + sum_rows lam
    sqrt(iSigma) xi`` gives a draw from ``N(P^{-1} F, P^{-1})``: the two
    perturbations have covariances equal to the prior and likelihood terms
    of P.  A draw whose relative residual stays at ``max(100 tol, 1e-3)``
    or above is poisoned to NaN, so that the sampler reports the chain."""
    lvd, lv, ls = data.levels[r], state.levels[r], spec.levels[r]
    npr, nf = ls.n_units, ls.nf_max
    LiSL, F = _level_gram(spec, data, lvd, ls, lv, state.iSigma, S)
    LiSL = LiSL.contiguous()
    lam = lambda_effective(lv)[..., 0]                   # (C, nf, ns)
    C = F.shape[0]
    alpha = lv.alpha_idx.contiguous()
    eps1 = _noise(noise, "eps1", lambda: rng.normal((C, npr, nf), F.dtype))
    xi = _noise(noise, "xi", lambda: rng.normal(S.shape, F.dtype))
    w = xi * torch.sqrt(state.iSigma)[:, None, :]
    if spec.has_na:
        w = w * data.Ymask
    b_like = F.new_zeros((C, npr, nf))
    b_like.index_add_(1, lvd.pi_row, w @ lam.transpose(1, 2))
    if F.is_cuda:
        # one launch, each chain to its own count; the counts stay on the
        # device (iterations the loop ran = the largest count)
        eta, res, chain_iters = vecchia_cg(
            lvd, alpha, LiSL, F.contiguous(), eps1.contiguous(), b_like,
            lv.Eta.contiguous(), tol, maxiter)
        iters = kmax = chain_iters.max()
    else:
        b = F + vecchia_riw_t(lvd, alpha, eps1.contiguous()) + b_like
        first = next((e[2] for e in reversed(cg_log or ()) if e[0] == r), 0)
        eta, res, iters, kmax, chain_iters = vecchia_cg_draw(
            lambda x: vecchia_pmv(lvd, alpha, x, LiSL), b,
            lv.Eta.contiguous(), tol, maxiter, first_check=first)
    if cg_log is not None:
        cg_log.append((r, iters, kmax, chain_iters))
    thresh = max(100.0 * tol, 1e-3)       # scales with the requested tol
    eta = torch.where((res < thresh)[:, None, None], eta, float("nan"))
    return lv.replace(Eta=eta)


def _eta_nngp_cg_site(spec, data, state, r, rng, S, noise, shard,
                      tol=CG_TOL, maxiter=CG_MAXITER, cg_log=None):
    """:func:`_eta_nngp_cg` on a site mesh (the JAX package's site branch
    of ``_eta_nngp_cg``): the rank holds a block of the level's rows.  The
    grams are summed over the ranks, the prior perturbation ``RiW' eps1``
    is B8e's ``riw_t`` form on the rank's rows of a full-width draw plus
    one ``all_reduce``, and the CG loop runs on the host
    (:func:`vecchia_cg_draw`) with ``P x`` = B8e's ``pmv`` form plus one
    ``all_reduce``: the iterate, the residuals and the scalars are full
    width and the same on every rank, so every rank reads the same
    convergence at the same iterations.  The rank keeps its units of the
    draw."""
    lvd, lv, ls = data.levels[r], state.levels[r], spec.levels[r]
    npr, nf = ls.n_units, ls.nf_max
    off = shard.site_offset(npr)
    LiSL, F = _level_gram(spec, data, lvd, ls, lv, state.iSigma, S, shard)
    LiSL_l = shard.slice_site(LiSL, 1)
    lam = lambda_effective(lv)[..., 0]                   # (C, nf, ns)
    C = F.shape[0]
    alpha = lv.alpha_idx.contiguous()
    # the rank's rows of full-width draws (injected ones are full width)
    site_draw = lambda key, shape: (
        shard.normal(rng, shape, F.dtype, 1) if noise is None
        else shard.slice_site(noise[key], 1))
    eps1 = site_draw("eps1", (C, npr, nf))
    xi = site_draw("xi", (C, shard.ny, spec.ns))
    w = xi * torch.sqrt(state.iSigma)[:, None, :]
    b_like = F.new_zeros((C, npr, nf))
    b_like.index_add_(1, lvd.pi_row, w @ lam.transpose(1, 2))
    b_like = shard.psum_site(b_like)
    b = F + shard.psum_site(vecchia_site_riw_t(lvd, alpha, eps1, npr,
                                               off)) + b_like
    first = next((e[2] for e in reversed(cg_log or ()) if e[0] == r), 0)
    eta, res, iters, kmax, chain_iters = vecchia_cg_draw(
        lambda x: shard.psum_site(vecchia_site_pmv(lvd, alpha, x, LiSL_l,
                                                   off)),
        b, shard.gather_site(lv.Eta, 1), tol, maxiter, first_check=first)
    if cg_log is not None:
        cg_log.append((r, iters, kmax, chain_iters))
    thresh = max(100.0 * tol, 1e-3)       # scales with the requested tol
    eta = torch.where((res < thresh)[:, None, None], eta, float("nan"))
    return lv.replace(Eta=shard.slice_site(eta, 1))


def gpp_factor(lvd, alpha_idx, LiSL):
    """The step-invariant part of the GPP full conditional ``P = A - M
    F_blk^{-1} M'`` with ``A = LiSL + unitdiag(idD)`` (the JAX package's
    ``gpp_factor`` with ``_eta_gpp``'s alpha-0 overrides), per chain:
    ``(M1 (C, nf, np, nK), iA, LiA (C, np, nf, nf), LH (C, nf nK, nf
    nK))``, ``M1`` in ``LiSL``'s type (the grid is float64).  B8d-1 writes
    ``iA`` and ``LiA``, B8d-2 ``H`` (float64); ``LH
    = chol_spd(H)`` in float64 (jittered, as ``A``'s factor in B8d-1 is;
    ``LiA`` is the plain Cholesky of ``iA``)."""
    alpha = alpha_idx.contiguous()
    if mixed.active():
        # A's factor as the JAX package's chol_spd takes it: symmetrised
        # (a policy'd block's gram is not symmetric to rounding)
        LiSL = (LiSL + LiSL.transpose(-1, -2)) / 2
    iA, LiA = gpp_unit(lvd, alpha, LiSL.contiguous())
    LH = chol_spd(gpp_knot(lvd, alpha, iA))
    return gpp_m1_at(lvd, alpha).to(LiSL.dtype), iA, LiA, LH


def gpp_draw(payload, F, eps1, eps2):
    """Exact draw ``eta ~ N(P^{-1} F, P^{-1})`` per chain from a
    :func:`gpp_factor` payload: the mean by double Woodbury, the noise as
    ``LiA eps1 + iA M LH^{-T} eps2`` (covariance exactly ``P^{-1}``).
    ``F``, ``eps1`` (C, np, nf); ``eps2`` (C, nf nK).  The knot-space
    solves run in ``LH``'s type (float64 from :func:`gpp_factor`), the
    per-unit products in ``F``'s."""
    M1, iA, LiA, LH = payload
    C, nf, _, nK = M1.shape
    LHt = LH.transpose(1, 2)
    iA_rhs = torch.einsum("cuhg,cug->cuh", iA, F)
    Mt = torch.einsum("chum,cuh->chm", M1, iA_rhs).reshape(C, nf * nK, 1)
    corr = torch.linalg.solve_triangular(
        LHt, torch.linalg.solve_triangular(LH, Mt.to(LH.dtype), upper=False),
        upper=True).reshape(C, nf, nK).to(F.dtype)
    Mx = torch.einsum("chum,chm->cuh", M1, corr)
    mean = iA_rhs + torch.einsum("cuhg,cug->cuh", iA, Mx)
    noise1 = torch.einsum("cuhg,cug->cuh", LiA, eps1)
    w = torch.linalg.solve_triangular(LHt, eps2[..., None].to(LH.dtype),
                                      upper=True).reshape(C, nf, nK)
    w = w.to(F.dtype)
    Mw = torch.einsum("chum,chm->cuh", M1, w)
    return mean + noise1 + torch.einsum("cuhg,cug->cuh", iA, Mw)


def _eta_gpp(spec, data, state, r, rng, S, noise):
    """GPP Eta via double Woodbury (the JAX package's ``_eta_gpp``;
    reference updateEta.R:148-196)."""
    lvd, lv, ls = data.levels[r], state.levels[r], spec.levels[r]
    npr, nf, nK = ls.n_units, ls.nf_max, lvd.idDW12g.shape[2]
    LiSL, F = _level_gram(spec, data, lvd, ls, lv, state.iSigma, S)
    payload = gpp_factor(_gpp_level(lvd, r), lv.alpha_idx, LiSL)
    C = F.shape[0]
    eps1 = _noise(noise, "eps1", lambda: rng.normal((C, npr, nf), F.dtype))
    eps2 = _noise(noise, "eps2", lambda: rng.normal((C, nf * nK), F.dtype))
    return lv.replace(Eta=gpp_draw(payload, F, eps1, eps2))


def vecchia_cg_draw(pmv, b, x0, tol=CG_TOL, maxiter=CG_MAXITER,
                    first_check=0):
    """Conjugate gradients for ``P x = b`` per chain, run on the host with
    converged chains frozen (:func:`~hmsc_tpu_torch.ops.spatial.cg_frozen`),
    the convergence read at iteration ``first_check`` and every
    ``_CG_CHECK_EVERY`` after it: the CPU's form of the CG Eta draw, and a
    site mesh's on either device.
    Returns ``(x, relative residual (C,), iterations the loop ran, the
    largest per-chain count, per-chain iterations (C,))``."""
    return cg_frozen(pmv, b, x0, tol, maxiter, first_check, _CG_CHECK_EVERY)


# ---------------------------------------------------------------------------
# prior quadratics
# ---------------------------------------------------------------------------

def eta_quad_grid(lvd, ls, eta, shard=None):
    """``(v, ld)``: the prior quadratics ``eta_h' iW_g eta_h`` over the whole
    alpha grid, (C, nf, G), and ``log det W_g``, (G,) (``detDg`` for
    GPP).  On a site mesh (NNGP) B8b sums over the rank's units, reading
    the gathered eta, and the partials are summed over the ranks."""
    if ls.spatial == "Full":
        C, npr, nf = eta.shape
        e = eta.transpose(1, 2).reshape(1, C * nf, npr)
        v = ((e @ lvd.iWg) * e).sum(dim=2)               # (G, C nf)
        v = v.transpose(0, 1).reshape(C, nf, -1)
    elif ls.spatial == "GPP":
        return gpp_quad_grid(lvd, eta.contiguous()), lvd.detDg
    elif _site(shard):
        v = shard.psum_site(nngp_quad_grid(
            lvd, shard.gather_site(eta, 1),
            shard.site_offset(ls.n_units)))
    else:
        v = nngp_quad_grid(lvd, eta.contiguous())
    return v, lvd.detWg


def _quad_at(lvd, ls, eta, alpha_idx, r, shard=None):
    """B8b's or B8d-3's at-alpha ``(q, q1, s)``, (C, nf, 3), from the grids
    a policy'd block reads (see the module docstring); on a site mesh
    (NNGP) B8b's partial over the rank's units, summed over the ranks."""
    alpha_idx = alpha_idx.contiguous()
    if ls.spatial == "GPP":
        return gpp_quad_at(_gpp_level(lvd, r), alpha_idx, eta.contiguous())
    if _site(shard):
        return shard.psum_site(nngp_quad_at(
            lvd, alpha_idx, shard.gather_site(eta, 1),
            u_off=shard.site_offset(ls.n_units)))
    return nngp_quad_at(lvd, alpha_idx, eta.contiguous(),
                        *_staged_nngp(lvd, r))


def eta_quad_at(lvd, ls, eta, alpha_idx, r=0, shard=None):
    """(C, nf): ``eta_h' iW(alpha_h) eta_h`` at each factor's alpha (the
    scale interweave's prior quadratic)."""
    if ls.spatial == "Full":
        iW = mixed.staged_level("iWg", r, lvd.iWg)[alpha_idx.long()]
        e = eta.transpose(1, 2)
        if mixed.active():                               # an mx einsum
            return mixed.einsum("chu,chuv,chv->ch", e, iW, e)
        return ((iW @ e[..., None])[..., 0] * e).sum(dim=2)
    return _quad_at(lvd, ls, eta, alpha_idx, r, shard)[..., 0]


def eta_ones_forms_at(lvd, ls, eta, alpha_idx, r=0, shard=None):
    """``(1' iW_h 1, 1' iW_h eta_h)``, each (C, nf), at each factor's alpha
    (the location interweave's orbit prior)."""
    if ls.spatial == "Full":
        iW = mixed.staged_level("iWg", r, lvd.iWg)[alpha_idx.long()]
        # a staged bf16 gather: its row sums accumulate in float32
        w = (iW.sum(dim=3) if iW.dtype == eta.dtype
             else iW.sum(dim=3, dtype=eta.dtype))        # iW_h @ 1
        return w.sum(dim=2), (w * eta.transpose(1, 2)).sum(dim=2)
    out = _quad_at(lvd, ls, eta, alpha_idx, r, shard)
    return out[..., 1], out[..., 2]


# ---------------------------------------------------------------------------
# the alpha sampler
# ---------------------------------------------------------------------------

def update_alpha(spec: ModelSpec, data: ModelData, state: GibbsState, r: int,
                 rng=None, noise=None, shard=None) -> LevelState:
    """Per-factor categorical draw of the GP range on the alphapw grid,
    ``log p_g = log prior_g - log|W_g| / 2 - eta' iW_g eta / 2``, as the
    Gumbel-max argmax that ``jax.random.categorical`` draws.  ``noise``:
    ``{"gumbel": (C, nf, G)}`` standard Gumbel draws."""
    lvd, lv, ls = data.levels[r], state.levels[r], spec.levels[r]
    v, ld = eta_quad_grid(lvd, ls, lv.Eta, shard)
    loglike = torch.log(lvd.alphapw[:, 1]) - 0.5 * ld - 0.5 * v
    gumbel = _noise(noise, "gumbel", lambda: -torch.log(
        -torch.log(rng.uniform(loglike.shape, loglike.dtype))))
    idx = torch.argmax(loglike + gumbel, dim=-1).to(torch.int32)
    idx = torch.where(lv.nf_mask > 0, idx, 0).to(torch.int32)
    return lv.replace(alpha_idx=idx)
