"""Precomputation layer (reference ``R/computeDataParameters.R``,
``R/computeInitialParameters.R``).

Host-side numpy, copied from ``hmsc_tpu/precompute.py`` for the models this
slice of the port samples: no phylogeny, and spatial levels of the ``Full``
(exact GP), ``NNGP`` (Vecchia) and ``GPP`` (knot-based predictive process)
kinds, with :func:`construct_knots` for the GPP knot grid.  The phylogeny
eigensystem (ROADMAP A5) arrives with the slice that samples it.

NNGP factors are stored as dense (np, k) neighbour-index / coefficient
arrays, as in the JAX package.  Beside them the port keeps each unit's
count of real neighbours (``nn_n``): the short lists are padded with index
0 and coefficient 0, and the Vecchia kernel's reverse-neighbour lists
(:func:`hmsc_tpu_torch.mcmc.structs.reverse_neighbours`) leave the pads out.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from .model import FIXED_SIGMA2, Hmsc

__all__ = ["compute_data_parameters", "compute_initial_parameters",
           "construct_knots", "DataParams", "LevelParams"]


class LevelParams:
    """Spatial grids for one random level (length-G arrays over alphapw)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class DataParams:
    """Phylogeny eigensystem + per-level spatial grids."""

    def __init__(self, U=None, d=None, Qeig=None, logdetQ=None, rL_par=None):
        self.U = U                  # (ns, ns) eigenvectors of C
        self.d = d                  # (ns,) eigenvalues of C
        self.Qeig = Qeig            # (G_rho, ns) eigenvalues of Q(rho_g)
        self.logdetQ = logdetQ      # (G_rho,)
        self.rL_par = rL_par or []  # list[LevelParams | None]


def compute_data_parameters(hM: Hmsc) -> DataParams:
    """Per-level spatial grids (Full, NNGP, GPP) of a non-phylogenetic
    model."""
    if hM.C is not None:
        raise NotImplementedError(
            "phylogeny is not ported yet (ROADMAP A5)")
    par = DataParams()
    for r in range(hM.nr):
        rL = hM.ranLevels[r]
        if rL.s_dim == 0:
            par.rL_par.append(None)
            continue
        units = hM.pi_names[r]
        alphapw = rL.alphapw
        method = rL.spatial_method
        if method == "Full":
            if rL.dist_mat is None:
                s = rL.coords_for(units)
                dd = s[:, None, :] - s[None, :, :]
                distance = np.sqrt((dd**2).sum(-1))
            else:
                distance = rL.dist_for(units)
            par.rL_par.append(_full_grids(distance, alphapw[:, 0]))
        elif method == "NNGP":
            if rL.dist_mat is not None:
                raise ValueError("computeDataParameters: Nearest neighbours not available for distance matrices")
            k = rL.n_neighbours or 10
            s = rL.coords_for(units)
            par.rL_par.append(_nngp_grids(s, k, alphapw[:, 0]))
        elif method == "GPP":
            if rL.dist_mat is not None:
                raise ValueError("computeDataParameters: predictive gaussian process not available for distance matrices")
            s = rL.coords_for(units)
            knots = rL.s_knot
            if knots is None:
                raise ValueError("computeDataParameters: GPP requires knot locations (sKnot)")
            par.rL_par.append(_gpp_grids(s, np.asarray(knots, float), alphapw[:, 0]))
        else:  # pragma: no cover
            raise ValueError(f"unknown spatial method {method}")
    return par


def _full_grids(distance: np.ndarray, alphas: np.ndarray) -> LevelParams:
    """Exact-GP grids: iW(alpha) and log det W(alpha) per grid point
    (reference computeDataParameters.R:54-81).  W(alpha=0) = I."""
    n = distance.shape[0]
    G = len(alphas)
    iWg = np.empty((G, n, n))
    detWg = np.empty(G)
    for g, a in enumerate(alphas):
        W = np.eye(n) if a == 0 else np.exp(-distance / a)
        L = np.linalg.cholesky(W + 1e-10 * np.eye(n))
        Li = np.linalg.inv(L)
        iWg[g] = Li.T @ Li
        detWg[g] = 2.0 * np.sum(np.log(np.diag(L)))
    return LevelParams(kind="Full", iWg=iWg, detWg=detWg, distance=distance)


def _nngp_grids(s: np.ndarray, k: int, alphas: np.ndarray) -> LevelParams:
    """Vecchia / NNGP factors as dense (np, k) neighbour arrays.

    Matches the reference's construction (computeDataParameters.R:82-136):
    kNN graph over all points, neighbours restricted to lower indices; per
    alpha, per point: small kriging solve against its neighbours giving the
    autoregressive coefficients A[i] and conditional variance D[i], so
    RiW = D^{-1/2} (I - A) and iW = RiW' RiW.  ``nn_n[i]`` counts unit i's
    real neighbours; slots from ``nn_n[i]`` on are pads (index 0,
    coefficient 0).
    """
    n = s.shape[0]
    k = min(k, n - 1)
    tree = cKDTree(s)
    _, idx = tree.query(s, k=k + 1)
    nn = np.sort(idx[:, 1:], axis=1)             # drop self, ascending order

    # neighbour lists restricted to prior points, padded
    nn_idx = np.zeros((n, k), dtype=np.int64)
    nn_n = np.zeros(n, dtype=np.int64)
    for i in range(1, n):
        prev = nn[i][nn[i] < i]
        nn_n[i] = len(prev)
        nn_idx[i, :len(prev)] = prev

    G = len(alphas)
    coef = np.zeros((G, n, k))
    D = np.ones((G, n))
    detWg = np.zeros(G)
    pad_mask = np.arange(k)[None, :] < nn_n[:, None]
    # pairwise distances point<->neighbours and neighbour<->neighbour
    d_in = np.sqrt(((s[:, None, :] - s[nn_idx]) ** 2).sum(-1))        # (n, k)
    d_nn = np.sqrt(((s[nn_idx][:, :, None, :] - s[nn_idx][:, None, :, :]) ** 2).sum(-1))  # (n,k,k)
    for g, a in enumerate(alphas):
        if a == 0:
            continue  # iW = I, detW = 0
        Knn = np.exp(-d_nn / a)
        kin = np.exp(-d_in / a)
        # mask out padding: identity rows/cols, zero rhs
        m2 = pad_mask[:, :, None] & pad_mask[:, None, :]
        Knn = np.where(m2, Knn, np.eye(k)[None])
        kin = np.where(pad_mask, kin, 0.0)
        v = np.linalg.solve(Knn + 1e-10 * np.eye(k)[None], kin[..., None])[..., 0]
        v = np.where(pad_mask, v, 0.0)
        Dg = 1.0 - (kin * v).sum(-1)
        # duplicate unit coordinates give conditional variance 0, so 1/D
        # and log(D) blow up in the f32 quadratics / CG scalings
        Dg = np.maximum(Dg, _GP_DD_FLOOR)
        Dg[0] = 1.0
        coef[g] = v
        D[g] = Dg
        detWg[g] = np.sum(np.log(Dg))
    return LevelParams(kind="NNGP", nn_idx=nn_idx, nn_n=nn_n, nn_coef=coef,
                       nn_D=D, detWg=detWg, s=s)


# conditional-variance floor for the GPP and NNGP grids (JAX package
# precompute.py:178-185): 1e-3 of the unit marginal variance
_GP_DD_FLOOR = 1e-3


def _gpp_grids(s: np.ndarray, knots: np.ndarray, alphas: np.ndarray) -> LevelParams:
    """Knot-based predictive-process grids (reference
    computeDataParameters.R:138-194): per alpha the diagonal residual
    correction idD, idD*W12, F = W22 + W12' idD W12, its inverse, and
    log det of the implied covariance."""
    n, nK = s.shape[0], knots.shape[0]
    d12 = np.sqrt(((s[:, None, :] - knots[None, :, :]) ** 2).sum(-1))
    dd = knots[:, None, :] - knots[None, :, :]
    d22 = np.sqrt((dd**2).sum(-1))
    G = len(alphas)
    idDg = np.empty((G, n))
    idDW12g = np.empty((G, n, nK))
    Fg = np.empty((G, nK, nK))
    iFg = np.empty((G, nK, nK))
    detDg = np.empty(G)
    for g, a in enumerate(alphas):
        if a == 0:
            W22 = np.eye(nK)
            W12 = np.zeros((n, nK))
        else:
            W22 = np.exp(-d22 / a)
            W12 = np.exp(-d12 / a)
        iW22 = np.linalg.inv(W22 + 1e-10 * np.eye(nK))
        dD = 1.0 - np.einsum("ik,kl,il->i", W12, iW22, W12)
        # nugget floor: a unit at (or within float distance of) a knot has
        # conditional variance dD -> 0, and idD = 1/dD would make the f32
        # double-Woodbury Eta solve cancel catastrophically
        dD = np.maximum(dD, _GP_DD_FLOOR)
        idD = 1.0 / dD
        idDW12 = idD[:, None] * W12
        F = W22 + W12.T @ idDW12
        iF = np.linalg.inv(F)
        # log det of W_gpp = W12 iW22 W12' + diag(dD)
        liW22 = np.linalg.cholesky(iW22)
        t2 = W12 @ liW22
        DS = t2.T @ (idD[:, None] * t2) + np.eye(nK)
        LDS = np.linalg.cholesky(DS)
        detDg[g] = np.sum(np.log(dD)) + 2.0 * np.sum(np.log(np.diag(LDS)))
        idDg[g] = idD
        idDW12g[g] = idDW12
        Fg[g] = F
        iFg[g] = iF
    return LevelParams(kind="GPP", idDg=idDg, idDW12g=idDW12g, Fg=Fg, iFg=iFg,
                       detDg=detDg, s=s, knots=knots)


def construct_knots(s_data, n_knots: int | None = None, knot_dist: float | None = None,
                    min_knot_dist: float | None = None) -> np.ndarray:
    """Regular knot grid over the data's bounding box for GPP, dropping knots
    farther than ``min_knot_dist`` from any datum (reference
    ``R/constructKnots.R:26-49``)."""
    s = np.asarray(s_data, dtype=float)
    if s.ndim == 1:
        s = s[:, None]
    lo, hi = s.min(axis=0), s.max(axis=0)
    if knot_dist is not None:
        axes = [np.arange(l, h + knot_dist, knot_dist) for l, h in zip(lo, hi)]
    else:
        n_knots = n_knots or 10
        axes = [np.linspace(l, h, n_knots) for l, h in zip(lo, hi)]
    mesh = np.meshgrid(*axes, indexing="ij")
    knots = np.column_stack([m.ravel() for m in mesh])
    if min_knot_dist is None and knot_dist is not None:
        min_knot_dist = knot_dist
    if min_knot_dist is not None:
        tree = cKDTree(s)
        dist, _ = tree.query(knots, k=1)
        knots = knots[dist <= min_knot_dist]
    return knots


# ---------------------------------------------------------------------------
# initial state (reference computeInitialParameters.R:17-273)
# ---------------------------------------------------------------------------

def compute_initial_parameters(hM: Hmsc, nf_max_static, rng: np.random.Generator,
                               init_par: dict | None = None) -> dict:
    """Draw one chain's initial parameter values (host-side numpy).

    ``init_par`` may override any of Beta/Gamma/V/sigma/Lambda/Eta/Psi/Delta/
    Alpha/rho per the reference contract; ``init_par="fixed effects"`` fits
    per-species GLMs first (reference :52-79).
    Factor arrays are allocated at the static nf_max with the first nf_min
    slots active (masked factor adaptation, SURVEY.md §7 point 1).
    """
    from scipy import stats as sps

    init_par = init_par if init_par is not None else {}
    fixed_effects = init_par == "fixed effects"
    if fixed_effects:
        init_par = {}

    out: dict = {}
    ns, nc, nt, nr = hM.ns, hM.nc, hM.nt, hM.nr

    if fixed_effects:
        Beta = _fixed_effects_beta(hM, rng)
        Gamma = np.linalg.lstsq(hM.TrScaled, Beta.T, rcond=None)[0].T
        E = Beta - Gamma @ hM.TrScaled.T
        V = np.cov(E) + np.eye(nc) if nc > 1 else np.atleast_2d(np.var(E) + 1.0)
        V = np.nan_to_num(V, nan=0.0) + 0.0
    else:
        Gamma = init_par.get("Gamma")
        if Gamma is None:
            # column-major vec(Gamma) convention, matching update_gamma_v and
            # the reference (updateGammaV.R:30-32)
            Gamma = rng.multivariate_normal(hM.mGamma, hM.UGamma).reshape(
                (nc, nt), order="F")
        V = init_par.get("V")
        if V is None:
            V = sps.invwishart.rvs(df=hM.f0, scale=hM.V0, random_state=rng)
            V = np.atleast_2d(V)
        Beta = init_par.get("Beta")
        if Beta is None:
            Mu = Gamma @ hM.TrScaled.T
            Beta = Mu + np.linalg.cholesky(V) @ rng.standard_normal((nc, ns))
    out["Gamma"], out["V"], out["Beta"] = Gamma, np.atleast_2d(V), Beta

    out["BetaSel"] = [rng.uniform(size=len(sel.q)) < sel.q for sel in hM.x_select]

    if hM.nc_rrr > 0:
        DeltaRRR = np.concatenate([rng.gamma(hM.a1RRR, 1 / hM.b1RRR, 1),
                                   rng.gamma(hM.a2RRR, 1 / hM.b2RRR, hM.nc_rrr - 1)])
        PsiRRR = rng.gamma(hM.nuRRR / 2, 2 / hM.nuRRR, (hM.nc_rrr, hM.nc_orrr))
        tau = np.cumprod(DeltaRRR)
        wRRR = rng.standard_normal((hM.nc_rrr, hM.nc_orrr)) / np.sqrt(PsiRRR * tau[:, None])
        out["PsiRRR"], out["DeltaRRR"], out["wRRR"] = PsiRRR, DeltaRRR, wRRR
    else:
        out["PsiRRR"] = out["DeltaRRR"] = out["wRRR"] = None

    sigma = init_par.get("sigma")
    if sigma is None:
        est = hM.distr[:, 1] == 1
        sigma = np.array([FIXED_SIGMA2[int(f)] for f in hM.distr[:, 0]], dtype=float)
        # reference draws initial sigma (not 1/sigma) from Gamma(aSigma, bSigma)
        # (computeInitialParameters.R:115-118); replicated as-is
        sigma[est] = rng.gamma(hM.aSigma[est], 1.0 / hM.bSigma[est])
    out["sigma"] = np.asarray(sigma, dtype=float)

    # per-level factor blocks, padded to the static nf_max
    levels = []
    for r in range(nr):
        rL = hM.ranLevels[r]
        nf_max = int(nf_max_static[r])
        ncr = max(rL.x_dim, 1)
        np_r = hM.np_[r]
        nf0 = min(int(rL.nf_min), nf_max)
        for key_ in ("Delta", "Psi", "Lambda", "Eta"):
            if init_par.get(key_) is not None:
                arr = init_par[key_][r]
                nf0 = arr.shape[1] if key_ == "Eta" else arr.shape[0]
        mask = np.zeros(nf_max)
        mask[:nf0] = 1.0

        Delta = np.ones((nf_max, ncr))
        Delta[0, :] = rng.gamma(rL.a1, 1 / rL.b1)
        if nf0 > 1:
            Delta[1:nf0, :] = rng.gamma(np.broadcast_to(rL.a2, (nf0 - 1, ncr)),
                                        1 / np.broadcast_to(rL.b2, (nf0 - 1, ncr)))
        Psi = rng.gamma(rL.nu / 2, 2 / rL.nu, (nf_max, ns, ncr))
        tau = np.cumprod(Delta, axis=0)
        Lambda = rng.standard_normal((nf_max, ns, ncr)) / np.sqrt(Psi * tau[:, None, :])
        Lambda *= mask[:, None, None]
        Eta = rng.standard_normal((np_r, nf_max))
        alpha_idx = np.zeros(nf_max, dtype=np.int32)

        if init_par.get("Delta") is not None:
            Delta[:nf0] = np.asarray(init_par["Delta"][r]).reshape(nf0, ncr)
        if init_par.get("Psi") is not None:
            Psi[:nf0] = np.asarray(init_par["Psi"][r]).reshape(nf0, ns, ncr)
        if init_par.get("Lambda") is not None:
            Lambda[:nf0] = np.asarray(init_par["Lambda"][r]).reshape(nf0, ns, ncr)
        if init_par.get("Eta") is not None:
            Eta[:, :nf0] = np.asarray(init_par["Eta"][r])
        if init_par.get("Alpha") is not None:
            alpha_idx[:nf0] = np.asarray(init_par["Alpha"][r])

        levels.append(dict(Eta=Eta, Lambda=Lambda, Psi=Psi, Delta=Delta,
                           alpha_idx=alpha_idx, nf_mask=mask))
    out["levels"] = levels

    if init_par.get("rho") is not None:
        out["rho_idx"] = int(np.argmin(np.abs(init_par["rho"] - hM.rhopw[:, 0])))
    else:
        out["rho_idx"] = 0
    return out


def _fixed_effects_beta(hM: Hmsc, rng) -> np.ndarray:
    """Per-species single-species estimates: OLS for normal, IRLS probit /
    log-Poisson GLMs otherwise (reference computeInitialParameters.R:52-79)."""
    from scipy.special import ndtr
    from scipy.stats import norm

    Beta = np.zeros((hM.nc, hM.ns))
    for j in range(hM.ns):
        Xj = hM.XScaled[j] if hM.x_is_list else hM.XScaled
        yj = hM.Y[:, j]
        obs = ~np.isnan(yj)
        Xo, yo = Xj[obs], yj[obs]
        fam = int(hM.distr[j, 0])
        if fam == 1:
            Beta[:, j] = np.linalg.lstsq(Xo, yo, rcond=None)[0]
            continue
        # IRLS
        beta = np.zeros(hM.nc)
        for _ in range(25):
            eta = np.clip(Xo @ beta, -8, 8)
            if fam == 2:
                mu = np.clip(ndtr(eta), 1e-6, 1 - 1e-6)
                dmu = norm.pdf(eta)
                var = mu * (1 - mu)
            else:
                mu = np.exp(np.clip(eta, -20, 20))
                dmu = mu
                var = mu
            w = dmu**2 / np.maximum(var, 1e-10)
            z = eta + (yo - mu) / np.maximum(dmu, 1e-10)
            WX = Xo * w[:, None]
            try:
                new = np.linalg.solve(Xo.T @ WX + 1e-8 * np.eye(hM.nc), WX.T @ z)
            except np.linalg.LinAlgError:
                break
            if np.max(np.abs(new - beta)) < 1e-8:
                beta = new
                break
            beta = new
        Beta[:, j] = beta
    return Beta
