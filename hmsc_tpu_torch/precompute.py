"""Precomputation layer (reference ``R/computeDataParameters.R``,
``R/computeInitialParameters.R``).

Host-side numpy, copied from ``hmsc_tpu/precompute.py`` for the models this
slice of the port samples: no phylogeny and no spatial levels, so the data
parameters are empty.  The phylogeny eigensystem (ROADMAP A5) and the
spatial grids (ROADMAP A6) arrive with the slices that sample them.
"""

from __future__ import annotations

import numpy as np

from .model import FIXED_SIGMA2, Hmsc

__all__ = ["compute_data_parameters", "compute_initial_parameters",
           "DataParams"]


class DataParams:
    """Phylogeny eigensystem + per-level spatial grids."""

    def __init__(self, U=None, d=None, Qeig=None, logdetQ=None, rL_par=None):
        self.U = U                  # (ns, ns) eigenvectors of C
        self.d = d                  # (ns,) eigenvalues of C
        self.Qeig = Qeig            # (G_rho, ns) eigenvalues of Q(rho_g)
        self.logdetQ = logdetQ      # (G_rho,)
        self.rL_par = rL_par or []  # list[LevelParams | None]


def compute_data_parameters(hM: Hmsc) -> DataParams:
    """Data parameters of a non-phylogenetic, non-spatial model: none."""
    if hM.C is not None:
        raise NotImplementedError(
            "phylogeny is not ported yet (ROADMAP A5)")
    if any(rL.s_dim != 0 for rL in hM.ranLevels):
        raise NotImplementedError(
            "spatial random levels are not ported yet (ROADMAP A6)")
    return DataParams(rL_par=[None] * hM.nr)


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
