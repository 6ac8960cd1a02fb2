"""Conditional prediction of latent factors at new units (reference
``R/predictLatentFactor.R:35-210``); a copy of
``hmsc_tpu/predict/latent.py`` (numpy and scipy only), kept by the port.

Restructuring: the reference loops over posterior draws and factors,
re-factorising the GP kernel for every (draw, factor) pair.  Here the range
parameter alpha lives on a discrete grid, so all (draw, factor) pairs sharing
one grid value share one kernel factorisation: we group pairs by grid index,
factorise once per visited grid value, and apply the conditional by one
batched matmul per group.  This turns O(n_draws * nf) cubic solves into
O(n_visited_grid_values) solves + large batched products.

Kriging math per mode mirrors the reference exactly:

- ``Full``: joint-kernel conditional N(K21 K11^-1 eta, K22 - K21 K11^-1 K12)
  (``predictLatentFactor.R:95-117``).
- ``NNGP``: k-nearest-neighbour conditional per new unit
  (``predictLatentFactor.R:118-160``).
- ``GPP``: knot-based predictive-process conditional
  (``predictLatentFactor.R:161-203``).  The reference indexes ``alpha[nf]``
  (the *last* factor's range) for every factor h — a latent bug; we use
  ``alpha[h]`` like the other two branches.
- ``predict_mean`` / ``predict_mean_field`` cheap variants
  (``predictLatentFactor.R:62-92``).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

__all__ = ["predict_latent_factor"]

_JIT = 1e-8


def _pair_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a[:, None, :] - b[None, :, :]
    return np.sqrt((d**2).sum(-1))


def _dists_for(rL, units, new_units, need22: bool):
    """(D11, D12, D22) between conditioning units and new units, from
    coordinates or a distance matrix."""
    if rL.s is not None:
        s1 = rL.coords_for(units)
        s2 = rL.coords_for(new_units)
        D11 = _pair_dist(s1, s1)
        D12 = _pair_dist(s1, s2)
        D22 = _pair_dist(s2, s2) if need22 else None
    else:
        i1 = [rL._dist_names.index(str(u)) for u in units]
        i2 = [rL._dist_names.index(str(u)) for u in new_units]
        D11 = rL.dist_mat[np.ix_(i1, i1)]
        D12 = rL.dist_mat[np.ix_(i1, i2)]
        D22 = rL.dist_mat[np.ix_(i2, i2)] if need22 else None
    return D11, D12, D22


def predict_latent_factor(units_pred, units, post_eta, post_alpha, rL,
                          predict_mean: bool = False,
                          predict_mean_field: bool = False,
                          rng: np.random.Generator | None = None) -> np.ndarray:
    """Sample Eta at ``units_pred`` conditional on posterior draws at ``units``.

    Parameters mirror the reference, but the posterior enters as stacked
    arrays: ``post_eta`` (n_draws, np, nf) and ``post_alpha`` (n_draws, nf)
    *grid indices* into ``rL.alphapw``.  Returns (n_draws, len(units_pred), nf).
    Factor slots inactive in a draw carry zero loadings downstream, so their
    predicted columns are harmless.
    """
    if predict_mean and predict_mean_field:
        raise ValueError("Hmsc.predictLatentFactor: predictMean and predictMeanField arguments cannot be simultaneously TRUE")
    # deliberately unseeded: omitting `rng` is the caller's explicit opt-out
    # of determinism; pass a Generator to reproduce runs
    rng = rng or np.random.default_rng()
    post_eta = np.asarray(post_eta)
    n_draws, np_old, nf = post_eta.shape
    units = [str(u) for u in units]
    units_pred = [str(u) for u in units_pred]
    pos = {u: i for i, u in enumerate(units)}
    ind_old = np.array([u in pos for u in units_pred], dtype=bool)
    n = len(units_pred)
    out = np.zeros((n_draws, n, nf), dtype=post_eta.dtype)
    if ind_old.any():
        src = [pos[u] for u, o in zip(units_pred, ind_old) if o]
        out[:, ind_old, :] = post_eta[:, src, :]
    new_units = [u for u, o in zip(units_pred, ind_old) if not o]
    nn = len(new_units)
    if nn == 0:
        return out

    if rL.s_dim == 0:
        if predict_mean:
            pass  # zeros
        else:
            out[:, ~ind_old, :] = rng.standard_normal((n_draws, nn, nf))
        return out

    post_alpha = np.asarray(post_alpha, dtype=int)
    if post_alpha.shape != (n_draws, nf):
        post_alpha = np.broadcast_to(post_alpha, (n_draws, nf)).copy()
    alphas = rL.alphapw[:, 0]

    method = rL.spatial_method
    need22 = method == "Full" and not (predict_mean or predict_mean_field)
    if method in ("Full",) or predict_mean or predict_mean_field:
        D11, D12, D22 = _dists_for(rL, units, new_units, need22)
    eta_new = np.empty((n_draws, nn, nf), dtype=post_eta.dtype)
    # (draw, factor) pairs grouped by grid index: one factorisation per value
    flat_alpha = post_alpha.reshape(-1)                     # (n_draws*nf,)
    eta_flat = np.transpose(post_eta, (0, 2, 1)).reshape(-1, np_old)  # (P, np)
    res_flat = np.empty((n_draws * nf, nn), dtype=post_eta.dtype)

    if method == "NNGP" and not (predict_mean or predict_mean_field):
        k = min(int(rL.n_neighbours or 10), np_old)
        s_old = rL.coords_for(units)
        s_new = rL.coords_for(new_units)
        tree = cKDTree(s_old)
        _, nn_idx = tree.query(s_new, k=k)
        nn_idx = np.atleast_2d(nn_idx)
        if nn_idx.shape[0] != nn:
            nn_idx = nn_idx.reshape(nn, -1)
        d12 = np.sqrt(((s_new[:, None, :] - s_old[nn_idx]) ** 2).sum(-1))  # (nn, k)
        d11 = np.sqrt(((s_old[nn_idx][:, :, None, :]
                        - s_old[nn_idx][:, None, :, :]) ** 2).sum(-1))     # (nn,k,k)
    if method == "GPP" and not (predict_mean or predict_mean_field):
        knots = rL.s_knot
        dss = _pair_dist(knots, knots)
        dns = _pair_dist(rL.coords_for(new_units), knots)
        dos = _pair_dist(rL.coords_for(units), knots)

    for g in np.unique(flat_alpha):
        sel = np.nonzero(flat_alpha == g)[0]
        a = alphas[g]
        P = len(sel)
        if a == 0:
            res_flat[sel] = (np.zeros((P, nn)) if predict_mean
                             else rng.standard_normal((P, nn)))
            continue
        E = eta_flat[sel]                                   # (P, np_old)
        if predict_mean or predict_mean_field:
            K11 = np.exp(-D11 / a) + _JIT * np.eye(np_old)
            K12 = np.exp(-D12 / a)
            A = np.linalg.solve(K11, K12)                   # (np_old, nn)
            M = E @ A
            if predict_mean:
                res_flat[sel] = M
            else:
                L11 = np.linalg.cholesky(K11)
                iLK = np.linalg.solve(L11, K12)
                v = np.maximum(1.0 - (iLK**2).sum(axis=0), 0.0)
                res_flat[sel] = M + np.sqrt(v)[None, :] * rng.standard_normal((P, nn))
        elif method == "Full":
            K11 = np.exp(-D11 / a) + _JIT * np.eye(np_old)
            K12 = np.exp(-D12 / a)
            K22 = np.exp(-D22 / a)
            A = np.linalg.solve(K11, K12)
            M = E @ A                                       # (P, nn)
            W = K22 - K12.T @ A
            Lw = np.linalg.cholesky(W + _JIT * np.eye(nn))
            res_flat[sel] = M + rng.standard_normal((P, nn)) @ Lw.T
        elif method == "NNGP":
            K12 = np.exp(-d12 / a)                          # (nn, k)
            K11 = np.exp(-d11 / a) + _JIT * np.eye(d11.shape[-1])[None]
            v = np.linalg.solve(K11, K12[..., None])[..., 0]  # (nn, k)
            Fvar = np.maximum(1.0 - (v * K12).sum(-1), 0.0)   # (nn,)
            # mean: sum over neighbours of coeff * eta at neighbour
            M = np.einsum("pik,ik->pi", E[:, nn_idx], v)     # (P, nn)
            res_flat[sel] = M + np.sqrt(Fvar)[None, :] * rng.standard_normal((P, nn))
        elif method == "GPP":
            nK = knots.shape[0]
            Wss = np.exp(-dss / a) + _JIT * np.eye(nK)
            Wns = np.exp(-dns / a)                          # (nn, nK)
            W12 = np.exp(-dos / a)                          # (np_old, nK)
            iWss = np.linalg.inv(Wss)
            WnsiWss = Wns @ iWss
            dDn = np.maximum(1.0 - (WnsiWss * Wns).sum(-1), 0.0)
            dD = np.maximum(1.0 - np.einsum("ik,kl,il->i", W12, iWss, W12), 1e-12)
            idDW12 = W12 / dD[:, None]
            Fmat = Wss + W12.T @ idDW12
            iF = np.linalg.inv(Fmat)
            LiF = np.linalg.cholesky(iF + _JIT * np.eye(nK))
            muS = (E @ idDW12) @ iF.T                       # (P, nK)
            epsS = rng.standard_normal((P, nK)) @ LiF.T
            M = (muS + epsS) @ Wns.T                        # (P, nn)
            res_flat[sel] = M + np.sqrt(dDn)[None, :] * rng.standard_normal((P, nn))
        else:  # pragma: no cover
            raise ValueError(f"unknown spatial method {method}")

    eta_new[:] = res_flat.reshape(n_draws, nf, nn).transpose(0, 2, 1)
    out[:, ~ind_old, :] = eta_new
    return out
