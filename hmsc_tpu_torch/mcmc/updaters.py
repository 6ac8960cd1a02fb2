"""Full-conditional Gibbs updaters (port of the main-path subset of
``hmsc_tpu/mcmc/updaters.py``).

Each function maps (spec, data, state, rng) -> new state fields, batched
over a leading chain axis C on every state tensor (the JAX package vmaps a
chainless state).  Shapes are static and factor blocks are masked at
``nf_max``, as in the JAX package.  ``noise=`` injects an updater's random
draws (each documents its keys); only the tests use it, to hand the port
the very numbers the JAX updater drew.

Plain GEMMs (``X'X``, ``XE'Z``, ``S Lambda'``) are ``torch.matmul``, as the
JAX package left them to XLA, routed through :mod:`..ops.mixed` where the
JAX package routes them through ``mx``: outside a precision scope that is
the same ``@``, inside a policy'd block a bf16 product with float32
accumulation (kernel B10; with missing values B6's bf16 form, and B4's
bf16 form for the GammaV block).  The tiny nc x nc / nf x nf Cholesky
factorisations are ``chol_spd``.  The hot per-cell and per-system work
goes through the hand-written kernels B1-B5 (:mod:`..ops`; B2 forms the
BetaLambda and Eta precisions itself, B4 is the whole GammaV block), and
with missing values in Y the per-species and per-row masked grams through
B6 (:mod:`..ops.gram`); the opt-in probit-DA intercept interweave through
B7.  The spatial Eta and alpha updates live in
:mod:`.spatial`; the interweaving moves read its prior quadratics on a
spatial level.

``shard=`` (a :class:`~hmsc_tpu_torch.mcmc.partition.ShardCtx` with a site
axis) runs an updater on a site mesh's rank, as the JAX package's
``shard=`` branches do: the state holds the rank's rows of Z and units of
Eta and the data its rows (``structs.site_slice_data``); the cross-site
sums are ``shard.psum_site`` (an ``all_reduce``), a row gather of Eta reads
it gathered to full width (``shard.gather_site``), and every draw with a
site dimension is taken at the global width and sliced.
"""

from __future__ import annotations

import math

import torch

from ..ops import mixed
from ..ops.gram import masked_gram
from ..ops.linalg import (chol_spd, sample_beta_lambda, sample_mvn_prec,
                          sample_mvn_prec_shifted)
from ..ops.rand import (da_intercept_draw, gamma_v, probit_z_fused,
                        shrinkage_gamma, shrinkage_shapes, shrinkage_update,
                        standard_gamma, truncated_normal_onesided, z_mixed)
from .structs import GibbsState, LevelState, ModelData, ModelSpec

__all__ = ["lambda_effective", "linear_fixed", "level_loading",
           "total_loading", "eta_star", "fused_z", "mixed_z", "update_z",
           "beta_lambda_inputs", "update_beta_lambda",
           "update_gamma_v", "update_lambda_priors",
           "update_eta_nonspatial", "interweave_scale", "location_gate",
           "interweave_location", "da_intercept_gate",
           "interweave_da_intercept", "update_inv_sigma", "update_nf"]


def _noise(noise, key, draw):
    """``noise[key]`` when injected, else a fresh draw."""
    return noise[key] if noise is not None else draw()


# ---------------------------------------------------------------------------
# linear predictors
# ---------------------------------------------------------------------------

def lambda_effective(lv: LevelState):
    """(C, nf, ns, ncr) loadings with inactive factor rows zeroed."""
    return lv.Lambda * lv.nf_mask[:, :, None, None]


def linear_fixed(spec: ModelSpec, data: ModelData, Beta):
    """LFix = X @ Beta, (C, ny, ns) (X staged under a policy)."""
    return mixed.matmul(mixed.staged("X", data.X), Beta)


def _site(shard) -> bool:
    return shard is not None and shard.has_sites


def _eta_rows_src(lv: LevelState, shard=None):
    """A level's Eta as a row gather reads it: on a site mesh Eta holds the
    rank's units while ``pi_row`` holds global unit indices, so it is
    gathered to full width first (the JAX package's ``_eta_rows_src``)."""
    return shard.gather_site(lv.Eta, 1) if _site(shard) else lv.Eta


def level_loading(data_lv, lv: LevelState, shard=None):
    """LRan_r = Eta[pi, :] @ Lambda (x_dim = 0, so x_row is all ones)."""
    return mixed.matmul(_eta_rows_src(lv, shard)[:, data_lv.pi_row],
                        lambda_effective(lv)[..., 0])


def total_loading(spec: ModelSpec, data: ModelData, state: GibbsState,
                  shard=None):
    E = linear_fixed(spec, data, state.Beta)
    for r in range(spec.nr):
        E = E + level_loading(data.levels[r], state.levels[r], shard)
    return E


def eta_star(spec: ModelSpec, data: ModelData, state: GibbsState,
             shard=None):
    """Stacked factor design (C, ny, K), K = sum_r nf_max_r * ncr_r; columns
    of inactive factors are zeroed (covariate-major ordering per level)."""
    cols = [_eta_rows_src(state.levels[r], shard)[:, data.levels[r].pi_row]
            * state.levels[r].nf_mask[:, None, :] for r in range(spec.nr)]
    if not cols:
        return state.Z.new_zeros((state.n_chains, state.Z.shape[1], 0))
    return torch.cat(cols, dim=2)


def _stacked_lambda_prior(spec: ModelSpec, state: GibbsState):
    """(C, K, ns) prior precisions psi_hj * tau_h, stacked like eta_star."""
    rows = []
    for r in range(spec.nr):
        lv = state.levels[r]
        delta = torch.where(lv.nf_mask[:, :, None] > 0, lv.Delta, 1.0)
        tau = torch.cumprod(delta, dim=1)
        pr = lv.Psi * tau[:, :, None, :]                 # (C, nf, ns, ncr)
        rows.append(pr.permute(0, 3, 1, 2).reshape(pr.shape[0], -1, spec.ns))
    if not rows:
        return state.Z.new_zeros((state.n_chains, 0, spec.ns))
    return torch.cat(rows, dim=1)


def _unstack_lambda(spec: ModelSpec, BL, state: GibbsState):
    """Split the (C, nc+K, ns) joint draw back into Beta and per-level
    Lambda."""
    C = BL.shape[0]
    Beta = BL[:, :spec.nc]
    new_levels = []
    off = spec.nc
    for r in range(spec.nr):
        ls, lv = spec.levels[r], state.levels[r]
        k = ls.nf_max * ls.ncr
        blk = BL[:, off:off + k]                         # covariate-major
        lam = blk.reshape(C, ls.ncr, ls.nf_max, spec.ns).permute(0, 2, 3, 1)
        new_levels.append(lv.replace(
            Lambda=lam * lv.nf_mask[:, :, None, None]))
        off += k
    return Beta, tuple(new_levels)


# ---------------------------------------------------------------------------
# updateZ (reference R/updateZ.R)
# ---------------------------------------------------------------------------

# B1's fused form stages nc + nf_max floats a row and a column
FUSED_Z_MAX_K = 32


def fused_z(spec: ModelSpec) -> bool:
    """Whether Z's probit branch is the linear predictor's only reader:
    every column probit, no missing values, no estimated dispersion, at
    most one random level (with x_dim 0, as every ported level) and
    ``nc + nf_max <= 32``.  Then the sweep does not form E and
    :func:`update_z` draws Z with B1's fused form, which forms E itself."""
    return (spec.any_probit and not spec.any_normal and not spec.any_poisson
            and not spec.has_na and not spec.any_estimated_sigma
            and spec.nr <= 1 and all(ls.x_dim == 0 for ls in spec.levels)
            and spec.nc + spec.nf_total <= FUSED_Z_MAX_K)


def mixed_z(spec: ModelSpec) -> bool:
    """Whether :func:`update_z` is one launch of B5's mixed form: every
    model with a (lognormal-)Poisson column (where :func:`fused_z` never
    holds).  The others keep their route: B1's fused form where
    :func:`fused_z` holds, else B1's E-reading form and the torch ops."""
    return spec.any_poisson and not fused_z(spec)


def _rows(shard):
    """``(row_off, ny_global)`` of B1's draws: a site mesh rank's block of
    rows, or ``(0, None)``."""
    return (shard.site_offset(shard.ny), shard.ny) if _site(shard) \
        else (0, None)


def update_z(spec: ModelSpec, data: ModelData, state: GibbsState, rng=None,
             E=None, noise=None, shard=None) -> GibbsState:
    """Latent-response data augmentation: normal columns copy Y, probit
    columns draw one-sided truncated normals (kernel B1), (lognormal-)
    Poisson columns the Polya-Gamma augmented normal of the NB(r = 1000)
    limit, drawn at the previous Z (kernel B5); last, missing cells of
    every family are imputed as E + sigma eps.  Where :func:`mixed_z`
    holds, all of it is one launch of B5's mixed form.  ``E`` may pass in
    the current linear predictor; without it, a model where
    :func:`fused_z` holds draws Z with B1's fused form from the current
    state.  ``noise``, per active branch: ``{"u", "eps_pg", "eps_z",
    "eps_na"}``, each (C, ny, ns) (the JAX updater's ``k_tn, k_pg, k_pg2,
    k_na`` draws).  On a site mesh the rank draws its rows' cells (B1's
    counters at their global rows; Poisson columns and missing values are
    refused there before the first sweep)."""
    row_off, ny_global = _rows(shard)
    if E is None and fused_z(spec):
        level = None
        if spec.nr:
            lv = state.levels[0]
            level = (_eta_rows_src(lv, shard), data.levels[0].pi_row,
                     lv.Lambda[..., 0], lv.nf_mask)
        Z = probit_z_fused(data.X, state.Beta, state.iSigma ** -0.5, data.Y,
                           rng, None if noise is None else noise.get("u"),
                           level, row_off, ny_global)
        return state.replace(Z=Z)
    if E is None:
        E = total_loading(spec, data, state, shard)
    nz = noise if noise is not None else {}
    fam = data.distr_family
    if mixed_z(spec):
        Z = z_mixed(data.Y, state.Z, E, state.iSigma, fam,
                    data.Ymask if spec.has_na else None, rng, nz.get("u"),
                    nz.get("eps_pg"), nz.get("eps_z"), nz.get("eps_na"))
        return state.replace(Z=Z)
    Z = state.Z
    one_family = spec.any_normal + spec.any_probit == 1
    if spec.any_normal:
        Z = torch.where(fam == 1, data.Y, Z)
    std = state.iSigma ** -0.5
    if spec.any_probit:
        z_tn = truncated_normal_onesided(E, std, data.Y, rng, nz.get("u"),
                                         row_off, ny_global)
        Z = z_tn if one_family else torch.where(fam == 2, z_tn, Z)
    if spec.has_na:
        eps = _noise(noise, "eps_na", lambda: rng.normal(E.shape, E.dtype))
        Z = torch.where(data.Ymask > 0, Z, E + std[:, None, :] * eps)
    return state.replace(Z=Z)


# ---------------------------------------------------------------------------
# updateBetaLambda, joint (reference R/updateBetaLambda.R)
# ---------------------------------------------------------------------------

def beta_lambda_inputs(spec: ModelSpec, data: ModelData, state: GibbsState,
                       shard=None):
    """The joint draw's gram, likelihood right-hand side and stacked factor
    priors: ``(G, rhs_lik, prior_lam)``, G (C, 1, P, P) the chains' shared
    ``XE'XE`` or, with missing values, (C, ns, P, P) a masked gram a
    species (kernel B6); rhs_lik (C, ns, P); prior_lam (C, K, ns).  On a
    site mesh the row contractions are the rank's partials, summed over
    the ranks (``psum_site``)."""
    C = state.n_chains
    XE = torch.cat([data.X.expand(C, -1, -1),
                    eta_star(spec, data, state, shard)],
                   dim=2)                                # (C, ny, P)
    prior_lam = _stacked_lambda_prior(spec, state)       # (C, K, ns)
    if spec.has_na:
        # (C, ns, P, P) and (C, ns, P): o = species, k = row
        G, rhs_lik = masked_gram(XE, data.Ymask.T, state.Z.transpose(1, 2),
                                 bf16=mixed.active())
    else:
        XEt = XE.transpose(1, 2)
        G = mixed.matmul(XEt, XE)[:, None]               # (C, 1, P, P)
        rhs_lik = mixed.matmul(XEt, state.Z).transpose(1, 2)  # (C, ns, P)
    if _site(shard):                      # cross-site row contractions
        G = shard.psum_site(G)
        rhs_lik = shard.psum_site(rhs_lik)
    return G, rhs_lik, prior_lam


def update_beta_lambda(spec: ModelSpec, data: ModelData, state: GibbsState,
                       rng=None, noise=None, shard=None) -> GibbsState:
    """Joint (Beta, Lambda) draw: one (nc+K)^2 system per species, all of
    them in one batched draw (kernel B2's BetaLambda form, which forms
    each species' precision and right-hand side itself).  Without missing
    values the species share one gram ``XE'XE``; with them each species
    has its own masked gram and right-hand side (kernel B6).  ``noise``:
    ``{"eps": (C, ns, nc+K)}``."""
    G, rhs_lik, prior_lam = beta_lambda_inputs(spec, data, state, shard)
    # per-species posterior precision blkdiag(iV, diag(psi*tau)) +
    # iSigma_j G, its right-hand side and the draw: B2's BetaLambda form
    BL = sample_beta_lambda(G, rhs_lik, state.iSigma, state.iV, prior_lam,
                            state.Gamma, data.Tr,
                            None if noise is None else noise["eps"], rng)
    Beta, levels = _unstack_lambda(spec, BL.transpose(1, 2), state)
    return state.replace(Beta=Beta, levels=levels)


# ---------------------------------------------------------------------------
# updateGammaV (reference R/updateGammaV.R), no phylogeny
# ---------------------------------------------------------------------------

def update_gamma_v(spec: ModelSpec, data: ModelData, state: GibbsState,
                   rng=None, noise=None) -> GibbsState:
    """Conjugate draws: iV ~ Wishart(f0+ns, (E E' + V0)^{-1}) by Bartlett,
    then Gamma | Beta, iV.  On the card, where ``gamma_v_route`` allows,
    the whole block is one launch of kernel B4 (``ops/rand.py ·
    gamma_v``); otherwise the plain block (B3's element form for the
    Bartlett diagonal, then torch ops).  Under a precision policy its bf16
    form: ``E E'``, ``iV Beta`` and ``(iV Beta) Tr`` with bf16 operands
    (``Tr`` from its shadow) and ``Tr'Tr`` of the rounded ``Tr``, formed
    once a run (``precision.stage_data``).  ``noise``: ``{"wishart":
    {"normal", "gamma"}, "gamma": {"eps"}}``."""
    TtT, Tr16 = data.TtT, None
    if mixed.active():
        Tr16 = mixed.staged("Tr", data.Tr).to(torch.bfloat16)
        TtT = mixed.staged("TtT", None)
        if TtT is None:
            TtT = mixed.matmul(Tr16.T, Tr16)
    iV, Gamma = gamma_v(state.Beta, state.Gamma, data.Tr, data.V0, TtT,
                        data.iUGamma, data.iUGmG, spec.f0 + spec.ns, rng,
                        noise, Tr16)
    return state.replace(iV=iV, Gamma=Gamma)


# ---------------------------------------------------------------------------
# updateLambdaPriors (reference R/updateLambdaPriors.R)
# ---------------------------------------------------------------------------

def update_lambda_priors(spec: ModelSpec, data: ModelData, state: GibbsState,
                         rng=None, noise=None) -> GibbsState:
    """Multiplicative-gamma shrinkage: psi elementwise conjugate gamma, delta
    sequential over factor index with tau recomputed per step; inactive
    slots stay neutral (delta = 1).  On the card each level is one launch
    of B3's shrinkage form (``shrinkage_gamma``); on the CPU, or with
    ``noise`` injected, the plain update (``shrinkage_update``) on B3's
    element draws: psi's, then each factor's delta in turn.  ``noise``: per
    level ``{"psi": (C, nf, ns, ncr), "delta": (C, nf, ncr)}`` unit-rate
    gamma draws."""
    new_levels = []
    for r in range(spec.nr):
        lvd, lv = data.levels[r], state.levels[r]
        nz = None if noise is None else noise[r]
        if nz is None and lv.Lambda.is_cuda:
            psi, delta = shrinkage_gamma(lv.Lambda, lv.nf_mask, lv.Delta,
                                         lvd.nu, lvd.a1, lvd.b1, lvd.a2,
                                         lvd.b2, rng)
        else:
            a_psi, ad = shrinkage_shapes(lv.nf_mask, lvd.nu, lvd.a1, lvd.a2,
                                         spec.ns)
            g = _noise(nz, "psi", lambda: standard_gamma(
                a_psi.expand(lv.Lambda.shape).contiguous(), rng))
            psi, delta = shrinkage_update(
                lv.Lambda, lv.nf_mask, lv.Delta, lvd.nu, lvd.b1, lvd.b2, g,
                lambda h: (nz["delta"][:, h] if nz is not None else
                           standard_gamma(ad[:, h].contiguous(), rng)))
        new_levels.append(lv.replace(Psi=psi, Delta=delta))
    return state.replace(levels=tuple(new_levels))


# ---------------------------------------------------------------------------
# updateEta, non-spatial (reference R/updateEta.R)
# ---------------------------------------------------------------------------

def _level_gram_parts(spec, data, lvd, ls, lv, iSigma, S, shard=None):
    """A level's per-unit factor precision contributions as ``(G, scale,
    F)``: without missing values every row shares one gram, so G is (C, 1,
    nf, nf) and ``scale`` the units' row counts (np,); with them each row
    has its own masked gram and right-hand side (kernel B6), summed into G
    (C, np, nf, nf), and ``scale`` is None.  F (C, np, nf).  The unit sums
    are ``index_add_`` over ``pi_row`` (x_dim = 0).  On a site mesh the
    rank's rows sum into every unit and the sums over the ranks complete
    them (``psum_site``): G and F come back full width on every rank (the
    shared gram needs no sum: ``unit_count`` counts every rank's rows)."""
    lam = lambda_effective(lv)[..., 0]                   # (C, nf, ns)
    lamT = lam.transpose(1, 2)
    C = lam.shape[0]
    if spec.has_na:
        # (C, ny, nf, nf) and (C, ny, nf): o = row, k = species
        rows, Fr = masked_gram(lamT, data.Ymask, S, iSigma,
                               bf16=mixed.active())
        G = rows.new_zeros((C, ls.n_units, ls.nf_max, ls.nf_max))
        G.index_add_(1, lvd.pi_row, rows)
        if _site(shard):
            G = shard.psum_site(G)
        scale = None
    else:
        G = mixed.matmul(lam * iSigma[:, None, :], lamT)[:, None]
        scale = lvd.unit_count                           # G (C, 1, nf, nf)
        Fr = mixed.matmul(S * iSigma[:, None, :], lamT)  # (C, ny, nf)
    F = Fr.new_zeros((C, ls.n_units, ls.nf_max))
    F.index_add_(1, lvd.pi_row, Fr)
    if _site(shard):
        F = shard.psum_site(F)
    return G, scale, F


def _level_gram(spec, data, lvd, ls, lv, iSigma, S, shard=None):
    """Per-unit factor precision contributions and RHS (x_dim = 0):
    (LiSL (C, np, nf, nf), F (C, np, nf)), from
    :func:`_level_gram_parts`."""
    G, scale, F = _level_gram_parts(spec, data, lvd, ls, lv, iSigma, S,
                                    shard)
    return (G if scale is None else scale[:, None, None] * G), F


def update_eta_nonspatial(spec, data, state, r: int, rng=None, S=None,
                          noise=None, shard=None) -> LevelState:
    """Eta_r | rest for one unstructured level: one nf x nf system per unit,
    ``I + LiSL_u``, all in one batched draw (kernel B2's identity form,
    which scales the shared gram by each unit's row count itself);
    inactive factors fall back to their N(0,1) prior.  On a site mesh the
    rank draws its block of units from the full-width grams, each unit's
    eps the replicated run's (B2's counters at the global unit).
    ``noise``: ``{"eps": (C, np, nf)}``, full width."""
    lvd, lv, ls = data.levels[r], state.levels[r], spec.levels[r]
    G, scale, F = _level_gram_parts(spec, data, lvd, ls, lv, state.iSigma,
                                    S, shard)
    eps = None if noise is None else noise["eps"]
    if not _site(shard):
        return lv.replace(Eta=sample_mvn_prec_shifted(G, F, scale, eps,
                                                      rng))
    F = shard.slice_site(F, 1)
    if scale is None:
        G = shard.slice_site(G, 1)
    else:
        scale = shard.slice_site(scale, 0)
    if eps is not None:
        eps = shard.slice_site(eps, 1)
    return lv.replace(Eta=sample_mvn_prec_shifted(
        G, F, scale, eps, rng, shard.site_offset(ls.n_units), ls.n_units))


# ---------------------------------------------------------------------------
# interweaving moves (JAX package updaters.py:693-854)
# ---------------------------------------------------------------------------

def interweave_scale(spec: ModelSpec, data: ModelData, state: GibbsState,
                     rng=None, noise=None, shard=None) -> GibbsState:
    """Per-factor scale move (Eta_h, Lambda_h) -> (c Eta_h, Lambda_h / c), a
    Metropolis step along the likelihood-invariant scale orbit (see the
    JAX package's docstring).  The prior quadratic is ``eta_h' eta_h``, or
    ``eta_h' iW(alpha_h) eta_h`` on a spatial level.  ``noise``: per level
    ``{"u": (C, nf) normals, "acc": (C, nf) uniforms}``."""
    new_levels = []
    for r in range(spec.nr):
        lvd, lv, ls = data.levels[r], state.levels[r], spec.levels[r]
        nz = None if noise is None else noise[r]
        C = lv.Eta.shape[0]
        mask = lv.nf_mask
        if ls.spatial is None:
            A = (lv.Eta ** 2).sum(dim=1)                 # (C, nf)
            if _site(shard):              # cross-site unit sum
                A = shard.psum_site(A)
        else:
            from .spatial import eta_quad_at
            A = eta_quad_at(lvd, ls, lv.Eta, lv.alpha_idx, r, shard)
        delta = torch.where(mask[:, :, None] > 0, lv.Delta, 1.0)
        tau = torch.cumprod(delta, dim=1)
        B = (lv.Psi * tau[:, :, None, :] * lv.Lambda ** 2).sum(dim=(2, 3))
        k_exp = ls.n_units - spec.ns * ls.ncr
        sigma = float(2.38 / math.sqrt(2.0 * (ls.n_units + spec.ns * ls.ncr)))
        u = sigma * _noise(nz, "u", lambda: rng.normal((C, ls.nf_max),
                                                       A.dtype))
        c = torch.exp(u)
        log_acc = (-0.5 * A * (c ** 2 - 1.0)
                   - 0.5 * B * (c ** -2 - 1.0) + k_exp * u)
        acc = _noise(nz, "acc", lambda: rng.uniform((C, ls.nf_max), A.dtype))
        ok = torch.log(acc) < log_acc
        c = torch.where(ok & (mask > 0), c, 1.0)
        new_levels.append(lv.replace(Eta=lv.Eta * c[:, None, :],
                                     Lambda=lv.Lambda / c[:, :, None, None]))
    return state.replace(levels=tuple(new_levels))


def location_gate(spec: ModelSpec, has_intercept: bool) -> str | None:
    """Why :func:`interweave_location` cannot run on this model, or None."""
    if not has_intercept:
        return "the design has no intercept column to shift"
    if spec.x_is_list:
        return "per-species design matrices"
    if spec.ncsel > 0:
        return ("variable selection's effective-Beta zeroing breaks the "
                "move's likelihood invariance")
    return None


def interweave_location(spec: ModelSpec, data: ModelData, state: GibbsState,
                        rng=None, noise=None, shard=None) -> GibbsState:
    """Per-factor location move (Eta_h, Beta_int) -> (Eta_h + c_h 1,
    Beta_int,j - c_h Lambda_hj): exact Gibbs along the likelihood-invariant
    translation orbit (see the JAX package's docstring); on a spatial level
    the orbit prior is ``(1' iW 1, 1' iW eta)`` at each factor's alpha.
    ``noise``: per level a (C, nf) normal."""
    if location_gate(spec, has_intercept=data.x_ones_ind is not None):
        return state
    ii = data.x_ones_ind
    Beta = state.Beta
    Mu = state.Gamma @ data.Tr.T                         # (C, nc, ns)
    iV = state.iV
    v00 = iV[:, ii, ii]                                  # (C,)
    new_levels = []
    for r in range(spec.nr):
        lvd, lv, ls = data.levels[r], state.levels[r], spec.levels[r]
        lam = lambda_effective(lv)[..., 0]               # (C, nf, ns)
        mask = lv.nf_mask
        u = (iV[:, ii, None, :] @ (Beta - Mu))[:, 0]     # (C, ns)
        if ls.spatial is None:
            q1 = torch.full_like(mask, float(ls.n_units))
            s = lv.Eta.sum(dim=1)                        # 1' eta_h
            if _site(shard):              # cross-site unit sum
                s = shard.psum_site(s)
        else:
            from .spatial import eta_ones_forms_at
            q1, s = eta_ones_forms_at(lvd, ls, lv.Eta, lv.alpha_idx, r,
                                      shard)
        G = mixed.matmul(lam, lam.transpose(1, 2))
        bB = mixed.matmul(lam, u[:, :, None])[..., 0]
        P = v00[:, None, None] * G + torch.diag_embed(
            torch.where(mask > 0, q1, 1.0))
        b = torch.where(mask > 0, bB - s, 0.0)
        L = chol_spd(P)
        z = (noise[r] if noise is not None
             else rng.normal(b.shape, b.dtype))
        c = sample_mvn_prec(L, b, z) * mask
        Beta = Beta.clone()
        Beta[:, ii] = Beta[:, ii] + (-(c[:, None, :] @ lam)[:, 0])
        new_levels.append(lv.replace(Eta=lv.Eta + c[:, None, :]))
    return state.replace(levels=tuple(new_levels), Beta=Beta)


def da_intercept_gate(spec: ModelSpec, has_intercept: bool) -> str | None:
    """Why :func:`interweave_da_intercept` cannot run on this model, or
    ``None`` when eligible (the JAX package's ``da_intercept_gate``)."""
    if not spec.any_probit:
        return "no probit column — the move flips the probit augmentation"
    if not has_intercept:
        return "the design has no intercept column to shift"
    if spec.x_is_list:
        return "per-species design matrices"
    if spec.ncsel > 0:
        return ("variable selection's effective-Beta zeroing decouples the "
                "intercept row from the recorded Beta")
    if spec.nc_rrr > 0:
        return "RRR appends state-dependent design columns"
    if spec.has_phylo:
        return ("the phylogenetic prior couples intercepts across species; "
                "the per-species conditional no longer factorises over the "
                "sign-interval box")
    return None


def interweave_da_intercept(spec: ModelSpec, data: ModelData,
                            state: GibbsState, rng=None,
                            noise=None) -> GibbsState:
    """ASIS flip of the probit data augmentation for the intercept row
    (the JAX package's ``interweave_da_intercept``): redraw ``Beta[int, j]``
    with the residual ``R = Z - Beta[int]`` held fixed, from its Gaussian
    prior conditional truncated to the interval the signs of Y impose on
    it, then rebuild ``Z = R + Beta[int]`` (kernel B7).  NA cells impose no
    bound; non-probit columns are untouched.  Structural eligibility lives
    in :func:`da_intercept_gate`.  ``noise``: ``{"u": (C, ns)}`` uniforms on
    [1e-38, 1)."""
    ii = data.x_ones_ind
    Mu = state.Gamma @ data.Tr.T                         # (C, nc, ns)
    u_prior = (state.iV[:, ii, None, :] @ (state.Beta - Mu))[:, 0]
    v00 = state.iV[:, ii, ii].contiguous()
    t, Z = da_intercept_draw(
        state.Z, data.Y, data.Ymask if spec.has_na else None,
        data.distr_family, state.Beta.contiguous(), ii, u_prior, v00, rng,
        None if noise is None else noise["u"])
    Beta = state.Beta.clone()
    Beta[:, ii] = t
    return state.replace(Z=Z, Beta=Beta)


# ---------------------------------------------------------------------------
# updateInvSigma (reference R/updateInvSigma.R)
# ---------------------------------------------------------------------------

def update_inv_sigma(spec: ModelSpec, data: ModelData, state: GibbsState,
                     rng=None, E=None, noise=None, shard=None) -> GibbsState:
    """Conjugate residual precisions for the species whose dispersion is
    estimated (kernel B3); a no-op when none is (probit, fixed sigma).  On
    a site mesh the column statistics are summed over the ranks.
    ``noise``: ``{"gamma": (C, ns)}`` unit-rate gamma draws."""
    if not spec.any_estimated_sigma:
        return state
    Eps = state.Z - (total_loading(spec, data, state, shard) if E is None
                     else E)
    n_obs = data.Ymask.sum(dim=0)
    sq = ((Eps * data.Ymask) ** 2).sum(dim=1)            # (C, ns)
    if _site(shard):                      # cross-site column statistics
        n_obs = shard.psum_site(n_obs)
        sq = shard.psum_site(sq)
    shape = data.aSigma + 0.5 * n_obs
    rate = data.bSigma + 0.5 * sq
    g = _noise(noise, "gamma", lambda: standard_gamma(
        shape.expand(state.n_chains, -1).contiguous(), rng))
    iSigma = torch.where(data.distr_estsig > 0, g / rate,
                         1.0 / data.sigma_fixed)
    return state.replace(iSigma=iSigma)


# ---------------------------------------------------------------------------
# updateNf: masked factor-count adaptation (reference R/updateNf.R)
# ---------------------------------------------------------------------------

def update_nf(spec: ModelSpec, data: ModelData, state: GibbsState, r: int,
              rng=None, noise=None, shard=None) -> LevelState:
    """Burn-in factor adaptation as mask arithmetic: with probability
    1/exp(1 + 5e-4 it) either append one factor (fresh prior draws in the
    next inactive slot) or drop all-shrunk factors (a STABLE compaction
    permute, so the active block stays a prefix).  On a site mesh the new
    factor's Eta column is drawn at the global width and sliced; every
    statistic reads replicated state.  ``noise``: ``{"u": (C,) uniforms,
    "eta": (C, np) normals (full width), "psi": (C, ns, ncr) and "delta":
    (C, ncr) unit-rate gamma draws}``."""
    lvd, lv, ls = data.levels[r], state.levels[r], spec.levels[r]
    C = lv.Eta.shape[0]
    dtype = lv.Eta.dtype
    it = state.it.to(dtype)
    u = _noise(noise, "u", lambda: torch.rand(
        (C,), generator=rng.gen, device=rng.device, dtype=dtype))
    adapt = u < 1.0 / torch.exp(1.0 + 5e-4 * it)

    mask = lv.nf_mask
    nf = mask.sum(dim=1)
    small_prop = (lv.Lambda.abs() < 1e-3).to(dtype).mean(dim=(2, 3))
    redundant = (mask > 0) & (small_prop >= 1.0)
    num_red = redundant.sum(dim=1)
    grow_wanted = (it > 20) & (num_red == 0) & torch.where(
        mask > 0, small_prop < 0.995, True).all(dim=1)
    add_ok = (nf < ls.nf_max) & grow_wanted
    drop_ok = (num_red > 0) & (nf > ls.nf_min)
    nf_sat = lv.nf_sat
    if ls.nf_capped:
        nf_sat = nf_sat + (adapt & grow_wanted
                           & (nf >= ls.nf_max)).to(torch.int32)

    # --- append one factor in slot `nf` -----------------------------------
    slot = torch.clamp_max(nf.to(torch.int64), ls.nf_max - 1)
    onehot = torch.nn.functional.one_hot(slot, ls.nf_max).to(dtype)
    do_add = adapt & add_ok
    sel = torch.where(do_add[:, None], onehot, 0.0)      # (C, nf)
    if _site(shard):
        new_eta = (shard.normal(rng, (C, ls.n_units), dtype, 1)
                   if noise is None else shard.slice_site(noise["eta"], 1))
    else:
        new_eta = _noise(noise, "eta", lambda: rng.normal((C, ls.n_units),
                                                          dtype))
    Eta = lv.Eta * (1 - sel)[:, None, :] + new_eta[:, :, None] * sel[:, None, :]
    half_nu = lvd.nu / 2
    g_psi = _noise(noise, "psi", lambda: standard_gamma(
        half_nu.expand(C, spec.ns, ls.ncr).contiguous(), rng))
    new_psi = g_psi / half_nu
    Psi = lv.Psi * (1 - sel)[:, :, None, None] \
        + new_psi[:, None] * sel[:, :, None, None]
    g_del = _noise(noise, "delta", lambda: standard_gamma(
        lvd.a2.expand(C, ls.ncr).contiguous(), rng))
    new_del = g_del / lvd.b2
    Delta = lv.Delta * (1 - sel)[:, :, None] + new_del[:, None, :] * sel[:, :, None]
    Lambda = lv.Lambda * (1 - sel)[:, :, None, None]
    alpha_idx = (lv.alpha_idx * (1 - sel.to(torch.int32))).to(torch.int32)
    mask_add = torch.clamp(mask + sel, 0.0, 1.0)

    # --- drop redundant factors (stable compaction) -----------------------
    keep = (mask > 0) & ~redundant
    do_drop = adapt & drop_ok & ~do_add
    order = torch.argsort(torch.where(keep, 0, 1), dim=1, stable=True)
    mask_drop = torch.gather(torch.where(keep, 1.0, 0.0).to(dtype), 1, order)

    def take(a, dim):
        idx = order.reshape(order.shape + (1,) * (a.dim() - 2))
        if dim == 2:
            idx = order[:, None, :]
        return torch.gather(a, dim, idx.expand_as(a))

    Eta_d = take(lv.Eta, 2)
    Lambda_d = take(lv.Lambda, 1) * mask_drop[:, :, None, None]
    Psi_d = take(lv.Psi, 1)
    Delta_d = torch.where(mask_drop[:, :, None] > 0, take(lv.Delta, 1), 1.0)
    alpha_d = take(lv.alpha_idx, 1) * mask_drop.to(torch.int32)

    def pick(dropped, added):
        w = do_drop.reshape((C,) + (1,) * (added.dim() - 1))
        return torch.where(w, dropped, added)

    return lv.replace(Eta=pick(Eta_d, Eta), Lambda=pick(Lambda_d, Lambda),
                      Psi=pick(Psi_d, Psi), Delta=pick(Delta_d, Delta),
                      alpha_idx=pick(alpha_d, alpha_idx),
                      nf_mask=pick(mask_drop, mask_add), nf_sat=nf_sat)
