"""One Gibbs sweep in the reference's fixed update order (port of the
main-path part of ``hmsc_tpu/mcmc/sweep.py``).

The sweep is a list of named blocks run in order, each ``block(data, carry,
rng, noise) -> carry`` with the carry ``(state, E_shared)``: ``E_shared`` is
the linear predictor computed at the end of the Eta block and read by
InvSigma and Z (the interweaving moves leave the product Eta Lambda + X
Beta invariant, so it is not recomputed).  Where Z's probit branch is its
only reader (``updaters.fused_z``) the block passes ``None`` instead and Z
forms E inside kernel B1.  Updaters can be disabled with
the ``updater`` toggle dict, as in the JAX package
(``updater={"Interweave": False}``); the probit-DA intercept interweave is
opt-in (``updater={"InterweaveDA": True}``).

With a :class:`~hmsc_tpu_torch.mcmc.precision.PrecisionPolicy` each
policy'd block runs inside a ``mixed.scope`` (its routed products bf16 in,
float32 out) and the sweep inside one ``mixed.staged_scope`` holding the
run's shadow table, as the JAX package's ``make_sweep(precision=...)``.  A
bf16 Eta block forms E itself, with its products routed, and Z reads it (B1's
E-reading form): the JAX package's E_shared comes from that block.

With ``shard=`` (a :class:`~hmsc_tpu_torch.mcmc.partition.ShardCtx` with a
site axis) the same blocks run on a site mesh's rank, SPMD: each updater's
site branch reads the rank's rows and units and makes its cross-site sums
with ``all_reduce`` (the JAX package's ``make_sharded_sweep`` over a site
axis).  :func:`make_sharded_sweep` refuses the model classes whose site
branches are not ported before the first sweep.
"""

from __future__ import annotations

import torch

from ..ops import mixed
from . import updaters as U
from .spatial import update_alpha, update_eta_spatial
from .structs import GibbsState, ModelData, ModelSpec

__all__ = ["make_sweep_schedule", "make_sweep", "make_sharded_sweep",
           "sweep_prologue", "record_sample"]

# opt-in updaters of the JAX package that this slice does not port
_NOT_PORTED = {"Gamma2": "A7", "GammaEta": "A7"}


def _precision_block(fn, dtype, layouts):
    """One schedule block inside a mixed-precision compute scope."""
    def wrapped(*args):
        with mixed.scope(dtype, layouts):
            return fn(*args)
    return wrapped


def make_sweep_schedule(spec: ModelSpec, updater: dict | None = None,
                        adapt_nf: tuple | None = None,
                        cg_log: list | None = None, precision=None,
                        shard=None):
    """The ordered ``(name, block)`` list one sweep comprises.  NNGP CG Eta
    draws append their iteration counts to ``cg_log`` when given; blocks
    that ``precision`` (a ``PrecisionPolicy``) names run in its scope;
    ``shard`` runs every block's site branch."""
    updater = updater or {}
    on = lambda name: updater.get(name, True) is not False
    want = lambda name: updater.get(name, False) is True
    for name, item in _NOT_PORTED.items():
        if updater.get(name) is True:
            raise NotImplementedError(
                f"updater {name!r} is not ported yet (ROADMAP {item})")
    adapt_nf = adapt_nf or tuple(0 for _ in range(spec.nr))
    any_spatial = any(ls.spatial is not None for ls in spec.levels)
    eta_name = "EtaSpatial" if any_spatial else "Eta"
    # where Z's probit branch is E's only reader, the Eta block leaves E
    # unformed and Z forms it in B1's fused form, from the state after the
    # interweaves (equal in exact arithmetic: they leave E invariant); a
    # bf16 Eta block forms E with its products routed, as the JAX package
    fused = U.fused_z(spec) and not (
        precision is not None
        and precision.dtype_for(eta_name) == "bfloat16")
    steps = []

    if on("BetaLambda"):
        def _beta_lambda(data, carry, rng, noise):
            state, E = carry
            return U.update_beta_lambda(spec, data, state, rng, noise,
                                        shard), E
        steps.append(("BetaLambda", _beta_lambda))

    if on("GammaV"):
        def _gamma_v(data, carry, rng, noise):
            state, E = carry
            return U.update_gamma_v(spec, data, state, rng, noise), E
        steps.append(("GammaV", _gamma_v))

    if on("LambdaPriors"):
        def _lambda_priors(data, carry, rng, noise):
            state, E = carry
            return U.update_lambda_priors(spec, data, state, rng, noise), E
        steps.append(("LambdaPriors", _lambda_priors))

    if on("Eta") and spec.nr > 0:
        def _eta(data, carry, rng, noise):
            state, _ = carry
            LFix = U.linear_fixed(spec, data, state.Beta)
            LRan = [U.level_loading(data.levels[r], state.levels[r], shard)
                    if spec.nr > 1 else None for r in range(spec.nr)]
            for r in range(spec.nr):
                S = state.Z - LFix
                for q in range(spec.nr):
                    if q != r:
                        S = S - LRan[q]
                nz = None if noise is None else noise[r]
                if spec.levels[r].spatial is None:
                    lv = U.update_eta_nonspatial(spec, data, state, r, rng,
                                                 S, nz, shard)
                else:
                    lv = update_eta_spatial(spec, data, state, r, rng, S,
                                            nz, cg_log=cg_log, shard=shard)
                levels = list(state.levels)
                levels[r] = lv
                state = state.replace(levels=tuple(levels))
                if not fused:
                    LRan[r] = U.level_loading(data.levels[r],
                                              state.levels[r], shard)
            if fused:
                return state, None
            E = LFix
            for r in range(spec.nr):
                E = E + LRan[r]
            return state, E
        # one block covers every level; named for the spatial path when any
        # level takes it, as in the JAX package
        steps.append((eta_name, _eta))

    if on("Alpha") and any_spatial:
        def _alpha(data, carry, rng, noise):
            state, E = carry
            for r in range(spec.nr):
                if spec.levels[r].spatial is not None:
                    lv = update_alpha(spec, data, state, r, rng,
                                      None if noise is None else noise[r],
                                      shard)
                    levels = list(state.levels)
                    levels[r] = lv
                    state = state.replace(levels=tuple(levels))
            return state, E
        steps.append(("Alpha", _alpha))

    # per-factor (Eta, Lambda) scale and (Eta, Beta_intercept) location
    # interweaving: both leave the linear predictor invariant, so E_shared
    # stays valid; gated on the updaters they perturb
    iw_ok = spec.nr > 0 and on("Eta") and on("BetaLambda")
    if iw_ok and (on("Interweave") or on("InterweaveLocation")):
        def _interweave(data, carry, rng, noise):
            state, E = carry
            if on("Interweave"):
                state = U.interweave_scale(
                    spec, data, state, rng,
                    None if noise is None else noise["scale"], shard)
            if on("InterweaveLocation"):
                state = U.interweave_location(
                    spec, data, state, rng,
                    None if noise is None else noise["location"], shard)
            return state, E
        steps.append(("Interweave", _interweave))

    if on("InvSigma"):
        def _inv_sigma(data, carry, rng, noise):
            state, E = carry
            return U.update_inv_sigma(spec, data, state, rng, E, noise,
                                      shard), E
        steps.append(("InvSigma", _inv_sigma))

    if on("Z"):
        def _z(data, carry, rng, noise):
            state, E = carry
            return U.update_z(spec, data, state, rng, E, noise, shard), E
        steps.append(("Z", _z))

    # opt-in ASIS flip of the probit augmentation on the intercept row,
    # after Z so that the ancillary residual comes from the freshest Z; it
    # changes Beta and Z jointly, and nothing after it reads E_shared
    if want("InterweaveDA") and on("Z") and on("BetaLambda"):
        def _interweave_da(data, carry, rng, noise):
            state, E = carry
            return U.interweave_da_intercept(spec, data, state, rng,
                                             noise), E
        steps.append(("InterweaveDA", _interweave_da))

    # factor-count adaptation during burn-in (it <= adapt_nf[r])
    if any(adapt_nf[r] > 0 and on("Nf") for r in range(spec.nr)):
        def _nf(data, carry, rng, noise, it=None):
            state, E = carry
            for r in range(spec.nr):
                if adapt_nf[r] <= 0 or (it is not None and it > adapt_nf[r]):
                    continue      # the gate below is false for every chain
                lv_new = U.update_nf(spec, data, state, r, rng,
                                     None if noise is None else noise[r],
                                     shard)
                gate = state.it <= adapt_nf[r]            # (C,)
                lv_old = state.levels[r]
                lv = lv_old.replace(**{
                    k: torch.where(
                        gate.reshape((-1,) + (1,) * (getattr(lv_new, k).dim()
                                                     - 1)),
                        getattr(lv_new, k), getattr(lv_old, k))
                    for k in ("Eta", "Lambda", "Psi", "Delta", "alpha_idx",
                              "nf_mask", "nf_sat")})
                levels = list(state.levels)
                levels[r] = lv
                state = state.replace(levels=tuple(levels))
            return state, E
        steps.append(("Nf", _nf))

    if precision is not None:
        steps = [(name, _precision_block(fn, precision.dtype_for(name),
                                         precision.batched_layouts))
                 if precision.dtype_for(name) is not None else (name, fn)
                 for name, fn in steps]
    return steps


def sweep_prologue(state: GibbsState) -> GibbsState:
    """The iteration bump every sweep begins with."""
    return state.replace(it=state.it + 1)


def make_sweep(spec: ModelSpec, updater: dict | None = None,
               adapt_nf: tuple | None = None, cg_log: list | None = None,
               precision=None, staged: dict | None = None, shard=None):
    """``sweep(data, state, rng, it=None, noise=None) -> state``.

    ``it`` is the sweep's 1-based index known on the host (the value
    ``state.it`` takes after the prologue); with it the Nf block skips the
    factor adaptation outright once every level's window has closed,
    instead of computing a move whose gate is false on every chain.
    ``noise`` maps block names to that block's injected draws (tests).
    ``cg_log`` collects the NNGP CG draws' iteration counts.  With
    ``precision`` (a ``PrecisionPolicy``) the policy'd blocks run in their
    scopes and the sweep reads ``staged``, the run's shadow table
    (``precision.stage_data``).  ``shard`` runs the sweep on a site mesh's
    rank (use :func:`make_sharded_sweep`, which refuses what is not
    ported)."""
    steps = make_sweep_schedule(spec, updater, adapt_nf, cg_log, precision,
                                shard)

    def blocks(data, state, rng, it, noise):
        state = sweep_prologue(state)
        carry = (state, None)
        for name, block in steps:
            nz = None if noise is None else noise[name]
            if name == "Nf":
                carry = block(data, carry, rng, nz, it)
            else:
                carry = block(data, carry, rng, nz)
        return carry[0]

    if precision is None:
        return lambda data, state, rng, it=None, noise=None: blocks(
            data, state, rng, it, noise)

    def sweep(data: ModelData, state: GibbsState, rng, it=None,
              noise=None) -> GibbsState:
        with mixed.staged_scope(staged):
            return blocks(data, state, rng, it, noise)

    return sweep


def make_sharded_sweep(spec: ModelSpec, shard, updater: dict | None = None,
                       adapt_nf: tuple | None = None,
                       cg_log: list | None = None):
    """The site-sharded sweep (the JAX package's ``make_sharded_sweep`` on a
    site axis): :func:`make_sweep` with ``shard``, SPMD on every rank of
    ``shard``'s group, the data and state each rank's block
    (``structs.site_slice_data`` / ``site_slice_state``).  Raises
    ``NotImplementedError`` naming the ROADMAP item for a model class whose
    site branches are not ported (Full and GPP levels, Poisson columns,
    missing values, the probit-DA interweave)."""
    from .partition import site_shard_unsupported_reason
    reason = site_shard_unsupported_reason(spec, updater)
    if reason is not None:
        raise NotImplementedError(reason)
    return make_sweep(spec, updater, adapt_nf, cg_log, shard=shard)


# ---------------------------------------------------------------------------
# combineParameters at record time (reference R/combineParameters.R:1-58)
# ---------------------------------------------------------------------------

def record_sample(spec: ModelSpec, data: ModelData, state: GibbsState) -> dict:
    """Back-transform the current state to the original X/Tr scale and return
    the posterior-sample dict (each entry with the leading chain axis)."""
    Beta, Gamma, iV = state.Beta, state.Gamma, state.iV

    # traits: Gamma columns back to raw-trait scale
    tm, ts = data.tr_scale_par[0], data.tr_scale_par[1]
    Gamma = Gamma / ts
    ti = data.tr_intercept_ind
    if ti is not None:
        corr = (tm * Gamma).sum(dim=2) - tm[ti] * Gamma[:, :, ti]
        Gamma = Gamma.clone()
        Gamma[:, :, ti] = Gamma[:, :, ti] + (-corr)

    # covariates: Beta/Gamma rows and iV rows+cols
    xmean, xs = data.x_scale_par[0], data.x_scale_par[1]
    Beta = Beta / xs[:, None]
    Gamma = Gamma / xs[:, None]
    ii = data.x_intercept_ind
    if ii is not None:
        corrB = (xmean[:, None] * Beta).sum(dim=1) - xmean[ii] * Beta[:, ii]
        corrG = (xmean[:, None] * Gamma).sum(dim=1) - xmean[ii] * Gamma[:, ii]
        Beta, Gamma = Beta.clone(), Gamma.clone()
        Beta[:, ii] = Beta[:, ii] + (-corrB)
        Gamma[:, ii] = Gamma[:, ii] + (-corrG)
    iV_t = iV * xs[:, None] * xs[None, :]
    V, _ = torch.linalg.inv_ex(iV_t)      # no host sync on singular input

    rec = {"Beta": Beta, "Gamma": Gamma, "V": V, "sigma": 1.0 / state.iSigma,
           "rho": Beta.new_zeros((Beta.shape[0],))}
    for r in range(spec.nr):
        lv = state.levels[r]
        rec[f"Eta_{r}"] = lv.Eta
        rec[f"Lambda_{r}"] = U.lambda_effective(lv)
        rec[f"Psi_{r}"] = lv.Psi
        rec[f"Delta_{r}"] = lv.Delta
        rec[f"Alpha_{r}"] = lv.alpha_idx
        rec[f"nfMask_{r}"] = lv.nf_mask
    return rec
