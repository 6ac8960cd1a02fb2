"""Posterior container: the recorded sample arrays and the reference's
postList access patterns (reference ``R/poolMcmcChains.R``,
``R/getPostEstimate.R``).

Samples live as stacked numpy arrays with leading (chains, samples) axes —
the TPU-native layout: every summary is one vectorised reduction instead of
the reference's per-sample R list traversals.  ``post_list()`` materialises
the reference's list-of-dicts schema for capability parity.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Posterior", "pool_mcmc_chains", "posterior_from_numpy"]


class Posterior:
    """Recorded posterior for a fitted model.

    ``arrays`` maps parameter name -> (chains, samples, ...) numpy array.
    Per-level parameters use the ``_{r}`` suffix (Eta_0, Lambda_0, ...);
    ``nfMask_{r}`` records the active-factor mask per sample (the ragged
    nf bookkeeping the reference handles by list-shapes).
    """

    def __init__(self, hM, spec, arrays: dict, samples: int, transient: int,
                 thin: int):
        self.hM = hM
        self.spec = spec
        if isinstance(arrays, dict):
            self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        else:
            # lazily-materialised mapping (checkpoint.ShardBackedArrays):
            # keep it as-is so constructing a Posterior from a multi-GB
            # manifest copies nothing — each parameter loads on first access
            self.arrays = arrays
        self.samples = samples
        self.transient = transient
        self.thin = thin
        hint = getattr(self.arrays, "chains", None)
        self.n_chains = (int(hint) if hint else
                         (next(iter(self.arrays.values())).shape[0]
                          if len(self.arrays) else 0))
        self.timing = None          # {"setup_s", "run_s"} set by sample_mcmc
        self.site_shards = 1        # ranks of the site mesh that sampled it
        # the run's mixed-precision policy (PrecisionPolicy.to_meta(), None
        # for the exact engine), set by sample_mcmc: it changes the draws
        self.precision_policy = None
        self.io_stats = {}          # host-loop/checkpoint-IO counters
                                    # (sample_mcmc; empty when loaded)
        self.telemetry = None       # run-telemetry summary (span totals,
                                    # health, skew) set by sample_mcmc —
                                    # see hmsc_tpu.obs
        self.updater_profile = None  # per-updater wall/share table when the
                                    # run recorded an instrumented pass
                                    # (sample_mcmc(profile_updaters=...))
        # {level: (chains,) int} blocked factor-growth attempts per chain,
        # set by sample_mcmc (empty when unknown, e.g. from_prior/subset-free
        # construction)
        self.nf_saturation = {}
        # divergence health: first non-finite sweep per chain (-1 = clean),
        # set by sample_mcmc; poisoned chains are excluded from pooled()
        self.chain_health = {"first_bad_it": np.full(self.n_chains, -1),
                             "good_chains": np.ones(self.n_chains, bool)}
        # retry_diverged bookkeeping, set by sample_mcmc when a diverged
        # chain was re-run and spliced in: which chains were replaced and
        # whether the replacement came back healthy
        self.retry_info = {"retried_chains": (), "healthy_after_retry": ()}

    def set_chain_health(self, first_bad_it: np.ndarray) -> None:
        first_bad_it = np.asarray(first_bad_it)
        self.chain_health = {"first_bad_it": first_bad_it,
                             "good_chains": first_bad_it < 0}

    def good_chain_mask(self) -> np.ndarray:
        """Effective chain mask for pooled summaries: excludes diverged
        chains, except when every chain diverged (then nothing is excluded —
        degenerate output is better than empty output, and the divergence
        warnings have already fired).  The single source of truth for
        pooled(), pool_mcmc_chains and align_posterior."""
        good = self.chain_health["good_chains"]
        if good.all() or not good.any():
            return np.ones(self.n_chains, bool)
        return good

    # ------------------------------------------------------------------
    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self.arrays:
            raise KeyError(
                f"{name!r} was not recorded in this run — re-sample without "
                "the sample_mcmc(record=...) restriction, or include it")
        return self.arrays[name]

    def subset(self, start: int = 0, thin: int = 1,
               chain_index=None) -> "Posterior":
        """New Posterior keeping every ``thin``-th recorded sample from
        ``start`` on, per chain, optionally restricted to ``chain_index``
        (the reference's poolMcmcChains/getPostEstimate start/thin/chainIndex
        window, ``poolMcmcChains.R:19-27``, ``getPostEstimate.R:30``)."""
        if start == 0 and thin == 1 and chain_index is None:
            return self
        if chain_index is None:
            # basic slicing only: views, not copies (a fancy chain index
            # would transiently duplicate every recorded array — multi-GB
            # for Eta at scale)
            ci = np.arange(self.n_chains)
            arrays = {k: v[:, start::thin] for k, v in self.arrays.items()}
        else:
            ci = np.atleast_1d(np.asarray(chain_index, dtype=int))
            arrays = {k: v[ci][:, start::thin] for k, v in self.arrays.items()}
        sub = Posterior(self.hM, self.spec, arrays,
                        samples=arrays["Beta"].shape[1],
                        transient=self.transient, thin=self.thin * thin)
        sub.set_chain_health(self.chain_health["first_bad_it"][ci])
        sub.nf_saturation = {r: np.asarray(v)[ci]
                             for r, v in self.nf_saturation.items()}
        return sub

    def pooled(self, name: str, thin: int = 1) -> np.ndarray:
        """(chains*samples, ...) flattened view (poolMcmcChains); chains whose
        carry went non-finite (``chain_health``) are excluded so one diverged
        chain cannot silently poison every pooled summary.

        ``thin`` keeps every ``thin``-th recorded sample *per chain* (the
        ``subset(thin=)`` window) and applies BEFORE the flatten: on an
        mmap-backed posterior (``load_manifest_checkpoint(mmap=True)``) the
        sample-axis slice is windowed, so only the kept rows are ever
        copied into host RAM — which is what lets serving compaction thin
        a multi-GB draw history without materialising it first."""
        if name not in self.arrays:
            raise KeyError(
                f"{name!r} was not recorded in this run — re-sample without "
                "the sample_mcmc(record=...) restriction, or include it")
        a = self.arrays[name]
        thin = int(thin)
        if thin < 1:
            raise ValueError(f"pooled: thin must be >= 1, got {thin}")
        if thin > 1:
            a = a[:, ::thin]
        good = self.good_chain_mask()
        if not good.all():
            a = a[good]
        return a.reshape((-1,) + a.shape[2:])

    def post_list(self) -> list[list[dict]]:
        """The reference's postList[[chain]][[sample]] schema: a dict per
        recorded draw with the 13 elements of combineParameters
        (reference combineParameters.R:57)."""
        out = []
        nr = self.spec.nr
        # record=-restricted posteriors carry None for un-recorded entries,
        # like the reference's absent-extras (wRRR) slots
        get = lambda k, c, s: (self.arrays[k][c, s]
                               if k in self.arrays else None)
        for c in range(self.n_chains):
            chain = []
            for s in range(self.arrays["Beta"].shape[1]):
                d = {
                    "Beta": self.arrays["Beta"][c, s],
                    "wRRR": get("wRRR", c, s),
                    "Gamma": get("Gamma", c, s),
                    "V": get("V", c, s),
                    "rho": (float(self.arrays["rho"][c, s])
                            if "rho" in self.arrays else None),
                    "sigma": get("sigma", c, s),
                    "Eta": [self._trim(c, s, r, "Eta") for r in range(nr)],
                    "Lambda": [self._trim(c, s, r, "Lambda") for r in range(nr)],
                    "Alpha": [self._trim(c, s, r, "Alpha") for r in range(nr)],
                    "Psi": [self._trim(c, s, r, "Psi") for r in range(nr)],
                    "Delta": [self._trim(c, s, r, "Delta") for r in range(nr)],
                    "PsiRRR": get("PsiRRR", c, s),
                    "DeltaRRR": get("DeltaRRR", c, s),
                }
                chain.append(d)
            out.append(chain)
        return out

    def _trim(self, c, s, r, what):
        """Cut a factor-padded array down to its active factors (the
        reference's ragged nf shapes).  None when not recorded."""
        if f"{what}_{r}" not in self.arrays:
            return None
        mask = self.arrays[f"nfMask_{r}"][c, s] > 0
        a = self.arrays[f"{what}_{r}"][c, s]
        if what == "Eta":
            return a[:, mask]
        if what == "Alpha":
            return a[mask]
        if what in ("Lambda", "Psi"):
            out = a[mask]
            ls = self.spec.levels[r]
            return out[:, :, 0] if ls.x_dim == 0 else out
        if what == "Delta":
            return a[mask]
        return a

    # ------------------------------------------------------------------
    def get_post_estimate(self, par: str, r: int = 0, q=(), x=None,
                          chain_index=None, start: int = 0, thin: int = 1):
        """Posterior mean / support / quantiles for a parameter
        (reference ``R/getPostEstimate.R:32-79``).  Derived parameters
        ``Omega`` (= Lambda' Lambda per level) and ``OmegaCor`` supported; for
        covariate-dependent levels (xDim > 0) ``x`` weights the Lambda slices
        before the crossproduct — the association matrix *at* covariate value
        x (reference ``:47-57``; default x = (1, 0, ...), the intercept).
        ``chain_index``/``start``/``thin`` window the pooled draws like the
        reference's arguments of the same names."""
        p = self.subset(start, thin, chain_index)
        a = p._param_array(par, r, x=x)
        out = {
            "mean": a.mean(axis=0),
            "support": (a > 0).mean(axis=0),
            "supportNeg": (a < 0).mean(axis=0),
        }
        if len(q):
            out["q"] = np.quantile(a, q, axis=0)
        return out

    def _param_array(self, par: str, r: int = 0, x=None) -> np.ndarray:
        """Pooled (draws, ...) array for a named or derived parameter."""
        if x is not None and par not in ("Omega", "OmegaCor"):
            raise ValueError(f"x only applies to Omega/OmegaCor, not {par!r}")
        if par in ("Omega", "OmegaCor"):
            lam = self.pooled(f"Lambda_{r}")          # (n, nf, ns, ncr)
            if lam.ndim == 3 and x is not None:
                raise ValueError(
                    f"level {r} has no covariate-dependent associations "
                    "(xDim == 0); x has no effect there")
            if lam.ndim == 4:
                if x is None:
                    lam = lam[..., 0]
                else:
                    xv = np.asarray(x, dtype=lam.dtype)
                    if xv.shape != (lam.shape[-1],):
                        raise ValueError(
                            f"x must have length ncr={lam.shape[-1]} "
                            f"for level {r}, got shape {xv.shape}")
                    lam = np.einsum("nfjk,k->nfj", lam, xv)
            om = np.einsum("nfj,nfk->njk", lam, lam)
            if par == "OmegaCor":
                d = np.sqrt(np.maximum(np.einsum("njj->nj", om), 1e-12))
                om = om / d[:, :, None] / d[:, None, :]
            return om
        if par in ("Eta", "Lambda", "Psi", "Delta", "Alpha"):
            return self.pooled(f"{par}_{r}")
        return self.pooled(par)


def pool_mcmc_chains(post: Posterior, start: int = 0, thin: int = 1) -> list[dict]:
    """Flatten postList[chains][samples] -> a flat list of sample dicts
    (reference ``R/poolMcmcChains.R:19-27``).  Chains flagged non-finite in
    ``chain_health`` are excluded, consistent with ``Posterior.pooled``;
    ``post_list()`` itself still exposes every chain raw."""
    pl = post.post_list()
    good = post.good_chain_mask()
    out = []
    for c, chain in enumerate(pl):
        if good[c]:
            out.extend(chain[start::thin])
    return out


def posterior_from_numpy(hM, arrays: dict, *, samples: int, transient: int,
                         thin: int) -> Posterior:
    """The port's :class:`Posterior` over recorded arrays given as numpy
    (``name -> (chains, samples, ...)``, e.g. a JAX package ``Posterior``'s
    ``arrays``), with the port's model spec (``build_spec(hM)`` at the
    recorded factor count), so both packages predict from identical
    draws."""
    from ..mcmc.structs import DEFAULT_NF_CAP, build_spec

    nf = [np.shape(arrays[f"Lambda_{r}"])[2] for r in range(hM.nr)
          if f"Lambda_{r}" in arrays]
    spec = build_spec(hM, max(nf) if nf else DEFAULT_NF_CAP)
    return Posterior(hM, spec, {k: np.asarray(v) for k, v in arrays.items()},
                     samples=samples, transient=transient, thin=thin)
