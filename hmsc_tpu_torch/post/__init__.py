"""Posterior container and post-hoc alignment (numpy only)."""

from .align import align_posterior
from .posterior import Posterior, pool_mcmc_chains, posterior_from_numpy

__all__ = ["Posterior", "pool_mcmc_chains", "posterior_from_numpy",
           "align_posterior"]
