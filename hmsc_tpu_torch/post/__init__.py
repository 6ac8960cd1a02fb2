"""Posterior container and post-hoc alignment (numpy only)."""

from .align import align_posterior
from .posterior import Posterior, pool_mcmc_chains

__all__ = ["Posterior", "pool_mcmc_chains", "align_posterior"]
