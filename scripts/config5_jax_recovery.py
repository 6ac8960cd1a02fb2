#!/usr/bin/env python3
"""Slope recovery of the JAX package on BASELINE.md config 5, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/config5_jax_recovery.py

Fits config 5 (300 sites x 90 species; 30 normal, 30 probit and 30
lognormal-Poisson columns; one site-level level with nf 2) with
``hmsc_tpu.sample_mcmc`` at the settings of ``benchmarks/run_benchmarks.py``
(4 chains, 125 + 250 sweeps, seed 1), on the data ``chip_smoke.py`` draws
for the port, and prints, per family block, the correlation of the
posterior-mean slopes with the simulated ones: the reference that
``chip_smoke.py`` holds the port's config-5 run against
(``CONFIG5_JAX_SLOPE_CORR``).
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import hmsc_tpu  # noqa: E402

from chip_smoke import (CONFIG5, block_slope_corr, config5_data,  # noqa: E402
                        config5_model)


def main() -> int:
    c = CONFIG5
    post = hmsc_tpu.sample_mcmc(config5_model(hmsc_tpu), samples=c["samples"],
                                transient=c["transient"],
                                n_chains=c["n_chains"], seed=c["seed"],
                                nf_cap=c["nf"])
    corr = block_slope_corr(post, config5_data()[3])
    print(json.dumps({"slope_corr": dict(zip(
        ("normal", "probit", "lognormal poisson"), corr)),
        "good_chains": post.chain_health["good_chains"].tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
