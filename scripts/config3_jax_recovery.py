#!/usr/bin/env python3
"""Recovery of the JAX package on BASELINE.md config 3, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/config3_jax_recovery.py \
        [--path NAME ...] [seed ...]

Fits the spatial paths that ``chip_smoke.py`` drives through the port
(config 3a: Full, np 200; config 3b: NNGP with 10 neighbours, np 1000; the
3b generator at np 100; config 3c: GPP with 100 knots, np 1000, spatially
correlated factors), or the ones named with ``--path``, with
``hmsc_tpu.sample_mcmc`` at the same settings (4 chains, the same sweeps
and seed 1 unless seeds are given), on the data ``chip_smoke.py`` draws,
and prints for each the correlation of the posterior-mean slopes with the
simulated ones and each factor's posterior-mean GP range alpha: the
reference that ``chip_smoke.py`` holds the port's runs against
(``CONFIG3_JAX_ALPHA``).
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import hmsc_tpu  # noqa: E402

from chip_smoke import (CONFIG3, CONFIG3_NF, CONFIG3_SEED,  # noqa: E402
                        alpha_mean, config3_data, config3_model, slope_corr)


def main() -> int:
    args, paths = sys.argv[1:], []
    while "--path" in args:
        i = args.index("--path")
        paths.append(args[i + 1])
        del args[i:i + 2]
    seeds = [int(a) for a in args] or [CONFIG3_SEED]
    for name, c in CONFIG3.items():
        if paths and name not in paths:
            continue
        hM = config3_model(hmsc_tpu, name)
        for seed in seeds:
            post = hmsc_tpu.sample_mcmc(hM, samples=c["samples"],
                                        transient=c["transient"],
                                        n_chains=c["n_chains"], seed=seed,
                                        nf_cap=CONFIG3_NF)
            print(json.dumps({
                "path": name, "seed": seed,
                "slope_corr": slope_corr(post, config3_data(name)[4]),
                "alpha_mean": alpha_mean(post, hM),
                "alpha_grid_max": float(hM.ranLevels[0].alphapw[-1, 0]),
                "good_chains": post.chain_health["good_chains"].tolist()}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
