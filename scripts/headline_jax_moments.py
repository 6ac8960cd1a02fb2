#!/usr/bin/env python3
"""Beta's posterior moments from the JAX package on the headline, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/headline_jax_moments.py [--seed S] \
        [--out PATH]

Fits ``chip_smoke.py``'s headline (a 1000-site x 1000-species probit JSDM
with design [1, x], one site-level level with nf_max 8, drawn by
``simulate_probit`` with seed 66) with ``hmsc_tpu.sample_mcmc`` at
``chip_smoke.HEADLINE``'s settings (4 chains, 10 + 200 sweeps, seed 1
unless ``--seed`` says otherwise), and writes Beta's entrywise posterior
means and standard errors (``chip_smoke.posterior_moments``: the larger of
the batch-means and the between-chain SE) to ``--out``, by default
``scripts/headline_jax_moments.json``: the reference that ``chip_smoke.py``
holds the port's headline run against by z-scores.  Takes a few minutes.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import hmsc_tpu  # noqa: E402

from chip_smoke import (HEADLINE, HEADLINE_DATA_SEED,  # noqa: E402
                        HEADLINE_SEED, posterior_moments, probit_model,
                        simulate_probit)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=HEADLINE_SEED)
    ap.add_argument("--out", default=str(ROOT / "scripts" /
                                         "headline_jax_moments.json"))
    a = ap.parse_args()
    h = HEADLINE
    X, Y, _ = simulate_probit(h["ny"], h["ns"], seed=HEADLINE_DATA_SEED)
    t0 = time.perf_counter()
    post = hmsc_tpu.sample_mcmc(probit_model(hmsc_tpu, X, Y, nf=h["nf"]),
                                samples=h["samples"],
                                transient=h["transient"],
                                n_chains=h["n_chains"], seed=a.seed,
                                nf_cap=h["nf"])
    beta = post["Beta"]
    mean, se = posterior_moments(beta)
    out = {"source": "hmsc_tpu.sample_mcmc on the CPU, "
                     "scripts/headline_jax_moments.py",
           "settings": dict(h, data_seed=HEADLINE_DATA_SEED, seed=a.seed),
           "good_chains": post.chain_health["good_chains"].tolist(),
           "shape": list(mean.shape),
           "mean": [[float(f"{x:.7g}") for x in r] for r in mean],
           "se": [[float(f"{x:.5g}") for x in r] for r in se]}
    pathlib.Path(a.out).write_text(json.dumps(out) + "\n")
    print(json.dumps({"out": a.out, "draws": list(beta.shape),
                      "seconds": round(time.perf_counter() - t0, 1),
                      "good_chains": out["good_chains"],
                      "se_median": float(sorted(se.ravel())[se.size // 2])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
