#!/usr/bin/env python3
"""Samples/s of the port's probit headline from one checkout, for A/B
comparisons of two commits on one card.

    python3 scripts/headline_ab.py ROOT [REPEATS]

Imports ``hmsc_tpu_torch`` and ``chip_smoke`` from the checkout at ROOT
(this repository, or an older commit unpacked with ``git archive``), fits
``chip_smoke.HEADLINE`` (1000 x 1000 probit, nf_max 8, 4 chains, 10 + 200
sweeps, seed 1) REPEATS times (default 3) after one warm-up fit, and
prints one JSON line: ROOT, the card, each fit's samples/s and run_s, and
the kernel launches of the last fit.  Run the two checkouts in turns
(parent, change, change, parent) within one call.
"""

import json
import pathlib
import subprocess
import sys


def main() -> int:
    root = pathlib.Path(sys.argv[1]).resolve()
    repeats = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    import hmsc_tpu_torch as ht
    from hmsc_tpu_torch import kernels as K

    if not torch.cuda.is_available():
        print("headline_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    h = cs.HEADLINE
    X, Y, _ = cs.simulate_probit(h["ny"], h["ns"], seed=66)
    hM = cs.probit_model(ht, X, Y, nf=h["nf"])
    kw = dict(samples=h["samples"], transient=h["transient"],
              n_chains=h["n_chains"], seed=1, nf_cap=h["nf"])
    ht.sample_mcmc(hM, **kw)                      # build and warm up
    rates, runs = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        K.reset_launches()
        post = ht.sample_mcmc(hM, **kw)
        runs.append(post.timing["run_s"])
        rates.append(h["n_chains"] * h["samples"] / runs[-1])
    print(json.dumps({"root": str(root), "card": card,
                      "samples_per_s": rates, "run_s": runs,
                      "launches": dict(K.launches)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
