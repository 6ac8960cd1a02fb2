#!/usr/bin/env python3
"""Config 3b's sampler and the serve path's conditional query from one
checkout, for A/B comparisons of two commits on one card.

    python3 scripts/slice_ab.py ROOT [REPEATS]

Imports ``hmsc_tpu_torch`` and ``chip_smoke`` from the checkout at ROOT
(this repository, or an older commit unpacked with ``git archive``) and
prints one JSON line with the card and:

- config 3b (NNGP, np 1000, the CG Eta draw; ``chip_smoke.CONFIG3``):
  samples/s of REPEATS fits (default 2) after a warm-up fit, their kernel
  launches, and a torch.profiler window over 10 sweeps: kernel launches,
  device kernel time and its share of the window's wall time (the busy
  share), as ``chip_smoke.profile_sweeps`` prints them;
- the headline posterior (``chip_smoke.HEADLINE``) served by
  ``ServingEngine`` after ``warmup``: the 64-row conditional query at
  mcmc_step 3 (training rows 0-63 as new units, the second half of the
  species held out), wall time of each of 7 queries.

Run the two checkouts in turns (parent, change, change, parent) within
one call.
"""

import json
import pathlib
import subprocess
import sys
import time


def main() -> int:
    root = pathlib.Path(sys.argv[1]).resolve()
    repeats = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import hmsc_tpu_torch as ht
    from hmsc_tpu_torch import kernels as K

    if not torch.cuda.is_available():
        print("slice_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"root": str(root), "card": card}

    c = cs.CONFIG3["config3b"]
    m = cs.config3_model(ht, "config3b")
    kw = dict(samples=c["samples"], transient=c["transient"],
              n_chains=c["n_chains"], seed=cs.CONFIG3_SEED,
              nf_cap=cs.CONFIG3_NF)
    ht.sample_mcmc(m, **kw)                       # build and warm up
    rates = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        K.reset_launches()
        post = ht.sample_mcmc(m, **kw)
        rates.append(c["n_chains"] * c["samples"] / post.timing["run_s"])
    out["config3b"] = {"samples_per_s": rates,
                       "launches": dict(K.launches),
                       "cg_loop_mean": float(np.mean(
                           post.cg_iterations["loop"]))}
    pkw = dict(samples=10, transient=0, n_chains=c["n_chains"], seed=2,
               nf_cap=cs.CONFIG3_NF, align_post=False)
    ht.sample_mcmc(m, **pkw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        post = ht.sample_mcmc(m, **pkw)
    wall_ms = post.timing["run_s"] * 1e3
    rows = [(us / 1e3, e.count) for e, us in cs._device_rows(torch, prof)]
    busy = sum(r[0] for r in rows)
    out["config3b_profile"] = {"sweeps": 10, "wall_ms": wall_ms,
                               "device_ms": busy,
                               "busy_share": busy / wall_ms,
                               "launches": sum(r[1] for r in rows)}

    h = cs.HEADLINE
    X, Y, _ = cs.simulate_probit(h["ny"], h["ns"], seed=cs.HEADLINE_DATA_SEED)
    hM = cs.probit_model(ht, X, Y, nf=h["nf"])
    post = ht.sample_mcmc(hM, samples=h["samples"], transient=h["transient"],
                          n_chains=h["n_chains"], seed=cs.HEADLINE_SEED,
                          nf_cap=h["nf"])
    X64 = np.asarray(hM.X, dtype=np.float32)[:64]
    Yc = hM.Y[:64].astype(np.float32)
    Yc[:, hM.ns // 2:] = np.nan
    lat = []
    with ht.ServingEngine(post, coalesce_ms=2.0) as engine:
        engine.warmup()
        engine.predict(X64, Yc=Yc, mcmc_step=3)
        for _ in range(7):
            t1 = time.perf_counter()
            engine.predict(X64, Yc=Yc, mcmc_step=3)
            lat.append((time.perf_counter() - t1) * 1e3)
    out["conditional_64_ms"] = lat
    out["conditional_64_median_ms"] = float(np.median(lat))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
