#!/usr/bin/env python3
"""The float32 sampler against the same paths under
``precision_policy="auto"``, in turns within one process on one card.

    python3 scripts/precision_ab.py [ROUNDS] [--paths headline,config3a]

For each path (``chip_smoke``'s headline, NA headline, config 3a, 3b,
dense NNGP or 3c; the headline and 3a by default) a warm-up fit of each
form, then ROUNDS rounds (default 3) of four fits in the order float32,
policy'd, policy'd, float32: samples/s of each fit, then a torch.profiler
window over 10 sweeps of each form (kernel launches, device kernel time,
its share of the window's wall time) and each form's host time a sweep
block (``mcmc.sweep.make_sweep_schedule``'s blocks, timed with
perf_counter around each call, no synchronisation: a block's enqueue work
and any wait for the card inside it; ms a sweep over 20 sweeps).  Prints
one JSON line with the card's name and power limit.
"""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def block_host_ms(torch, ht, m, kw, policy, sweeps=20):
    """Host ms a sweep by schedule block over ``sweeps`` sweeps of one
    fit, the blocks wrapped with perf_counter."""
    from hmsc_tpu_torch.mcmc import sweep as tsweep

    made = tsweep.make_sweep_schedule
    spent = {}

    def timed(*a, **k):
        steps = made(*a, **k)

        def wrap(name, fn):
            def run(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
                return out
            return run
        return [(n, wrap(n, f)) for n, f in steps]

    tsweep.make_sweep_schedule = timed
    try:
        ht.sample_mcmc(m, **dict(kw, samples=sweeps, transient=0,
                                 align_post=False),
                       precision_policy=policy)
    finally:
        tsweep.make_sweep_schedule = made
    torch.cuda.synchronize()
    return {n: round(1e3 * t / sweeps, 4) for n, t in spent.items()}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rounds", nargs="?", type=int, default=3)
    ap.add_argument("--paths", default="headline,config3a")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("precision_ab: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import hmsc_tpu_torch as ht
    from hmsc_tpu_torch import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    K.library()
    h = cs.HEADLINE
    X, Y, _ = cs.simulate_probit(h["ny"], h["ns"], seed=cs.HEADLINE_DATA_SEED)
    models = {"headline": (cs.probit_model(ht, X, Y, nf=h["nf"]), h)}
    if "na_headline" in opts.paths:
        na = cs.NA_HEADLINE
        Y_na = Y.copy()
        Y_na[np.random.default_rng(7).uniform(size=Y.shape)
             < na["na_share"]] = np.nan
        models["na_headline"] = (cs.probit_model(ht, X, Y_na, nf=na["nf"]),
                                 na)
    for name, c in cs.CONFIG3.items():
        if name in opts.paths:
            models[name] = (cs.config3_model(ht, name),
                            dict(c, nf=cs.CONFIG3_NF))
    out = {"card": card}
    for path in opts.paths.split(","):
        m, c = models[path]
        kw = dict(samples=c["samples"], transient=c["transient"],
                  n_chains=c["n_chains"], seed=1, nf_cap=c["nf"])
        rates = {"float32": [], "auto": []}
        for policy in (None, "auto"):
            ht.sample_mcmc(m, **kw, precision_policy=policy)   # warm up
        for _ in range(opts.rounds):
            for form in ("float32", "auto", "auto", "float32"):
                torch.cuda.synchronize()
                post = ht.sample_mcmc(
                    m, **kw, precision_policy=None if form == "float32"
                    else "auto")
                rates[form].append(round(
                    c["n_chains"] * c["samples"] / post.timing["run_s"], 2))
        res = {"samples_per_s": rates}
        for form, policy in (("float32", None), ("auto", "auto")):
            pkw = dict(samples=10, transient=0, n_chains=c["n_chains"],
                       seed=2, nf_cap=c["nf"], align_post=False,
                       precision_policy=policy)
            ht.sample_mcmc(m, **pkw)
            torch.cuda.synchronize()
            K.reset_launches()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                p10 = ht.sample_mcmc(m, **pkw)
            wall = p10.timing["run_s"] * 1e3
            busy = sum(us for _, us in cs._device_rows(torch, prof)) / 1e3
            res[form] = {"window_ms": round(wall, 3),
                         "device_ms": round(busy, 3),
                         "busy_share": round(busy / wall, 4),
                         "launches": {k: v for k, v in K.launches.items()
                                      if v},
                         "blocks_host_ms_a_sweep": block_host_ms(
                             torch, ht, m, kw, policy)}
        med = {f: float(np.median(r)) for f, r in rates.items()}
        print(f"{path}: samples/s float32 {rates['float32']} (median "
              f"{med['float32']:.2f}), auto {rates['auto']} (median "
              f"{med['auto']:.2f}); busy share {res['float32']['busy_share']}"
              f" / {res['auto']['busy_share']} [{card}]")
        out[path] = res
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
