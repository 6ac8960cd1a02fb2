#!/usr/bin/env python3
"""The headline's, config 3b's and the dense NNGP path's sampler and the
serve path's conditional query from one checkout, for A/B comparisons of
two commits on one card.

    python3 scripts/slice_ab.py ROOT [REPEATS]
        [--paths headline,na_headline,config5,config3b,dense_nngp,conditional,
                 quantile]

Imports ``hmsc_tpu_torch`` and ``chip_smoke`` from the checkout at ROOT
(this repository, or an older commit unpacked with ``git archive``) and
prints one JSON line with the card and, for each path asked for (the
headline, config 3b and the conditional query by default):

- the headline (``chip_smoke.HEADLINE``: 1000 x 1000 probit, nf_max 8, 4
  chains, 10 + 200 sweeps), the headline with 10% of Y missing
  (``chip_smoke.NA_HEADLINE``, 10 + 50 sweeps, as chip_smoke makes it),
  BASELINE.md config 5 (``chip_smoke.CONFIG5``), config 3b (NNGP, np 1000, the CG Eta draw;
  ``chip_smoke.CONFIG3``) and the dense NNGP path (its generator at np 100,
  the dense Eta draw on kernel B8c): samples/s of REPEATS fits (default 2)
  after a warm-up fit, their kernel launches, and a torch.profiler window
  over 10 sweeps: kernel launches, device kernel time and its share of the
  window's wall time (the busy share), as ``chip_smoke.profile_sweeps``
  prints them;
- for each sampler path, ``blocks``: the host time of each block of the
  sweep (``mcmc.sweep.make_sweep_schedule``'s blocks, each timed with
  perf_counter around its call and no synchronisation, so a block's time
  is its enqueue work and any wait for the card inside it), ms a sweep
  over a fit of 20 sweeps, and the rest of the fit's wall time outside
  the blocks (recording the samples);
- ``config3b`` also times the host side of B8b's two wrappers
  (``ops.spatial.nngp_quad_grid`` and ``nngp_quad_at``, called the same
  way in older checkouts) at config 3b's level: microseconds a call over
  500 calls queued without synchronisation;
- ``conditional``: the headline posterior served by ``ServingEngine``
  after ``warmup``: the 64-row conditional query at mcmc_step 3 (training
  rows 0-63 as new units, the second half of the species held out), wall
  time of each of 7 queries;
- ``quantile``: the same engine's 64-row quantile query (training rows
  0-63 at their units, ``chip_smoke.SERVE_Q``, kernel B9c after B9a),
  wall time of each of 20 queries, their p50 and p99.

Run the two checkouts in turns (parent, change, change, parent) within
one call.
"""

import json
import pathlib
import subprocess
import sys
import time


def sampler_path(torch, cs, ht, K, m, n_chains, samples, transient, seed,
                 nf, repeats):
    """samples/s of ``repeats`` fits after a warm-up fit, their launches,
    and a profiled window of 10 sweeps; returns (numbers, last posterior)."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(samples=samples, transient=transient, n_chains=n_chains,
              seed=seed, nf_cap=nf)
    ht.sample_mcmc(m, **kw)                       # build and warm up
    rates = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        K.reset_launches()
        post = ht.sample_mcmc(m, **kw)
        rates.append(n_chains * samples / post.timing["run_s"])
    out = {"samples_per_s": rates, "launches": dict(K.launches),
           "blocks_host_ms_a_sweep": block_host_ms(ht, m, kw)}
    pkw = dict(samples=10, transient=0, n_chains=n_chains, seed=2,
               nf_cap=nf, align_post=False)
    ht.sample_mcmc(m, **pkw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p10 = ht.sample_mcmc(m, **pkw)
    wall_ms = p10.timing["run_s"] * 1e3
    rows = [(us / 1e3, e.count) for e, us in cs._device_rows(torch, prof)]
    busy = sum(r[0] for r in rows)
    out["profile"] = {"sweeps": 10, "wall_ms": wall_ms, "device_ms": busy,
                      "busy_share": busy / wall_ms,
                      "launches": sum(r[1] for r in rows)}
    return out, post


def block_host_ms(ht, m, kw, sweeps=20):
    """Host time of each sweep block, ms a sweep, over a fit of ``sweeps``
    sweeps (no thinning, no transient), and the fit's wall time a sweep
    outside the blocks."""
    from hmsc_tpu_torch.mcmc import sweep as sw

    spent = {}
    orig = sw.make_sweep_schedule

    def timed(*a, **k):
        def wrap(name, block):
            def run(*args):
                t0 = time.perf_counter()
                out = block(*args)
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
                return out
            return run
        return [(n, wrap(n, b)) for n, b in orig(*a, **k)]

    sw.make_sweep_schedule = timed
    try:
        post = ht.sample_mcmc(m, **dict(kw, samples=sweeps, transient=0))
    finally:
        sw.make_sweep_schedule = orig
    per = {n: v * 1e3 / sweeps for n, v in spent.items()}
    per["outside_blocks"] = (post.timing["run_s"] * 1e3 / sweeps
                             - sum(per.values()))
    return per


def quad_wrapper_us(torch, cs, calls=500):
    """Host microseconds a call of B8b's grid-mode and at-alpha wrappers at
    config 3b's level (np 1000, k 10, 101 grid points, 4 chains, nf 2),
    ``calls`` calls queued, then one synchronisation."""
    from hmsc_tpu_torch.ops import spatial as tsp

    dev = torch.device("cuda", 0)
    lvd = cs.nngp_level(torch, dev, 1000, 10, 10.0, seed=1000)
    g = torch.Generator(device=dev).manual_seed(1002)
    alpha = torch.randint(0, 101, (4, 2), generator=g, device=dev,
                          dtype=torch.int32)
    eta = torch.randn((4, 1000, 2), generator=g, device=dev)
    out = {}
    for name, fn in (("nngp_quad_grid", lambda: tsp.nngp_quad_grid(lvd, eta)),
                     ("nngp_quad_at",
                      lambda: tsp.nngp_quad_at(lvd, alpha, eta))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out[name] = host * 1e6 / calls
    return out


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--paths")]
    paths = ["headline", "config3b", "conditional"]
    for a in sys.argv[1:]:
        if a.startswith("--paths"):
            paths = a.split("=", 1)[1].split(",")
    root = pathlib.Path(args[0]).resolve()
    repeats = int(args[1]) if len(args) > 1 else 2
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

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

    h = cs.HEADLINE
    post_h = None
    if "headline" in paths or "conditional" in paths or "quantile" in paths:
        X, Y, _ = cs.simulate_probit(h["ny"], h["ns"],
                                     seed=cs.HEADLINE_DATA_SEED)
        hM = cs.probit_model(ht, X, Y, nf=h["nf"])
    if "headline" in paths:
        out["headline"], post_h = sampler_path(
            torch, cs, ht, K, hM, h["n_chains"], h["samples"],
            h["transient"], cs.HEADLINE_SEED, h["nf"], repeats)
    if "config3b" in paths:
        c = cs.CONFIG3["config3b"]
        m = cs.config3_model(ht, "config3b")
        out["config3b"], post = sampler_path(
            torch, cs, ht, K, m, c["n_chains"], c["samples"],
            c["transient"], cs.CONFIG3_SEED, cs.CONFIG3_NF, repeats)
        out["config3b"]["cg_loop_mean"] = float(np.mean(
            post.cg_iterations["loop"]))
        out["config3b"]["quad_wrapper_host_us"] = quad_wrapper_us(torch, cs)
    if "config5" in paths:
        c5 = cs.CONFIG5
        out["config5"], _ = sampler_path(
            torch, cs, ht, K, cs.config5_model(ht), c5["n_chains"],
            c5["samples"], c5["transient"], c5["seed"], c5["nf"], repeats)
    if "na_headline" in paths:
        na = cs.NA_HEADLINE
        X, Y, _ = cs.simulate_probit(na["ny"], na["ns"],
                                     seed=cs.HEADLINE_DATA_SEED)
        Y[np.random.default_rng(7).uniform(size=Y.shape)
          < na["na_share"]] = np.nan
        m = cs.probit_model(ht, X, Y, nf=na["nf"])
        out["na_headline"], _ = sampler_path(
            torch, cs, ht, K, m, na["n_chains"], na["samples"],
            na["transient"], 1, na["nf"], repeats)
    if "dense_nngp" in paths:
        c = cs.CONFIG3["dense_nngp"]
        m = cs.config3_model(ht, "dense_nngp")
        out["dense_nngp"], _ = sampler_path(
            torch, cs, ht, K, m, c["n_chains"], c["samples"],
            c["transient"], cs.CONFIG3_SEED, cs.CONFIG3_NF, repeats)
    if ("conditional" in paths or "quantile" in paths) and post_h is None:
        post_h = ht.sample_mcmc(hM, samples=h["samples"],
                                transient=h["transient"],
                                n_chains=h["n_chains"],
                                seed=cs.HEADLINE_SEED, nf_cap=h["nf"])
    if "quantile" in paths:
        X64 = np.asarray(hM.X, dtype=np.float32)[:64]
        lvl = hM.rl_names[0]
        units = {lvl: [str(v) for v in hM.df_pi[0][:64]]}
        lat = []
        with ht.ServingEngine(post_h, coalesce_ms=2.0) as engine:
            engine.warmup()
            engine.predict(X64, units=units, quantiles=cs.SERVE_Q)
            for _ in range(20):
                t1 = time.perf_counter()
                engine.predict(X64, units=units, quantiles=cs.SERVE_Q)
                lat.append((time.perf_counter() - t1) * 1e3)
        out["quantile_64_ms"] = lat
        out["quantile_64_p50_ms"] = float(np.percentile(lat, 50))
        out["quantile_64_p99_ms"] = float(np.percentile(lat, 99))
    if "conditional" in paths:
        if post_h is None:
            post_h = ht.sample_mcmc(hM, samples=h["samples"],
                                    transient=h["transient"],
                                    n_chains=h["n_chains"],
                                    seed=cs.HEADLINE_SEED, nf_cap=h["nf"])
        X64 = np.asarray(hM.X, dtype=np.float32)[:64]
        Yc = hM.Y[:64].astype(np.float32)
        Yc[:, hM.ns // 2:] = np.nan
        lat = []
        with ht.ServingEngine(post_h, coalesce_ms=2.0) as engine:
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
