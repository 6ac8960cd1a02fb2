#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hmsc_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

(``scripts/kernel_checks.py`` runs chosen kernels' checks and times
alone.)

Phases, each of which fails the run (non-zero exit, no result line):

1. Device: the card's name and power limit (nvidia-smi), then the build of
   every hand-written kernel from ``hmsc_tpu_torch/csrc`` with nvcc (one
   nvcc per source, all started together).
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it (tolerances stated at each check; the serving
   kernels at the headline posterior's shapes), and B6, B8a, B8b (grid
   mode and at alpha, np 100 to 5000, odd np, C nf 8 and 32), B8d-2,
   B8d-3, B9a and B9b run twice to the same bits; B1's two forms (reading
   E, and forming E from X Beta and the level's loadings) at the
   headline's and config 3b's shapes, against the plain version and
   against each other on the same uniforms and on one Philox stream; the
   GPP Eta draw, in
   float32 with its knot space in float64, against its float64 run from
   the same inputs and against the float64 run from grids made in float64
   on the host, at config 3c's shapes, with the location move's ones-form
   1' iW 1 against its float64 value (C1 of ROADMAP Queue C); B9b's
   sampled means, where they differ from the plain version's, explained
   draw by draw by a float64 Z within a few float32 ulps of 0 (C2); B9b's
   expected moments at every launch geometry of 1-64 query rows, nf 4, 8
   and 16, float32 and bfloat16 draws; B8a's one-launch CG draw against
   the plain host loop (residuals, x, iteration counts, bit-identical
   reruns) with its vectors in shared and in global memory, at np 1000
   and np 5000 (clusters of 8 CTAs); B3's shrinkage form (a level's whole
   psi / delta update in one launch) against the plain update fed with
   its element form's draws at the same Philox counters (1e-5 relative),
   at the headline's, config 5's and config 3's shapes and nf 20 x ns
   5000, its law by KS and moments, bit-identical reruns; B8c (iW in one
   launch) to 1e-5 of its plain version at np 97, 100, 128 (nf 2) and 256
   (nf 1), alpha 0 giving I, bit-identical reruns, timed beside its first
   version (scripts/older/nngp_riw_factor.cu, built here) and its gram;
   B8e (the site-local Vecchia apply) at the B8a levels split over 2 and 4
   ranks: each rank's partials (pmv and riw_t forms) against the plain
   version and their sum in rank order against B8a's unsharded apply
   (1e-5), reruns bit-identical;
   B4 (the GammaV block, the Wishart draw included, in one launch) against
   the plain block fed the same draws (1e-4 relative on iV and Gamma) at
   the headline's nc 2 / nt 1, nc 8 / nt 4 and its cap nc 16 / nt 4 x ns
   5000, a NaN in Beta giving NaN in its chain, bit-identical reruns, and
   the law of its in-kernel draws (iV's mean against df (A + V0)^-1,
   Gamma's conditional mean and covariance); B2 in its three forms (the
   element form, BetaLambda from a chain's gram and from a gram a species,
   Eta from a chain's gram scaled by the row counts and from a gram a
   unit) against the plain assembly and draw (1e-4), planted indefinite
   systems NaN on both sides, bit-identical reruns, the law of its
   in-kernel eps, each timed beside the draw as the sampler ran it before
   (the assembly's torch ops and B2's first version,
   scripts/older/mvn_prec_small.cu, built here); B3's shrinkage form at
   the cluster size the card's occupancy query allows and at 8 blocks, to
   the same bits; B5, one kernel for the whole Z update (normal, probit,
   Poisson cells and imputation), through poisson_z (the Poisson columns
   alone) and z_mixed against their plain versions with injected draws
   (1e-4; probit cells 1e-4 sd plus a slack for s near 1, capped at 1e-3
   sd, and against a float64 draw, B1 held the same on these cells),
   non-finite draws keeping Zprev, bit-identical reruns, the law of the
   in-kernel draws a column at a time, timed beside B5's first version
   (scripts/older/poisson_z.cu) and the Z block as the sampler ran it
   before; B9c (a radix select of
   the wanted ranks) exactly equal to its plain version at 1 to 40000
   draws with ties, +-inf, -0.0 beside +0.0 and NaN columns, timed beside
   its first version (scripts/older/serve_quantile.cu); B10 (the bf16
   tensor-core GEMM with float32 accumulation and output) within 1e-5 of
   the sum of its terms' magnitudes at the policy'd paths' shapes, on
   bf16-exact and general float32 operands, bit-identical reruns; the
   bf16 forms of B4 (1e-4 relative, injected draws), B6 (1e-4), B8b at
   alpha and B8c (1e-5) against their plain versions, each timed beside
   its float32 form.
3. Times: each kernel's device time per launch (torch.profiler, after
   warm-up) beside its plain version's device time per call, the one-call
   PyTorch yardstick where there is one, and the least time the card could
   take for the same work (bytes over 3.35 TB/s or float32 operations over
   67 TFLOP/s, the larger).  Beside them, the CUDA-event time of a batch of
   calls per call, which includes the host's enqueue where that is slower,
   and the same with the stream held until the batch is enqueued (the
   stand-in where the profiler keeps no record of a kernel).  For B9a also
   its issue-rate floor: the instructions a cell of the built kernel's
   per-draw loop (``cuobjdump -sass``) times the cells, over the card's
   issue rate (4 warp instructions a clock on each SM).
4. Recovery: a 200 x 30 probit model; posterior-mean slopes must correlate
   > 0.9 with the simulated ones.
5. The main paths through ``sample_mcmc``, each with every kernel's launch
   counter set to 0 just before and read just after; each count must equal
   the one the sweep schedule implies (0 for a kernel the path does not
   run), the draws must be finite, no chain may diverge and the simulated
   slopes must be recovered:
   a. the headline: the 1000-site x 1000-species probit JSDM, nf_max = 8,
      4 chains (B1's fused form, B2, B3's two forms, B4: the sweep forms no
      linear predictor), whose posterior-mean Beta must match the JAX
      package's (scripts/headline_jax_moments.json, written on the CPU by
      scripts/headline_jax_moments.py) by entrywise z-scores, max < 5 and
      mean < 1.5 (C3);
   b. config 5 of BASELINE.md at its published size: 300 x 90, normal /
      probit / lognormal-Poisson columns, nf 2, 4 chains, 125 + 250 sweeps
      (B5's mixed form, the whole Z update in one launch, B2, B3, B4);
   c. the headline with 10% of Y missing, 10 + 50 sweeps (B1-B3, B6);
   d. the headline with the probit-DA intercept interweave on
      (``updater={"InterweaveDA": True}``), 10 + 50 sweeps (B1-B3, B7);
   e. config 3a of BASELINE.md: a Full spatial level, np 200 (200 x 2 rows
      x 50 probit species), nf 2, 4 chains, 125 + 250 sweeps (B1-B3);
   f. config 3b: an NNGP level with 10 neighbours, np 1000 (2000 x 50),
      nf 2, 4 chains, 125 + 250 sweeps, the matrix-free CG Eta draw (B8a,
      one launch a CG draw, and B8b);
   g. the 3b generator at np 100 (np nf = 200, below the dense/CG
      crossover), 50 + 100 sweeps: the dense NNGP Eta draw (B8b, B8c);
   h. config 3c: the shape of 3b with a GPP level on 100 knots and
      spatially correlated latent factors, 125 + 250 sweeps (B8d-1..3);
   i. serving the headline's posterior (800 draws) through
      ``ServingEngine`` + ``warmup`` (B9a-c): the 1000 training rows served
      and offline ``predict`` against a float64 recomputation, sampled
      means against expected ones, quantiles against torch.quantile, a
      conditional query that must beat the marginal Brier score on
      held-out species, 64 concurrent queries coalesced, random query
      sizes and an epoch flip with no plan built, one HTTP query; every
      sampler kernel 0 launches; latencies printed (the 64-row quantile
      query's p50 and p99 over 20 queries among them).
   The spatial paths must also recover the posterior mean of the GP range
   (alpha) within a stated margin of the JAX package's own value; and the
   alpha sampler, given an Eta drawn at an interior range on the 3a, 3b and
   3c levels, must draw around it.
   k. the sites phase: 2 gloo ranks on the card (``spawn_ranks``; a
      correctness run, gloo stages every collective through host memory):
      on config 3b at its published widths and on the headline, the state
      after 3 site-sharded sweeps within SHARD_AGREEMENT_TOL of the
      single-rank sweep's from one seed, the ranks bit-identical; then
      ``sample_mcmc(mesh=make_mesh(site_shards=2, backend="gloo"))`` at a
      cut depth (SITE_PATHS), the ranks' Posteriors identical, the
      launches the schedule implies (3b: B8e, no B8a), 3b's slope and
      alpha gates, the headline's slope gate; and one all_reduce of 3b's
      CG iterate timed.
   j. the precision phase: the headline through ``sample_mcmc(...,
      precision_policy="auto")`` (BetaLambda and GammaV in bf16: B10 two
      launches a sweep, B4's bf16 form), its launches as the schedule
      implies, slope recovery above 0.9 and the Beta z-scores against the
      JAX package's float32 posterior as in (a); then, on the headline, NA,
      3a, 3b, dense NNGP and 3c, one policy'd sweep against the float32
      sweep from one mid-chain state on copies of one set of random
      streams, the normalised deviation above 0 and at most
      PRECISION_AGREEMENT_TOL (each policy'd block's printed beside the
      port's precision_tolerance.json), B10 and the path's bf16 forms
      launched.
   Then a short torch.profiler window over ten sweeps of each but (g), and
   of the headline under the policy: device time by kernel against the
   run's wall time.
6. One JSON line with every kernel's numbers, then the result line.

It needs the repository (it imports ``hmsc_tpu_torch`` from beside itself)
and a CUDA card, and exits non-zero without either.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores

HEADLINE = dict(ny=1000, ns=1000, nf=8, n_chains=4, transient=10,
                samples=200)
# simulate_probit's data seed and sample_mcmc's seed for the headline
HEADLINE_DATA_SEED, HEADLINE_SEED = 66, 1
# benchmarks/run_benchmarks.py · config5_mixed_distr, SAMPLES, TRANSIENT,
# CHAINS and run_one's seeds
CONFIG5 = dict(ny=300, ns=90, nf=2, n_chains=4, transient=125, samples=250,
               data_seed=42, seed=1)
NA_HEADLINE = dict(HEADLINE, transient=10, samples=50, na_share=0.1)
# the headline with the probit-DA intercept interweave on (B7)
DA_HEADLINE = dict(HEADLINE, transient=10, samples=50)
# the JAX package's own slope correlations on config 5 (CPU, the same data
# and seed; scripts/config5_jax_recovery.py): normal, probit, lognormal
# Poisson.  A block passes above min(0.9, the JAX value - 0.05).
CONFIG5_JAX_SLOPE_CORR = (0.9929, 0.9810, 0.9754)
# benchmarks/run_benchmarks.py · _spatial, config3_spatial_full /
# config3_spatial_nngp, SAMPLES, TRANSIENT, CHAINS and run_one's seeds; the
# dense-NNGP path is the 3b generator at np 100 with fewer sweeps
CONFIG3 = {
    "config3a": dict(np=200, method="Full", n_chains=4, transient=125,
                     samples=250),
    "config3b": dict(np=1000, method="NNGP", n_neighbours=10, n_chains=4,
                     transient=125, samples=250),
    "dense_nngp": dict(np=100, method="NNGP", n_neighbours=10, n_chains=4,
                       transient=50, samples=100),
    # config 3c: the shape of 3b with a GPP level on construct_knots(xy,
    # n_knots=10) (100 knots), and latent factors drawn from the
    # exponential GP exp(-d / 2.0) (not iid: the posterior alpha sits at an
    # interior range, where the knot algebra carries the draw)
    "config3c": dict(np=1000, method="GPP", n_knots=10, gp_range=2.0,
                     n_chains=4, transient=125, samples=250),
}
CONFIG3_DATA_SEED, CONFIG3_SEED, CONFIG3_NF, CONFIG3_NS = 42, 1, 2, 50
# posterior means of the GP range alpha per factor (distance units) from
# the JAX package on the CPU, same data and seed 1
# (scripts/config3_jax_recovery.py; its slope correlations: 0.9889,
# 0.9978, 0.9771, 0.9960).  The 3a/3b generator's latent factors are iid
# over units, so the posterior sits at alpha = 0 (no spatial range); 3c's
# are drawn at range 2.0
CONFIG3_JAX_ALPHA = {"config3a": (0.0, 0.0), "config3b": (0.0, 0.0),
                     "dense_nngp": (0.00034177, 0.0),
                     "config3c": (1.8941740, 1.2273784)}
# the port's posterior-mean alpha must lie within this share of the alpha
# grid's range (the bounding-box diagonal) of the JAX package's, per factor:
# two of the grid's 100 steps (the JAX values of seeds 1-3 span 0.0017, an
# eighth of one step)
ALPHA_MARGIN = 0.02
# the alpha sampler at an interior range, which config 3a's and 3b's data
# (alpha at 0) do not reach: each factor's eta drawn from the 3a, 3b and
# 3c levels' prior at grid index ALPHA_PLANTED; over ALPHA_DRAWS calls of
# update_alpha no
# draw may be index 0 and each factor's mean index must lie within
# ALPHA_PLANTED_MARGIN grid steps of it (on the CPU, with the same Eta, at
# most 2.76 steps for 3a and 1.30 for 3b)
ALPHA_PLANTED, ALPHA_DRAWS, ALPHA_PLANTED_MARGIN = 20, 50, 6


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def event_ms(torch, fn, batch=20, trials=7, warm=3):
    """Median over trials of (CUDA-event time of ``batch`` calls) / batch:
    device time, or the host's enqueue rate when that is slower."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(batch):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / batch)
    return statistics.median(out)


def device_ms(torch, fn, match=None, calls=50, warm=3, windows=3):
    """Device time per call of ``fn`` from torch.profiler: the time of the
    kernels whose name contains ``match`` per launch the profiler recorded
    (on the card's machine it drops records of some launches, so the mean
    is over those it kept), or all of the call's device work per call when
    ``match`` is None.  The host's enqueue cost is not in it.  A window in
    which the profiler kept no record at all is tried again, up to
    ``windows`` times; after that the time comes from CUDA events
    (``held_event_ms``), and a line says so."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e, t in _device_rows(torch, prof):
            if match is None or match in e.key:
                us += t
                n += e.count
        if us > 0:
            if match is None:
                return us / 1e3 / calls
            # more records than calls would mean the name matched others
            assert n <= calls, f"{match}: {n} kernels profiled for {calls} " \
                               f"calls"
            return us / 1e3 / n
    ms = held_event_ms(torch, fn, calls)
    print(f"device_ms: the profiler kept no record of "
          f"{match or 'the call'} in {windows} windows; {ms:.5f} ms a call "
          f"from CUDA events with the stream held while the host enqueued")
    return ms


def held_event_ms(torch, fn, calls=50):
    """CUDA-event time of ``calls`` calls per call, with the stream held by
    a spin kernel until the host has enqueued them all, so that the host's
    enqueue is not in it (the short gaps between kernels are)."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(10_000_000)
    e.record()
    e.synchronize()
    cycles_per_ms = 1e7 / s.elapsed_time(e)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda._sleep(int((2.0 * host_ms + 5.0) * cycles_per_ms))
    s.record()
    for _ in range(calls):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / calls


def _device_rows(torch, prof):
    """(event, self device time in us) for each device row of a profile."""
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            yield e, (e.self_cuda_time_total if us is None else us)


def simulate_probit(ny, ns, seed, n_factors=2):
    """A probit JSDM with design [1, x] and one site-level random level,
    with known coefficients (the JAX package's simulate_jsdm recipe)."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(ny), rng.standard_normal(ny)])
    Beta = rng.standard_normal((2, ns))
    Lam = rng.standard_normal((n_factors, ns)) * (
        0.8 ** np.arange(n_factors))[:, None]
    L = X @ Beta + rng.standard_normal((ny, n_factors)) @ Lam
    Y = (L + rng.standard_normal((ny, ns)) > 0).astype(float)
    return X, Y, Beta


def probit_model(ht, X, Y, nf):
    ny = Y.shape[0]
    units = [f"s{i:04d}" for i in range(ny)]
    rl = ht.HmscRandomLevel(units=units)
    ht.set_priors_random_level(rl, nf_max=nf, nf_min=2)
    return ht.Hmsc(Y=Y, X=X, study_design=np.array(units)[:, None],
                   ran_levels={"sample": rl}, distr="probit", x_scale=False)


def config5_data():
    """BASELINE.md config 5, as ``benchmarks/run_benchmarks.py ·
    config5_mixed_distr`` draws it from ``default_rng(42)``: X, Y, the
    families and the simulated coefficients."""
    c = CONFIG5
    ny, ns = c["ny"], c["ns"]
    rng = np.random.default_rng(c["data_seed"])
    X = np.column_stack([np.ones(ny), rng.standard_normal(ny)])
    Beta = rng.standard_normal((2, ns)) * 0.5
    Z = X @ Beta + rng.standard_normal((ny, ns))
    Y = np.empty((ny, ns))
    distr = ["normal"] * 30 + ["probit"] * 30 + ["lognormal poisson"] * 30
    Y[:, :30] = Z[:, :30]
    Y[:, 30:60] = (Z[:, 30:60] > 0).astype(float)
    Y[:, 60:] = rng.poisson(np.exp(np.clip(Z[:, 60:], -8, 4)))
    return X, Y, distr, Beta


def config5_model(pkg):
    """Config 5 as an ``Hmsc`` of ``pkg`` (this port, or any package with
    the same constructors): one site-level level with nf_max = nf_min = 2."""
    X, Y, distr, _ = config5_data()
    units = [f"s{i:05d}" for i in range(Y.shape[0])]
    rl = pkg.HmscRandomLevel(units=units)
    pkg.set_priors_random_level(rl, nf_max=CONFIG5["nf"],
                                nf_min=CONFIG5["nf"])
    return pkg.Hmsc(Y=Y, X=X, distr=distr,
                    study_design=np.array(units)[:, None],
                    ran_levels={"sample": rl}, x_scale=False)


class _Named:
    """Coordinate rows with unit names, read as a pandas DataFrame would be
    (``values``, ``index``) by both packages' ``HmscRandomLevel``, so that
    the units keep the benchmark's names and order without pandas."""

    def __init__(self, values, index):
        self.values, self.index = values, index


def config3_data(name):
    """A config-3 model's inputs as ``benchmarks/run_benchmarks.py ·
    _spatial`` draws them from ``default_rng(42)``: two rows per unit,
    design [1, x], two iid latent factors (for 3c the same normals through
    the Cholesky factor of the exponential GP's covariance at the path's
    ``gp_range``), 50 probit species.  Returns (coordinates, unit labels
    per row, X, Y, simulated Beta)."""
    c = CONFIG3[name]
    n = c["np"]
    rng = np.random.default_rng(CONFIG3_DATA_SEED)
    ny, ns = 2 * n, CONFIG3_NS
    units = [f"u{i:04d}" for i in range(n)]
    unit_of = np.repeat(np.arange(n), 2)
    xy = _Named(rng.uniform(size=(n, 2)) * 10, units)
    X = np.column_stack([np.ones(ny), rng.standard_normal(ny)])
    eta = rng.standard_normal((n, 2))
    if "gp_range" in c:
        d = np.sqrt(((xy.values[:, None] - xy.values[None]) ** 2).sum(-1))
        eta = np.linalg.cholesky(np.exp(-d / c["gp_range"])) @ eta
    lam = rng.standard_normal((2, ns))
    Beta = rng.standard_normal((2, ns)) * 0.5
    L = X @ Beta + eta[unit_of] @ lam
    Y = ((L + rng.standard_normal((ny, ns))) > 0).astype(float)
    return xy, np.array(units)[unit_of], X, Y, Beta


def config3_model(pkg, name):
    """A config-3 model as an ``Hmsc`` of ``pkg`` (this port or the JAX
    package): one spatial level "plot" with nf_max = nf_min = 2."""
    c = CONFIG3[name]
    xy, labels, X, Y, _ = config3_data(name)
    kw = {"n_neighbours": c["n_neighbours"]} if c["method"] == "NNGP" else {}
    if c["method"] == "GPP":
        kw["s_knot"] = pkg.construct_knots(xy.values, n_knots=c["n_knots"])
    rl = pkg.HmscRandomLevel(s_data=xy, s_method=c["method"], **kw)
    pkg.set_priors_random_level(rl, nf_max=CONFIG3_NF, nf_min=CONFIG3_NF)
    return pkg.Hmsc(Y=Y, X=X, distr="probit", study_design=labels[:, None],
                    ran_levels={"plot": rl}, x_scale=False)


def alpha_mean(post, hM):
    """Posterior mean of each factor's GP range (distance units)."""
    grid = hM.ranLevels[0].alphapw[:, 0]
    return grid[post["Alpha_0"]].mean(axis=(0, 1)).tolist()


def planted_eta(lp, g, C, nf, seed):
    """(C, np, nf) draws from a Full or NNGP level's prior at grid index
    ``g`` (float64, on the host): Full through the Cholesky factor of W_g;
    NNGP unit by unit, each from its neighbours, which precede it."""
    rng = np.random.default_rng(seed)
    if lp.kind == "Full":
        z = rng.standard_normal((C, lp.iWg.shape[1], nf))
        L = np.linalg.cholesky(np.linalg.inv(lp.iWg[g]))
        return np.einsum("uv,cvf->cuf", L, z)
    if lp.kind == "GPP":
        # the predictive process: knot values w ~ N(0, W22), then eta =
        # W12 W22^-1 w + sqrt(dD) z, with W12, W22 and dD recovered from
        # the grids (idD W12, F = W22 + W12' idD W12)
        idD, M = lp.idDg[g], lp.idDW12g[g]
        W12 = M / idD[:, None]
        W22 = lp.Fg[g] - W12.T @ M
        nK = W22.shape[0]
        w = np.einsum("mk,ckf->cmf", np.linalg.cholesky(W22),
                      rng.standard_normal((C, nK, nf)))
        z = rng.standard_normal((C, len(idD), nf))
        return (np.einsum("um,cmf->cuf", W12 @ np.linalg.inv(W22), w)
                + z / np.sqrt(idD)[None, :, None])
    z = rng.standard_normal((C, lp.nn_idx.shape[0], nf))
    eta = np.zeros_like(z)
    for i in range(z.shape[1]):
        nb = lp.nn_idx[i, :lp.nn_n[i]]
        eta[:, i] = (np.einsum("k,ckf->cf", lp.nn_coef[g, i, :len(nb)],
                               eta[:, nb])
                     + np.sqrt(lp.nn_D[g, i]) * z[:, i])
    return eta


def check_alpha_planted(torch, ht, card):
    """update_alpha on the card for config 3a's, 3b's and 3c's levels (3b
    through B8b's grid mode, 3c through B8d-3's), with every chain's Eta
    planted at ALPHA_PLANTED."""
    from hmsc_tpu_torch.mcmc.sampler import initial_states
    from hmsc_tpu_torch.mcmc.spatial import update_alpha
    from hmsc_tpu_torch.mcmc.structs import build_model_data, build_spec
    from hmsc_tpu_torch.ops.rand import Rng
    from hmsc_tpu_torch.precompute import compute_data_parameters

    dev = torch.device("cuda", 0)
    for name in ("config3a", "config3b", "config3c"):
        m = config3_model(ht, name)
        C = CONFIG3[name]["n_chains"]
        spec = build_spec(m, CONFIG3_NF)
        dp = compute_data_parameters(m)
        data = build_model_data(m, dp, spec, dev)
        state, _ = initial_states(m, spec, CONFIG3_SEED, C, dev)
        eta = planted_eta(dp.rL_par[0], ALPHA_PLANTED, C, CONFIG3_NF, seed=5)
        st = state.replace(levels=(state.levels[0].replace(Eta=torch.tensor(
            eta, dtype=torch.float32, device=dev)),))
        rng = Rng(3, dev)
        draws = torch.stack([update_alpha(spec, data, st, 0, rng=rng)
                             .alpha_idx for _ in range(ALPHA_DRAWS)])
        draws = draws.cpu().numpy()
        off = np.abs(draws.mean(axis=0) - ALPHA_PLANTED).max()
        assert draws.min() > 0, f"{name}: update_alpha drew index 0"
        assert off <= ALPHA_PLANTED_MARGIN, (
            f"{name}: a factor's mean alpha index is {off} grid steps from "
            f"the planted {ALPHA_PLANTED} (> {ALPHA_PLANTED_MARGIN})")
        print(f"{name} alpha sampler, Eta planted at grid index "
              f"{ALPHA_PLANTED}: {ALPHA_DRAWS} draws in "
              f"[{draws.min()}, {draws.max()}], factors' mean indices at most"
              f" {off:.2f} steps from it (<= {ALPHA_PLANTED_MARGIN}) [{card}]")


def slope_corr(post, Beta):
    slope = post["Beta"][:, :, 1, :].mean(axis=(0, 1))
    return float(np.corrcoef(slope, Beta[1])[0, 1])


def posterior_moments(draws):
    """Entrywise posterior mean and its standard error from (chains,
    samples, ...) draws.  The SE is the larger of the batch-means SE (each
    chain cut into floor(sqrt(samples)) batches, the batch means pooled
    over chains about the grand mean) and the between-chain SE (the chain
    means' sd over sqrt(chains)), as ``tests/test_parity.py · _z_scores``
    takes the larger of its ESS-based and between-chain SEs."""
    A = np.asarray(draws, dtype=np.float64)
    C, n = A.shape[:2]
    nb = max(2, math.isqrt(n))
    size = n // nb
    bm = A[:, :nb * size].reshape((C, nb, size) + A.shape[2:]).mean(axis=2)
    bm = bm.reshape((C * nb,) + A.shape[2:])
    se = bm.std(axis=0, ddof=1) / math.sqrt(C * nb)
    if C >= 2:
        se = np.maximum(se, A.mean(axis=1).std(axis=0, ddof=1) / math.sqrt(C))
    return A.mean(axis=(0, 1)), se


# C3: Beta's posterior moments from the JAX package on the headline (the
# CPU, scripts/headline_jax_moments.py); the port's headline run must match
# them entrywise with z-scores below these bounds (tests/test_parity.py)
HEADLINE_JAX_MOMENTS = "scripts/headline_jax_moments.json"
Z_MAX, Z_MEAN = 5.0, 1.5


def check_headline_parity(post, card):
    """Entrywise z-scores of the port's headline posterior-mean Beta
    against the JAX package's, each side's SE from
    :func:`posterior_moments`: max below ``Z_MAX``, mean below
    ``Z_MEAN``."""
    import pathlib

    ref = json.loads((pathlib.Path(__file__).resolve().parent
                      / HEADLINE_JAX_MOMENTS).read_text())
    mean, se = posterior_moments(post["Beta"])
    jm, js = np.asarray(ref["mean"]), np.asarray(ref["se"])
    assert jm.shape == mean.shape, (jm.shape, mean.shape)
    z = np.abs(mean - jm) / np.sqrt(se ** 2 + js ** 2)
    print(f"headline parity with the JAX package (CPU, "
          f"{HEADLINE_JAX_MOMENTS}): Beta z-scores over {z.size} entries, "
          f"max {z.max():.3f} (< {Z_MAX}), mean {z.mean():.3f} (< {Z_MEAN}); "
          f"intercepts max {z[0].max():.3f}, slopes max {z[1].max():.3f} "
          f"[{card}]")
    assert z.max() < Z_MAX and z.mean() < Z_MEAN, \
        f"headline parity: z max {z.max()}, mean {z.mean()}"


def block_slope_corr(post, Beta):
    """Per family block of config 5 (30 columns each): correlation of the
    posterior-mean slopes with the simulated ones."""
    slope = post["Beta"][:, :, 1, :].mean(axis=(0, 1))
    return [float(np.corrcoef(slope[b:b + 30], Beta[1, b:b + 30])[0, 1])
            for b in (0, 30, 60)]


# B1's shapes: the headline's (one unit a row) and config 3b's (np 1000
# units of two rows each, nf 2, 50 species)
B1_SHAPES = (("headline", dict(C=HEADLINE["n_chains"], ny=HEADLINE["ny"],
                               ns=HEADLINE["ns"], nc=2, npr=HEADLINE["ny"],
                               nf=HEADLINE["nf"])),
             ("config3b", dict(C=CONFIG3["config3b"]["n_chains"],
                               ny=2 * CONFIG3["config3b"]["np"],
                               ns=CONFIG3_NS, nc=2,
                               npr=CONFIG3["config3b"]["np"],
                               nf=CONFIG3_NF)))
# float operations a cell of B1's truncated normal, counted from the
# shipped arithmetic (csrc/truncnorm.cuh, an FMA as 2, each exp2 / log2 /
# rsqrt / reciprocal as 1, on the path below 9 sd): the uniform from its
# Philox bits 3; the draw's standardisation, reflection, scaled and clamped
# probability, clip, sign and shift 9; upper_prob 29 (the scaled |t|, the
# reciprocal of 1 + z / 2, erfc's 9-term polynomial, the exponent, exp2 and
# its scaling, the reflection); neg_ndtri 37 (AS 241's central numerator
# and denominator, log2 and sqrt of the tail variable, the taken tail's
# rationals, the select and one reciprocal).  The Philox quarter is integer
# work, left out; the fused form adds 2 K for E
B1_OPS_A_CELL = 78


def b1_inputs(torch, dev, C, ny, ns, nc, npr, nf, seed):
    """B1's operands on the card: the fused form's (X, Beta, a level whose
    pi gathers np units for ny rows, one factor of chain 0 inactive), the
    E-reading form's E formed from them by the plain version's arithmetic,
    sd, Y and injected uniforms.  Row 0 of X is scaled so that its linear
    predictors reach past 9 sd on both sides (the far tail); row 1's
    uniforms are 1 - 2^-24, within one ulp of 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *sh: torch.randn(sh, generator=g, device=dev)
    X = torch.cat([torch.ones((ny, 1), device=dev), rn(ny, nc - 1)], dim=1)
    X[0] *= 12.0
    Beta, Eta, Lam = rn(C, nc, ns), rn(C, npr, nf), rn(C, nf, ns) * 0.5
    mask = torch.ones((C, nf), device=dev)
    mask[0, -1] = 0.0
    pi = (torch.arange(ny, device=dev) * npr // ny).to(torch.int64)
    if npr == ny:
        pi = torch.randperm(ny, generator=g, device=dev)
    level = (Eta, pi, Lam, mask)
    E = X @ Beta + Eta[:, pi] @ (Lam * mask[:, :, None])
    std = torch.rand((C, ns), generator=g, device=dev) * 1.5 + 0.5
    Y = (torch.rand((ny, ns), generator=g, device=dev) < 0.5).float()
    u = torch.rand((C, ny, ns), generator=g, device=dev).clamp_min_(1e-38)
    u[:, 1, :] = 1.0 - 2.0 ** -24
    t = torch.where(Y > 0.5, -E / std[:, None, :], E / std[:, None, :])
    assert (t > 9).any() and (t < -9).any()
    return X, Beta, level, E, std, Y, u


def check_b1(torch, trand, dev, card):
    """B1's two forms (E-reading, fused) against the plain version on
    injected uniforms at the headline's and config 3b's shapes, the fused
    form against the E-reading one on the same uniforms and on the same
    in-kernel Philox stream, each form's in-kernel draws by moments; then
    both forms' times at each shape; last the E-reading form on the probit
    cells of B5's mixed-form inputs, where s = u P(W > t) nears 1, by
    ``_probit_gate``.  Returns both kernels' numbers at the headline
    shape."""
    res = {}
    for label, sh in B1_SHAPES:
        C, ny, ns, nc, npr, nf = (sh[k] for k in ("C", "ny", "ns", "nc",
                                                  "npr", "nf"))
        X, Beta, level, E, std, Y, u = b1_inputs(torch, dev, C, ny, ns, nc,
                                                 npr, nf, seed=ny + ns)
        sd = std[:, None, :]
        zp = trand._truncated_normal_onesided_plain(E, std, Y, u)
        zk = trand.truncated_normal_onesided(E, std, Y, u=u)
        zf = trand.probit_z_fused(X, Beta, std, Y, u=u, level=level)
        zfp = trand._probit_z_fused_plain(X, Beta, std, Y, u, level)
        assert torch.isfinite(zk).all() and torch.isfinite(zf).all(), \
            "B1: non-finite draws"
        errs = {"E-reading - plain": ((zk - zp).abs() / sd).max().item(),
                "fused - plain": ((zf - zfp).abs() / sd).max().item(),
                "fused - E-reading": ((zf - zk).abs() / sd).max().item()}
        for what, err in errs.items():
            assert err <= 1e-4, f"B1 {label} {what}: max |diff|/sd {err} " \
                                f"> 1e-4"
        print(f"B1 check {label} (C {C}, ny {ny}, ns {ns}, np {npr}, nf "
              f"{nf}), injected uniforms: max |diff| / sd "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + " (tolerance 1e-4)")
        r1, r2 = trand.Rng(7, dev), trand.Rng(7, dev)   # one Philox stream
        wk = (trand.truncated_normal_onesided(E, std, Y, r1) - E) / sd
        wf = (trand.probit_z_fused(X, Beta, std, Y, r2, level=level)
              - E) / sd
        same = (wf - wk).abs().max().item()
        assert same <= 1e-4, f"B1 {label}: forms on one Philox stream " \
                             f"differ by {same} sd"
        wp = (trand._truncated_normal_onesided_plain(
            E, std, Y, r1.uniform(E.shape)) - E) / sd
        for cls in (1.0, 0.0):
            m = (Y == cls).expand_as(E)
            print(f"B1 check {label}: in-kernel Philox, Y={int(cls)}: "
                  + _moments_agree(f"B1 Philox class {cls}", wk[m], wp[m])
                  + f"; the fused form on the same stream within {same:.3g}"
                  " sd")

        rng = trand.Rng(8, dev)
        forms = {
            "probit_z": (lambda: trand.truncated_normal_onesided(
                E, std, Y, rng),
                lambda: trand._truncated_normal_onesided_plain(
                    E, std, Y, rng.uniform(E.shape)),
                4.0 * (2 * E.numel() + ny * ns + C * ns),
                B1_OPS_A_CELL * E.numel()),
            "probit_z_fused": (lambda: trand.probit_z_fused(
                X, Beta, std, Y, rng, level=level),
                lambda: trand._probit_z_fused_plain(
                    X, Beta, std, Y, rng.uniform(E.shape), level),
                4.0 * (E.numel() + ny * ns + ny * nc + C * nc * ns
                       + C * npr * nf + C * nf * ns + C * nf + C * ns)
                + 8.0 * ny,
                (B1_OPS_A_CELL + 2 * (nc + nf)) * E.numel())}
        for name, (kern, plain, nbytes, ops) in forms.items():
            ms = device_ms(torch, kern, "probit_z_kernel")
            plain_ms = device_ms(torch, plain, calls=10)
            ev, plain_ev = event_ms(torch, kern), event_ms(torch, plain,
                                                           batch=5)
            held = held_event_ms(torch, kern)
            b, by = bound_ms(nbytes, ops)
            print(f"B1 {name} device time at {label}: {ms:.5f} ms (plain "
                  f"{plain_ms:.4f} ms, bound {b:.5f} ms by {by}; held stream "
                  f"{held:.5f} ms, with enqueue {ev:.4f} ms, plain "
                  f"{plain_ev:.4f} ms) at E {C}x{ny}x{ns} [{card}]")
            if label == "headline":
                res[name] = dict(max_abs_err=max(errs.values()), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                 library_ms=None, event_ms=ev,
                                 plain_event_ms=plain_ev, held_ms=held)
            else:
                res[name][f"{label}_ms"] = ms
                res[name][f"{label}_bound_ms"] = b
    # the probit cells of check_b5's mixed-form inputs at the headline's
    # shape, where s = u P(W > t) comes within ~1e-6 of 1 and the
    # quantile's slope is steep: the E-reading form held as check_b5 holds
    # the mixed form's probit cells there
    args, nz = mixed_inputs(torch, dev, HEADLINE["n_chains"], HEADLINE["ny"],
                            HEADLINE["ns"], seed=9, na=0.1)
    Y, _, E, iSigma, fam, _ = args
    pc = fam == 2
    E, Y, u = (E[..., pc].contiguous(), Y[:, pc].contiguous(),
               nz["u"][..., pc].contiguous())
    std = (iSigma[:, pc] ** -0.5).contiguous()
    zk = trand.truncated_normal_onesided(E, std, Y, u=u)
    zp = trand._truncated_normal_onesided_plain(E, std, Y, u)
    line = _probit_gate(torch, "B1 the mixed form's probit cells", zk, zp,
                        E, std[:, None, :].expand_as(zk), Y, u,
                        torch.ones_like(zk, dtype=torch.bool))
    print(f"B1 check at the mixed form's probit cells (C {E.shape[0]}, ny "
          f"{E.shape[1]}, {E.shape[2]} columns), injected uniforms: {line}")
    return res


B2_FIRST_SOURCE = "scripts/older/mvn_prec_small.cu"


def first_b2(torch, lib, prec, rhs, eps):
    """B2's first version on the card (one system a thread, the element
    form): the draw the sampler ran before the assembly was fused."""
    import ctypes

    fn = lib.hmsc_mvn_prec_small
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    P = rhs.shape[-1]
    out = torch.empty_like(rhs)
    code = fn(prec.data_ptr(), rhs.data_ptr(), eps.data_ptr(),
              out.data_ptr(), rhs.numel() // P, P,
              torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"B2 first version: cudaError {code}"
    return out


def b2_inputs(torch, dev, form, seed):
    """Inputs of one B2 form at the headline's shapes (C 4; BetaLambda: ns
    1000, nc 2, nf 8, P 10; Eta: np 1000, nf 8), with three planted
    systems that are not positive definite; returns (kwargs of the
    wrapper, the planted flat system indices)."""
    C, ns, nf = HEADLINE["n_chains"], HEADLINE["ns"], HEADLINE["nf"]
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    ru = lambda *s: torch.rand(s, generator=g, device=dev)
    bad = torch.tensor([3, ns + 17, C * ns - 1], device=dev)
    if form == "element":                        # BetaLambda's P, as given
        P, B = 2 + nf, C * ns
        M = rn(B, P, P)
        prec = M @ M.transpose(1, 2) / P + torch.eye(P, device=dev)
        prec[bad] -= 10.0 * torch.eye(P, device=dev)
        return dict(prec=prec, rhs=rn(B, P), eps=rn(B, P)), bad
    if form.startswith("beta_lambda"):
        nc, nt, P = 2, 1, 2 + nf
        XE = rn(C, 1000, P)
        XE[:, :, 0] = 1.0
        G = (XE.transpose(1, 2) @ XE)[:, None]   # (C, 1, P, P)
        if form == "beta_lambda_na":             # a gram a species
            M = rn(C, ns, P, P)
            G = (G * (0.8 + 0.2 * ru(C, ns, 1, 1))
                 + M @ M.transpose(2, 3)).contiguous()
        A = rn(C, nc, nc)
        prior = 0.5 + 2.0 * ru(C, P - nc, ns)
        prior.view(C * (P - nc), ns)[0, 3] = -1e7
        prior.view(C, P - nc, ns)[1, 2, 17] = -1e7
        prior.view(C, P - nc, ns)[C - 1, P - nc - 1, ns - 1] = -1e7
        return dict(G=G, rhs_lik=10.0 * rn(C, ns, P),
                    iSigma=0.5 + ru(C, ns),
                    iV=A @ A.transpose(1, 2) + torch.eye(nc, device=dev),
                    prior=prior, Gamma=rn(C, nc, nt), Tr=rn(ns, nt),
                    eps=rn(C, ns, P)), bad
    npr = ns                                     # Eta: a unit a site
    L = 0.3 * rn(C, nf, 1000)
    G = (L @ L.transpose(1, 2))[:, None]         # (C, 1, nf, nf)
    scale = torch.randint(1, 4, (npr,), generator=g, device=dev).float()
    if form == "eta_na":                         # a gram a unit
        M = rn(C, npr, nf, nf)
        G = (M @ M.transpose(2, 3) / nf).contiguous()
        scale = None
        G.view(C * npr, nf, nf)[bad] -= 10.0 * torch.eye(nf, device=dev)
    else:                                        # negative row counts
        bad = torch.tensor([3, 17, npr - 1], device=dev)
        scale[bad] = -1e4
        bad = (bad[None, :] + npr * torch.arange(C, device=dev)[:, None]
               ).flatten().sort().values
    return dict(G=G, rhs=rn(C, npr, nf), scale=scale, eps=rn(C, npr, nf)), \
        bad


def b2_calls(torch, tlinalg, form, kw):
    """(kernel, plain) draws of one form from ``kw`` (its eps injected)."""
    plain = tlinalg._sample_mvn_prec_small_plain
    if form == "element":
        return (lambda: tlinalg.sample_mvn_prec_batched(**kw),
                lambda: plain(**kw))
    if form.startswith("beta_lambda"):
        sys_kw = {k: v for k, v in kw.items() if k != "eps"}
        return (lambda: tlinalg.sample_beta_lambda(**kw),
                lambda: plain(*tlinalg._beta_lambda_system(**sys_kw),
                              kw["eps"]))

    def eta_plain():
        G, s = kw["G"], kw["scale"]
        LiSL = G if s is None else s[:, None, None] * G
        P = G.shape[-1]
        return plain(LiSL + torch.eye(P, device=G.device), kw["rhs"],
                     kw["eps"])
    return lambda: tlinalg.sample_mvn_prec_shifted(**kw), eta_plain


# B2's forms: the element form (the JAX op's signature), BetaLambda from the
# chain's shared gram (the headline) and from a gram a species (NA), the
# Eta draw from the shared gram scaled by the row counts and from a gram a
# unit (NA)
B2_FORMS = ("element", "beta_lambda", "beta_lambda_na", "eta", "eta_na")


def b2_law(torch, tlinalg, trand, dev):
    """The in-kernel Philox eps: 4096 copies of one Eta system (I + G) drawn
    with eps from the kernel; mean and covariance against float64."""
    nf, n = HEADLINE["nf"], 4096
    g = torch.Generator(device=dev).manual_seed(71)
    L = 0.5 * torch.randn((1, nf, 20), generator=g, device=dev)
    G = (L @ L.transpose(1, 2))[:, None]
    rhs = torch.randn((1, 1, nf), generator=g, device=dev).expand(
        1, n, nf).contiguous()
    x = tlinalg.sample_mvn_prec_shifted(G, rhs, None, None,
                                        trand.Rng(72, dev))[0].double()
    prec = G[0, 0].double() + torch.eye(nf, device=dev, dtype=torch.float64)
    prec = prec + (1e-6 / nf) * torch.trace(prec) * torch.eye(
        nf, device=dev, dtype=torch.float64)
    cov = torch.linalg.inv(prec)
    mean = cov @ rhs[0, 0].double()
    se = (torch.diagonal(cov) / n).sqrt()
    z = ((x.mean(0) - mean).abs() / se).max().item()
    xc = x - x.mean(0)
    S = xc.T @ xc / (n - 1)
    d = torch.diagonal(cov)
    se_cov = ((d[:, None] * d[None, :] + cov ** 2) / n).sqrt()
    zc = ((S - cov).abs() / se_cov).max().item()
    assert z < 4.5 and zc < 5.0, f"B2 Philox eps: mean z {z}, cov z {zc}"
    return z, zc


def check_b2(torch, tlinalg, trand, dev, card):
    """B2 in every form (``B2_FORMS``) against its plain version (the
    assembly as torch ops, then the unrolled draw) on the same inputs and
    eps: max |kernel - plain| / max |plain| <= 1e-4; the planted indefinite
    systems NaN on both sides and no other; a rerun, with the eps injected
    and with Philox eps at a fixed (seed, offset), to the same bits; the
    law of the in-kernel eps.  Each form timed with the sampler's own call
    (Philox eps) beside the plain version and the draw as the sampler ran
    it before: the assembly's torch ops, a torch.randn and B2's first
    version (``scripts/older/mvn_prec_small.cu``, built here)."""
    first = build_source(B2_FIRST_SOURCE, "mvn_prec_small_first")
    res, worst = {}, 0.0
    for form in B2_FORMS:
        kw, bad = b2_inputs(torch, dev, form, seed=len(form))
        kern, plain = b2_calls(torch, tlinalg, form, kw)
        xk, xp = kern(), plain()
        P = xk.shape[-1]
        xk2, xp2 = xk.reshape(-1, P), xp.reshape(-1, P)
        nan_k, nan_p = torch.isnan(xk2).all(1), torch.isnan(xp2).all(1)
        assert torch.equal(nan_k, nan_p), f"B2 {form}: NaN rows differ"
        assert torch.equal(torch.nonzero(nan_k)[:, 0], bad), \
            f"B2 {form}: NaN rows {torch.nonzero(nan_k)[:, 0].tolist()}"
        ok = ~nan_k
        assert torch.isfinite(xk2[ok]).all(), f"B2 {form}: non-finite draws"
        abs_err = (xk2[ok] - xp2[ok]).abs().max().item()
        rel = abs_err / xp2[ok].abs().max().item()
        assert rel <= 1e-4, f"B2 {form}: max rel diff {rel} > 1e-4"
        assert torch.equal(torch.nan_to_num(kern()), torch.nan_to_num(xk)), \
            f"B2 {form}: a rerun gave other bits"
        worst = max(worst, abs_err)
        # the sampler's own call: eps from Philox in the kernel
        kw_s = dict(kw, eps=None)
        if form == "element":
            kw_s = kw                            # the JAX op takes its eps
        else:
            fixed = [getattr(tlinalg, "sample_beta_lambda"
                             if form.startswith("beta") else
                             "sample_mvn_prec_shifted")(
                **kw_s, rng=FixedPhilox(0x5EED, 77)) for _ in range(2)]
            assert torch.equal(torch.nan_to_num(fixed[0]),
                               torch.nan_to_num(fixed[1])), \
                f"B2 {form}: a Philox rerun gave other bits"
        rng = trand.Rng(5, dev)
        fn = {"element": lambda: tlinalg.sample_mvn_prec_batched(**kw_s),
              "beta_lambda": lambda: tlinalg.sample_beta_lambda(**kw_s,
                                                                rng=rng),
              "eta": lambda: tlinalg.sample_mvn_prec_shifted(**kw_s,
                                                             rng=rng)}[
            form.replace("_na", "")]

        def before():
            if form == "element":
                p_, r_ = kw["prec"], kw["rhs"]
            elif form.startswith("beta"):
                p_, r_ = tlinalg._beta_lambda_system(
                    **{k: v for k, v in kw.items() if k != "eps"})
            else:
                G, s = kw["G"], kw["scale"]
                p_ = (G if s is None else s[:, None, None] * G) \
                    + torch.eye(P, device=dev)
                r_ = kw["rhs"]
            e_ = kw["eps"] if form == "element" else torch.randn(
                r_.shape, device=dev)
            return first_b2(torch, first, p_.expand(
                r_.shape + (P,)).contiguous(), r_, e_)

        xb = before()
        if form == "element":
            xb2 = xb.reshape(-1, P)
            rel_first = ((xb2[ok] - xp2[ok]).abs().max()
                         / xp2[ok].abs().max()).item()
            assert rel_first <= 1e-4, f"B2 first version: {rel_first}"
        ms = device_ms(torch, fn, "mvn_prec_small_kernel")
        plain_ms = device_ms(torch, plain, calls=10)
        before_ms = device_ms(torch, before)
        first_ms = device_ms(torch, before, "mvn_prec_small_kernel")
        ev, plain_ev = event_ms(torch, fn), event_ms(torch, plain, batch=5)
        before_ev = event_ms(torch, before)
        held = held_event_ms(torch, fn)
        B = xk2.shape[0]
        # bytes: what the form reads (the element form its precisions; the
        # others their grams, a chain's or a system's, the right-hand sides,
        # the scale, priors, iV, Gamma, Tr) and the draw out; operations:
        # P^3/3 (factor) + 2 P^2 (two solves) + 2 P (sqrt, reciprocal), P^2
        # for the assembly and ~130 for each in-kernel normal (a Philox
        # call and Box-Muller), a system
        G = kw.get("G", kw.get("prec"))
        nbytes = 4.0 * (G.numel() + 2 * B * P + sum(
            kw[k].numel() for k in ("iSigma", "iV", "prior", "Gamma", "Tr",
                                    "scale") if kw.get(k) is not None))
        if form == "element":
            nbytes += 4.0 * B * P                # its eps
        ops = B * (P ** 3 / 3 + 2 * P * P + 2 * P + (
            0 if form == "element" else P * P + 130 * P))
        b, by = bound_ms(nbytes, ops)
        print(f"B2 check {form}: {B} systems of P={P}, shared eps: max "
              f"|diff| {abs_err:.3g}, max rel diff {rel:.3g} (tolerance "
              f"1e-4); planted indefinite systems NaN on both sides, no "
              f"other; reruns give the same bits")
        print(f"B2 mvn_prec_small {form} device time: {ms:.5f} ms (the draw "
              f"as the sampler ran it before: {before_ms:.5f} ms of device "
              f"work, its first-version B2 launch {first_ms:.5f} ms, with "
              f"enqueue {before_ev:.4f} ms; plain {plain_ms:.4f} ms, bound "
              f"{b:.6f} ms by {by}; held stream {held:.5f} ms, with enqueue "
              f"{ev:.4f} ms, plain {plain_ev:.4f} ms) at {B} systems "
              f"[{card}]")
        res[form] = dict(max_abs_err=abs_err, rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=b, bound_by=by,
                         library_ms=None, event_ms=ev,
                         plain_event_ms=plain_ev, held_ms=held,
                         before_ms=before_ms, before_event_ms=before_ev,
                         first_ms=first_ms)
    z, zc = b2_law(torch, tlinalg, trand, dev)
    print(f"B2 law of the in-kernel eps: 4096 draws of one Eta system, max "
          f"|z| of the mean {z:.3g} (< 4.5), of the covariance {zc:.3g} "
          f"(< 5) against float64")
    # the line reports the BetaLambda form from the shared gram (the
    # headline's call), with every form's numbers beside it
    out = dict(res["beta_lambda"], max_abs_err=worst)
    out["by_form"] = {f: {k: r[k] for k in (
        "ms", "event_ms", "bound_ms", "plain_ms", "before_ms",
        "before_event_ms", "first_ms", "rel_err")} for f, r in res.items()}
    return out


def check_b3(torch, trand, dev, card):
    from scipy import stats

    C, ns, nf = HEADLINE["n_chains"], HEADLINE["ns"], HEADLINE["nf"]
    rng = trand.Rng(11, dev)
    worst = 0.0
    # the stated shapes on 100000 elements, then the headline's own draws:
    # LambdaPriors' psi (nu/2 + 1/2 = 2 at nu = 3) at its (C, nf, ns, 1),
    # the Wishart diagonal (~500) and a delta shape (a1 + ns nf / 2 ~ 4000)
    cases = [((100000,), a) for a in (0.3, 1.0, 4.5, 1500.0)] + [
        ((C, nf, ns, 1), 2.0), ((100000,), 500.0), ((100000,), 4000.0)]
    for shape, a in cases:
        av = torch.full(shape, a, device=dev)
        n = av.numel()
        gk = trand.standard_gamma(av, rng).double().cpu().numpy().ravel()
        gp = trand._standard_gamma_plain(av, rng).double().cpu().numpy(
            ).ravel()
        assert np.isfinite(gk).all() and (gk > 0).all(), f"B3 a={a}"
        p = stats.ks_2samp(gk, gp).pvalue
        dm = abs(gk.mean() - gp.mean())
        dv = abs(gk.var() - gp.var())
        se_m = math.sqrt(2 * a / n)
        se_v = math.sqrt(2 * (2 * a * a + 6 * a) / n)
        assert p > 1e-3, f"B3 a={a}: KS p {p} <= 1e-3"
        assert dm < 4 * se_m and dv < 4 * se_v, f"B3 a={a}: moments"
        worst = max(worst, float(dm))
        print(f"B3 check: a={a}, shape {shape}: KS p {p:.3g} (> 1e-3), "
              f"|mean diff| {dm:.3g} (4 SE {4 * se_m:.3g}), |var diff| "
              f"{dv:.3g} (4 SE {4 * se_v:.3g})")
    # timed at LambdaPriors' psi draw, the largest per sweep
    m = C * nf * ns
    a_psi = torch.full((C, nf, ns, 1), 2.0, device=dev)

    def kern():
        trand.standard_gamma(a_psi, rng)

    def plain():
        trand._standard_gamma_plain(a_psi, rng)

    ms = device_ms(torch, kern, "standard_gamma_kernel")
    plain_ms = device_ms(torch, plain, calls=10)
    lib_ms = device_ms(torch, lambda: torch._standard_gamma(a_psi))
    ev, plain_ev = event_ms(torch, kern), event_ms(torch, plain, batch=5)
    held = held_event_ms(torch, kern)
    # bytes: shape in, draw out; operations: ~180 per element for the one
    # Marsaglia-Tsang round a shape of 2 needs in ~98% of draws (a Philox
    # call, Box-Muller, the cube and two logs)
    b, by = bound_ms(8.0 * m, 180.0 * m)
    print(f"B3 standard_gamma device time: {ms:.5f} ms (plain "
          f"{plain_ms:.4f} ms, torch._standard_gamma {lib_ms:.5f} ms, bound "
          f"{b:.5f} ms by {by}; held stream {held:.5f} ms, with enqueue "
          f"{ev:.4f} ms, plain {plain_ev:.4f} ms) at {m} shapes [{card}]")
    # config 5's launches: InvSigma's draw at (C, ns) = 4 x 90 shapes each
    # sweep, Nf's at (C, 1) in burn-in
    small = {}
    for shape in ((C, CONFIG5["ns"]), (C, 1)):
        a5 = torch.full(shape, 46.0, device=dev)
        t5 = device_ms(torch, lambda: trand.standard_gamma(a5, rng),
                       "standard_gamma_kernel")
        ev5 = event_ms(torch, lambda: trand.standard_gamma(a5, rng))
        m5 = a5.numel()
        b5, _ = bound_ms(8.0 * m5, 180.0 * m5)
        small[f"{shape[0]}x{shape[1]}"] = dict(ms=t5, event_ms=ev5,
                                               bound_ms=b5)
        print(f"B3 standard_gamma device time at config 5's {shape} "
              f"shapes: {t5:.5f} ms (bound {b5:.7f} ms; with enqueue "
              f"{ev5:.4f} ms) [{card}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms, event_ms=ev,
                plain_event_ms=plain_ev, held_ms=held, config5=small)


class FixedPhilox:
    """An ``Rng`` stand-in that gives every launch one (seed, offset), so
    that two kernels can be fed the same Philox counters."""

    def __init__(self, seed, offset):
        self.seed, self.offset = seed, offset

    def philox(self):
        return self.seed, self.offset


# the shrinkage form's shapes (nf, ns): the headline's, config 5's, config
# 3's, and one with many factors and species (several pieces a lane)
B3S_SHAPES = ((HEADLINE["nf"], HEADLINE["ns"]), (CONFIG5["nf"], 90),
              (CONFIG3_NF, CONFIG3_NS), (20, 5000))
# the priors' defaults (set_priors_random_level): nu, a1, b1, a2, b2
B3S_PRIORS = (3.0, 50.0, 1.0, 50.0, 1.0)


def shrinkage_inputs(torch, dev, C, nf, ns, seed):
    """A level's loadings, mask (a chain with all factors active, one with
    none past the first two, one with three inactive slots at the end) and
    Delta, and the priors, on the card."""
    g = np.random.default_rng(seed)
    mask = np.ones((C, nf), np.float32)
    mask[1 % C, 2:] = 0.0
    mask[2 % C, max(1, nf - 3):] = 0.0
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    Lam = t(g.standard_normal((C, nf, ns, 1)) * 0.5)
    Delta = t(g.uniform(0.5, 3.0, (C, nf, 1)))
    return Lam, t(mask), Delta, [t([v]) for v in B3S_PRIORS]


def _delta_units(torch, trand, Lam, mask, Delta, prior, Psi, Dout):
    """Delta's unit gamma draws and their shapes, recovered in float64 from
    an update's inputs and outputs (the chain replayed with the drawn
    deltas): (draws, shapes) at the active slots."""
    nu, a1, b1, a2, b2 = (p.double() for p in prior)
    m = mask.double()
    lam2 = (Lam.double() * m[:, :, None, None]) ** 2
    msum = (Psi.double() * lam2).sum(dim=2)
    dl = torch.where(m[:, :, None] > 0, Delta.double(), 1.0)
    out = Dout.double()
    _, ad = trand.shrinkage_shapes(mask, *prior[:2], prior[3], Lam.shape[2])
    gd = torch.zeros_like(out)
    for h in range(Lam.shape[1]):
        tau = torch.cumprod(dl, dim=1)
        tail = (tau[:, h:] * msum[:, h:] * m[:, h:, None]).sum(dim=1)
        bd = (b1 if h == 0 else b2) + 0.5 * tail / dl[:, h]
        gd[:, h] = out[:, h] * bd
        dl = dl.clone()
        dl[:, h] = out[:, h]
    act = mask[:, :, None].expand_as(out) > 0
    return gd[act], ad.double()[act]


@contextlib.contextmanager
def shrinkage_cluster(trand, S):
    """B3's shrinkage form launched with clusters of at most ``S`` blocks:
    the wrapper's launch shape (``shrinkage_launch``) overridden, as
    ``scripts/shrinkage_sweep.py`` overrides it."""
    base = trand.shrinkage_launch
    trand.shrinkage_launch = (
        lambda dev, nf, ns, ncr: trand.shrinkage_geometry(nf, ns, ncr, S))
    try:
        yield
    finally:
        trand.shrinkage_launch = base


def check_b3_shrinkage(torch, trand, dev, card):
    """B3's shrinkage form (a level's whole update in one launch) against
    the plain update (``shrinkage_update``) fed with the element form's own
    draws at the same (seed, offsets), Psi and Delta to 1e-5 relative, at
    ``B3S_SHAPES`` with inactive slots; a rerun to the same bits; the law of
    its draws by KS and moments against the plain version's (psi's unit
    draws, and delta's recovered from its outputs, as probabilities of
    their gamma laws); timed beside the plain version and the block as the
    sampler ran it before (the element form's psi draw, then a delta draw
    and the update's tensor ops a factor)."""
    from scipy import special, stats

    C = HEADLINE["n_chains"]
    worst = 0.0
    for nf, ns in B3S_SHAPES:
        Lam, mask, Delta, prior = shrinkage_inputs(torch, dev, C, nf, ns,
                                                   seed=nf * ns)
        seed, off = 0x5EED + ns, 1000 + nf
        Pk, Dk = trand.shrinkage_gamma(Lam, mask, Delta, *prior,
                                       FixedPhilox(seed, off))
        # at most 8 blocks a cluster (the portable size): the same bits
        with shrinkage_cluster(trand, 8):
            P8, D8 = trand.shrinkage_gamma(Lam, mask, Delta, *prior,
                                           FixedPhilox(seed, off))
        assert torch_equal_bits(Pk, P8) and torch_equal_bits(Dk, D8), \
            f"B3 shrinkage nf {nf} ns {ns}: 8-block clusters differ"
        a_psi, ad = trand.shrinkage_shapes(mask, *prior[:2], prior[3], ns)
        g_psi = trand.standard_gamma(a_psi.expand(Lam.shape).contiguous(),
                                     FixedPhilox(seed, off))
        g_d = trand.standard_gamma(ad.contiguous(), FixedPhilox(
            seed, trand.delta_offset(off)))
        Pp, Dp = trand.shrinkage_update(Lam, mask, Delta, prior[0],
                                        prior[2], prior[4], g_psi,
                                        lambda h: g_d[:, h])
        rel = max(((Pk - Pp).abs() / Pp.abs()).max().item(),
                  ((Dk - Dp).abs() / Dp.abs()).max().item())
        assert rel <= 1e-5, f"B3 shrinkage nf {nf} ns {ns}: rel {rel}"
        assert torch.isfinite(Pk).all() and torch.isfinite(Dk).all()
        assert (Dk[mask == 0] == 1).all(), "B3 shrinkage: inactive delta"
        P2, D2 = trand.shrinkage_gamma(Lam, mask, Delta, *prior,
                                       FixedPhilox(seed, off))
        assert torch.equal(Pk, P2) and torch.equal(Dk, D2), \
            f"B3 shrinkage nf {nf} ns {ns}: a rerun gave other bits"
        worst = max(worst, float((Pk - Pp).abs().max()),
                    float((Dk - Dp).abs().max()))
        geo = trand.shrinkage_launch(dev, nf, ns, 1)
        g8 = trand.shrinkage_geometry(nf, ns, 1, 8)
        print(f"B3 shrinkage check C {C}, nf {nf}, ns {ns} (clusters of "
              f"{geo['S']} x {geo['T']} threads, the size the occupancy "
              f"query allows, {geo['P']} pieces a row): max relative "
              f"|kernel - plain| on Psi and Delta {rel:.3g} (1e-5) from the "
              f"element form's draws at the same counters; a rerun gives "
              f"the same bits, and so do clusters of {g8['S']} x "
              f"{g8['T']} threads")
    # the law: psi's unit draws (Psi b_psi) and delta's (recovered), as
    # their gamma CDFs, kernel against the plain version over many launches
    nf, ns = HEADLINE["nf"], HEADLINE["ns"]
    Lam, mask, Delta, prior = shrinkage_inputs(torch, dev, C, nf, ns, seed=5)
    a_psi, _ = trand.shrinkage_shapes(mask, *prior[:2], prior[3], ns)
    tau = torch.cumprod(torch.where(mask[:, :, None] > 0, Delta, 1.0), dim=1)
    b_psi = prior[0] / 2 + 0.5 * (Lam * mask[:, :, None, None]) ** 2 * \
        tau[:, :, None, :]
    laws = {}
    for name, fn in (("kernel", trand.shrinkage_gamma),
                     ("plain", trand._shrinkage_gamma_plain)):
        rng = trand.Rng(41, dev)
        ups, uds = [], []
        for rep in range(300):
            Ps, Ds = fn(Lam, mask, Delta, *prior, rng)
            if rep < 10:
                ups.append((Ps * b_psi).double().flatten())
            gd, shp = _delta_units(torch, trand, Lam, mask, Delta, prior, Ps,
                                   Ds)
            uds.append(special.gammainc(shp.cpu().numpy(),
                                        gd.cpu().numpy()))
        up = special.gammainc(float(a_psi[0]),
                              torch.cat(ups).cpu().numpy())
        laws[name] = (up, np.concatenate(uds))
    for i, what in enumerate(("psi", "delta")):
        a, b = laws["kernel"][i], laws["plain"][i]
        p = stats.ks_2samp(a, b).pvalue
        assert p > 1e-3, f"B3 shrinkage {what}: KS p {p} <= 1e-3"
        msg = _moments_agree(f"B3 shrinkage {what}", torch.tensor(a),
                             torch.tensor(b))
        print(f"B3 shrinkage law of {what}'s unit draws (their gamma CDF, "
              f"{len(a)} draws): KS p {p:.3g} (> 1e-3) against the plain "
              f"version, {msg}")

    rng = trand.Rng(43, dev)

    def kern():
        trand.shrinkage_gamma(Lam, mask, Delta, *prior, rng)

    def plain():
        trand._shrinkage_gamma_plain(Lam, mask, Delta, *prior, rng)

    def before():
        g = trand.standard_gamma(a_psi.expand(Lam.shape).contiguous(), rng)
        _, ad = trand.shrinkage_shapes(mask, *prior[:2], prior[3], ns)
        trand.shrinkage_update(Lam, mask, Delta, prior[0], prior[2],
                               prior[4], g, lambda h: trand.standard_gamma(
                                   ad[:, h].contiguous(), rng))

    ms = device_ms(torch, kern, "shrinkage_gamma_kernel")
    with shrinkage_cluster(trand, 8):
        ms8 = device_ms(torch, kern, "shrinkage_gamma_kernel")
    geo = trand.shrinkage_launch(dev, nf, ns, 1)
    plain_ms = device_ms(torch, plain, calls=10)
    before_ms = device_ms(torch, before, calls=20)
    ev, plain_ev = event_ms(torch, kern), event_ms(torch, plain, batch=5)
    before_ev = event_ms(torch, before, batch=5)
    held = held_event_ms(torch, kern)
    # bytes: Lambda in, Psi out (and the small mask, Delta, priors);
    # operations: ~180 a unit gamma draw (a Philox call, Box-Muller, the
    # cube and two logs, one round at these shapes) for psi's and delta's
    m = C * nf * ns
    b, by = bound_ms(8.0 * m + 4.0 * (2 * C * nf + C * nf + 5),
                     180.0 * (m + C * nf))
    print(f"B3 shrinkage_gamma device time at C {C}, nf {nf}, ns {ns}: "
          f"{ms:.5f} ms with the queried clusters of {geo['S']} blocks "
          f"({ms8:.5f} ms at 8; the block as the sampler ran it before: "
          f"{before_ms:.5f} ms of device work, with enqueue {before_ev:.4f} "
          f"ms; plain {plain_ms:.4f} ms, bound {b:.6f} ms by {by}; held "
          f"stream {held:.5f} ms, with enqueue {ev:.4f} ms, plain "
          f"{plain_ev:.4f} ms)) [{card}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, event_ms=ev,
                plain_event_ms=plain_ev, held_ms=held,
                before_ms=before_ms, before_event_ms=before_ev,
                cluster=geo["S"], ms_cluster8=ms8)


# B4's shapes (nc, nt, ns): the headline's, a model with traits, and the
# kernel's cap (nc 16, nc nt 64) at 5000 species
B4_SHAPES = ((2, 1, HEADLINE["ns"]), (8, 4, 1000), (16, 4, 5000))


def b4_inputs(torch, trand, dev, C, nc, nt, ns, seed):
    """The GammaV block's inputs on the card (Tr with an intercept column,
    a random prior on Gamma, V0 = I, df = f0 + ns with f0 = nc + 1) and
    injected draws of the plain update's shapes: (args, df, noise)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    n = nc * nt
    Tr = rn(ns, nt)
    Tr[:, 0] = 1.0
    U = rn(n, n)
    iUG = U @ U.T / n + torch.eye(n, device=dev)
    mG = 0.3 * rn(n)
    Gamma = 0.3 * rn(C, nc, nt)
    Beta = Gamma @ Tr.T + 0.7 * rn(C, nc, ns)
    args = dict(Beta=Beta, Gamma=Gamma, Tr=Tr,
                V0=torch.eye(nc, device=dev), TtT=Tr.T @ Tr, iUGamma=iUG,
                iUGmG=iUG @ mG)
    df = float(nc + 1 + ns)
    dfs = (df - torch.arange(nc, device=dev, dtype=torch.float32)) / 2.0
    noise = {"wishart": {"normal": rn(C, nc, nc),
                         "gamma": trand.standard_gamma(
                             dfs.expand(C, nc).contiguous(),
                             trand.Rng(seed, dev))},
             "gamma": {"eps": rn(C, n)}}
    return args, df, noise


def b4_law(torch, trand, dev, nc, nt, ns, n=4096):
    """The law of B4's in-kernel draws at one shape, n copies of one chain:
    the mean of iV against df (A + V0 + jitter)^-1 (A = E E' in float64),
    then, with the Wishart draws injected (one iV for every copy), Gamma's
    mean and covariance against the float64 conditional.  Returns the
    largest |z| of each."""
    args, df, noise = b4_inputs(torch, trand, dev, 1, nc, nt, ns, seed=nc)
    rep = dict(args, Beta=args["Beta"].expand(n, nc, ns).contiguous(),
               Gamma=args["Gamma"].expand(n, nc, nt).contiguous())
    iV, _ = trand.gamma_v(**rep, df=df, rng=trand.Rng(90 + nc, dev))
    d64 = {k: v.double() for k, v in args.items()}
    E = d64["Beta"][0] - d64["Gamma"][0] @ d64["Tr"].T
    M = E @ E.T + d64["V0"]
    M = M + 1e-6 * torch.diagonal(M).mean() * torch.eye(
        nc, device=dev, dtype=torch.float64)
    want = df * torch.linalg.inv(M)
    x = iV.double()
    z_iv = ((x.mean(0) - want).abs() / (x.std(0) / n ** 0.5)).max().item()
    nz = {"wishart": {k: v.expand((n,) + v.shape[1:]).contiguous()
                      for k, v in noise["wishart"].items()}}
    iV2, Gm = trand.gamma_v(**rep, df=df, rng=trand.Rng(95 + nc, dev),
                            noise=nz)
    assert torch.equal(iV2, iV2[:1].expand_as(iV2)), "B4: injected iV"
    iv = iV2[0].double()
    N = nc * nt
    prec = d64["iUGamma"] + torch.kron(d64["TtT"], iv)
    prec = prec + 1e-6 * torch.diagonal(prec).mean() * torch.eye(
        N, device=dev, dtype=torch.float64)
    BT = d64["Beta"][0] @ d64["Tr"]
    rhs = d64["iUGmG"] + (iv @ BT).T.reshape(-1)
    cov = torch.linalg.inv(prec)
    mean = cov @ rhs
    g = Gm.double().transpose(1, 2).reshape(n, N)      # vec, trait-major
    se = (torch.diagonal(cov) / n).sqrt()
    z_m = ((g.mean(0) - mean).abs() / se).max().item()
    gc = g - g.mean(0)
    S = gc.T @ gc / (n - 1)
    dg = torch.diagonal(cov)
    z_c = ((S - cov).abs()
           / ((dg[:, None] * dg[None, :] + cov ** 2) / n).sqrt()).max().item()
    assert z_iv < 4.5, f"B4 nc {nc}: iV mean z {z_iv}"
    assert z_m < 4.5 and z_c < 5.0, f"B4 nc {nc}: Gamma z {z_m}, {z_c}"
    return z_iv, z_m, z_c


def check_b4(torch, trand, dev, card):
    """B4, the whole GammaV block in one launch (``ops/rand.py ·
    gamma_v``), against the plain block (``gamma_v_plain``: the torch ops
    and B3's element form) with the same injected draws at ``B4_SHAPES``:
    iV and Gamma to 1e-4 relative (max |kernel - plain| / max |plain|); a
    NaN in Beta gives NaN in its chain, the other chains unchanged, no
    exception; reruns (injected draws, and Philox at a fixed (seed,
    offset)) to the same bits; the law of its in-kernel draws
    (``b4_law``).  Timed at each shape beside the plain block with its own
    draws (the block as the sampler ran it before) and, at the headline,
    torch.distributions.Wishart's draw of iV alone."""
    C = HEADLINE["n_chains"]
    res = {}
    for nc, nt, ns in B4_SHAPES:
        assert trand.gamma_v_route(nc, nt)
        args, df, noise = b4_inputs(torch, trand, dev, C, nc, nt, ns,
                                    seed=nc * nt)
        iVk, Gk = trand.gamma_v(**args, df=df, noise=noise)
        iVp, Gp = trand.gamma_v_plain(**args, df=df, noise=noise)
        rel = max(_rel(iVk, iVp), _rel(Gk, Gp))
        assert rel <= 1e-4, f"B4 nc {nc} nt {nt}: max rel diff {rel}"
        assert torch.isfinite(iVk).all() and torch.isfinite(Gk).all()
        assert torch.equal(iVk, iVk.transpose(1, 2)), "B4: iV not symmetric"
        again = trand.gamma_v(**args, df=df, noise=noise)
        assert torch.equal(again[0], iVk) and torch.equal(again[1], Gk), \
            f"B4 nc {nc}: a rerun gave other bits"
        fixed = [trand.gamma_v(**args, df=df, rng=FixedPhilox(0x5EED, nc))
                 for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*fixed)), \
            f"B4 nc {nc}: a Philox rerun gave other bits"
        bad = dict(args, Beta=args["Beta"].clone())
        bad["Beta"][0, nc - 1, ns // 2] = float("nan")
        iVn, Gn = trand.gamma_v(**bad, df=df, noise=noise)
        assert torch.isnan(iVn[0]).all() and torch.isnan(Gn[0]).all(), \
            f"B4 nc {nc}: a NaN in Beta did not give NaN"
        assert torch.equal(iVn[1:], iVk[1:]) and torch.equal(Gn[1:], Gk[1:])
        print(f"B4 check C {C}, nc {nc}, nt {nt}, ns {ns}: max relative "
              f"|kernel - plain| on iV and Gamma {rel:.3g} (1e-4) with the "
              f"same draws; iV symmetric; reruns give the same bits; a NaN "
              f"in Beta gives NaN in its chain and leaves the others")
        rng = trand.Rng(31, dev)

        def kern():
            trand.gamma_v(**args, df=df, rng=rng)

        def before():
            trand.gamma_v_plain(**args, df=df, rng=rng)

        ms = device_ms(torch, kern, "gamma_v_kernel")
        before_ms = device_ms(torch, before, calls=20)
        ev, before_ev = event_ms(torch, kern), event_ms(torch, before)
        held = held_event_ms(torch, kern)
        lib_ms = None
        if (nc, nt, ns) == B4_SHAPES[0]:
            E = args["Beta"] - args["Gamma"] @ args["Tr"].T
            S = torch.linalg.inv(E @ E.transpose(1, 2) + args["V0"])
            W = torch.distributions.Wishart(
                torch.full((C,), df, device=dev),
                scale_tril=torch.linalg.cholesky(S), validate_args=False)
            with warnings.catch_warnings():      # its resampling warning
                warnings.simplefilter("ignore")
                lib_ms = device_ms(torch, W.sample)
        # bytes: Beta, Tr, Gamma, V0, Tr'Tr, iUGamma, iUGamma mGamma in, iV
        # and Gamma out; operations a chain: the species sums (E, E E' and
        # Beta Tr, 2 nc nt + nc (nc + 1) + 2 nc nt a species), the two
        # factorisations and solves, the Bartlett product, the precision,
        # and ~180 a unit gamma and ~130 a normal drawn
        n = nc * nt
        nbytes = 4.0 * (C * nc * ns + ns * nt + 2 * C * nc * nt + nc * nc
                        + nt * nt + n * n + n + C * nc * nc)
        ops = C * (ns * (4 * nc * nt + nc * (nc + 1)) + nc ** 3 + 4 * nc ** 3
                   + 2 * n * n + n ** 3 / 3 + 4 * n * n + 180 * nc
                   + 130 * (nc * (nc - 1) / 2 + n))
        b, by = bound_ms(nbytes, ops)
        lib = "" if lib_ms is None else \
            f"; torch.distributions.Wishart's iV draw alone {lib_ms:.5f} ms"
        print(f"B4 gamma_v device time at C {C}, nc {nc}, nt {nt}, ns {ns}: "
              f"{ms:.5f} ms (the block as the sampler ran it before: "
              f"{before_ms:.5f} ms of device work, with enqueue "
              f"{before_ev:.4f} ms{lib}; bound {b:.6f} ms by {by}; held "
              f"stream {held:.5f} ms, with enqueue {ev:.4f} ms) [{card}]")
        res[nc, nt, ns] = dict(
            max_abs_err=max(float((iVk - iVp).abs().max()),
                            float((Gk - Gp).abs().max())), rel_err=rel,
            ms=ms, plain_ms=before_ms, bound_ms=b, bound_by=by,
            library_ms=lib_ms, event_ms=ev, plain_event_ms=before_ev,
            held_ms=held, shape=[C, nc, nt, ns])
    for nc, nt, ns in B4_SHAPES[:2]:
        z_iv, z_m, z_c = b4_law(torch, trand, dev, nc, nt, ns)
        print(f"B4 law of the in-kernel draws at nc {nc}, nt {nt}, ns {ns} "
              f"(4096 copies of one chain): max |z| of iV's mean against df "
              f"(A + V0)^-1 {z_iv:.3g} (< 4.5); with the Wishart draws "
              f"injected, of Gamma's mean {z_m:.3g} (< 4.5) and covariance "
              f"{z_c:.3g} (< 5) against the float64 conditional")
    out = dict(res[B4_SHAPES[0]])
    out["by_shape"] = {f"nc {k[0]} nt {k[1]} ns {k[2]}": {f: r[f] for f in (
        "ms", "event_ms", "plain_ms", "plain_event_ms", "bound_ms",
        "rel_err")} for k, r in res.items()}
    return out


def _moments_agree(label, a, b):
    """Mean and variance of two samples of one distribution within 4 SE."""
    a, b = a.double(), b.double()
    n = a.numel()
    se_m = math.sqrt((a.var() + b.var()).item() / n)
    dm = abs((a.mean() - b.mean()).item())
    va, vb = a.var().item(), b.var().item()
    se_v = math.sqrt((((a - a.mean()) ** 4).mean().item() - va * va
                      + ((b - b.mean()) ** 4).mean().item() - vb * vb) / n)
    assert dm < 4 * se_m, f"{label}: mean {dm} > 4 SE {4 * se_m}"
    assert abs(va - vb) < 4 * se_v, f"{label}: variance"
    return (f"|mean diff| {dm:.3g} (4 SE {4 * se_m:.3g}), |var diff| "
            f"{abs(va - vb):.3g} (4 SE {4 * se_v:.3g})")


def poisson_inputs(torch, dev, C, ny, ns, seed):
    """Counts 0 to ~1e3 and previous Z in every branch of the PG moments:
    |Z - log r| / 2 at 0, below 1e-3 (the mean's series), just past it (the
    variance's series) and far out; every seventh column probit."""
    g = torch.Generator(device=dev).manual_seed(seed)
    logr = math.log(1000.0)
    Y = torch.poisson(torch.exp(torch.rand((ny, ns), generator=g,
                                           device=dev) * 7.0 - 2.0),
                      generator=g)
    Y[0], Y[1] = 0.0, 1000.0
    Zprev = torch.log(Y + 0.5) + 0.5 * torch.randn((C, ny, ns), generator=g,
                                                   device=dev)
    Zprev[:, 1] = logr
    Zprev[:, 2] = logr + (torch.rand((C, ns), generator=g, device=dev)
                          - 0.5) * 3.8e-3
    Zprev[:, 3] = logr + 2.5e-3
    Zprev[:, 4] = logr - 30.0
    E = Zprev + 0.3 * torch.randn((C, ny, ns), generator=g, device=dev)
    iSigma = torch.rand((C, ns), generator=g, device=dev) * 99.5 + 0.5
    fam = torch.full((ns,), 3, dtype=torch.int32, device=dev)
    fam[::7] = 2
    eps = torch.randn((2, C, ny, ns), generator=g, device=dev)
    return Y, Zprev, E, iSigma, fam, eps[0], eps[1]


def first_b5(torch, lib, Y, Zprev, E, iSigma, fam, seed, offset):
    """B5's first version on the card (``scripts/older/poisson_z.cu``, one
    thread a cell), its normals from Philox: Z (C, ny, ns)."""
    import ctypes

    C, ny, ns = Zprev.shape
    fn = lib.hmsc_poisson_z
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_void_p]
    Z = torch.empty_like(Zprev)
    code = fn(Y.data_ptr(), Zprev.data_ptr(), E.data_ptr(), iSigma.data_ptr(),
              fam.data_ptr(), None, None, Z.data_ptr(), C, ny, ns, seed,
              offset, torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"B5 first version: cudaError {code}"
    return Z


def config5_families(torch, dev, ns=None):
    """Config 5's column families: a third each normal, probit and
    lognormal-Poisson, in that order."""
    ns = CONFIG5["ns"] if ns is None else ns
    fam = torch.full((ns,), 1, dtype=torch.int32, device=dev)
    fam[ns // 3:2 * ns // 3], fam[2 * ns // 3:] = 2, 3
    return fam


def mixed_inputs(torch, dev, C, ny, ns, seed, na=0.0):
    """B5's mixed form's inputs: poisson_inputs with config 5's families
    (normal columns' Y continuous, probit's 0 / 1), iSigma 1 on probit
    columns, a mask with ``na`` of the cells missing (None at 0), and the
    four injected draws."""
    Y, Zprev, E, iSigma, _, e1, e2 = poisson_inputs(torch, dev, C, ny, ns,
                                                    seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    fam = config5_families(torch, dev, ns)
    Y = torch.where(fam == 1, torch.randn((ny, ns), generator=g,
                                          device=dev), Y)
    Y = torch.where(fam == 2, (Y > 5).float(), Y)
    iSigma = torch.where(fam == 2, 1.0, iSigma)
    mask = None
    if na:
        mask = (torch.rand((ny, ns), generator=g, device=dev) >= na).float()
    u = torch.rand((C, ny, ns), generator=g, device=dev).clamp_min(1e-38)
    en = torch.randn((C, ny, ns), generator=g, device=dev)
    return (Y, Zprev, E, iSigma, fam, mask), dict(u=u, eps_pg=e1, eps_z=e2,
                                                  eps_na=en)


def _z_block_before(torch, trand, first, Y, Zprev, E, iSigma, fam, mask,
                    rng):
    """The Z block of a model with Poisson columns as the sampler ran it
    before the mixed form: the torch ops selecting and imputing, B1's
    E-reading form and B5's first version."""
    Z = torch.where(fam == 1, Y, Zprev)
    std = iSigma ** -0.5
    z_tn = trand.truncated_normal_onesided(E, std, Y, rng)
    Z = torch.where(fam == 2, z_tn, Z)
    z_p = first_b5(torch, first, Y, Zprev, E, iSigma, fam, *rng.philox())
    Z = torch.where(fam == 3, z_p, Z)
    if mask is not None:
        eps = rng.normal(E.shape)
        Z = torch.where(mask > 0, Z, E + std[:, None, :] * eps)
    return Z


def torch_equal_bits(a, b):
    """Whether two float32 tensors hold the same bits."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _probit_slack(torch, E, sd, Y, u):
    """Per cell, in sd units: 8 float32 ulps of the survival probability s
    = u P(W > t) of the one-sided truncated normal's inverse-CDF branch
    times the quantile's slope 1 / phi(ndtri(s)) (float64 on the host; 0
    on the far-tail branch), as ``_b7_quantile_slack`` for B7."""
    from scipy.special import ndtr, ndtri

    dev = u.device
    E, sd, Y, u = (x.double().cpu().numpy() for x in (E, sd, Y, u))
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        t = -E / sd
        t = np.where(Y > 0.5, t, -t)
        s = np.clip(u * ndtr(-t), 1e-30, 1 - 2.0 ** -24)
        x = ndtri(s)
        slack = 8 * 2.0 ** -23 * s * np.sqrt(2 * np.pi) * np.exp(x * x / 2)
    slack = np.where(t > 9.0, 0.0, np.nan_to_num(slack, posinf=1e30))
    return torch.tensor(np.minimum(slack, PROBIT_SLACK_CAP),
                        dtype=torch.float32, device=dev)


# the most ``_probit_slack`` adds to a probit cell's 1e-4 sd, in sd units
PROBIT_SLACK_CAP = 1e-3


def _probit_f64(torch, E, sd, Y, u):
    """The one-sided truncated normal draw of the plain version on the
    same float32 inputs, evaluated in float64 on the host (its clip of s
    to [1e-30, 1 - 2^-24] and its far tail included)."""
    from scipy.special import ndtr, ndtri

    E, sd, Y, u = (x.double().cpu().numpy() for x in (E, sd, Y, u))
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        t = -E / sd
        t = np.where(Y > 0.5, t, -t)
        x = -ndtri(np.clip(u * ndtr(-t), 1e-30, 1 - 2.0 ** -24))
        x_far = t - np.log1p(-u) / np.maximum(t, 1.0)
        x = np.maximum(np.where(t > 9.0, x_far, x), t)
        return E + sd * np.where(Y > 0.5, x, -x)


def _probit_gate(torch, label, zk, zp, E, sd, Y, u, cells):
    """Probit cells of a kernel's draw ``zk`` against the plain version's
    ``zp`` (all (C, ny, ns); ``cells`` a bool mask that broadcasts to
    them): |kernel - plain| / sd within 1e-4 plus ``_probit_slack`` (8
    float32 ulps of s through the quantile's slope, at most
    ``PROBIT_SLACK_CAP``), and the kernel within the same of the float64
    draw.  Returns a line that counts the cells past 1e-4 sd and says how
    far kernel and plain lie from the float64 draw there."""
    cells = cells.expand_as(zk)
    tol = 1e-4 + _probit_slack(torch, E, sd, Y, u)
    d = (zk - zp).abs() / sd
    z64 = _probit_f64(torch, E, sd, Y, u)
    sd64 = sd.double().cpu().numpy()
    dk64 = np.abs(zk.double().cpu().numpy() - z64) / sd64
    dp64 = np.abs(zp.double().cpu().numpy() - z64) / sd64
    m = cells.cpu().numpy()
    used = (d / tol)[cells].max().item()
    used64 = (dk64 / tol.double().cpu().numpy())[m].max()
    assert used <= 1.0 and used64 <= 1.0, \
        f"{label}: probit cells at {used:.3g} of their tolerance against " \
        f"the plain version, {used64:.3g} against the float64 draw"
    past = (d > 1e-4) & cells
    n_past = int(past.sum())
    pm = past.cpu().numpy()
    far = (f"; there kernel and plain lie {dk64[pm].max():.3g} and "
           f"{dp64[pm].max():.3g} sd from the float64 draw"
           if n_past else "")
    return (f"probit cells at {used:.3g} of their tolerance (1e-4 sd plus "
            f"8 ulps of s, capped at {PROBIT_SLACK_CAP:g} sd), "
            f"{used64:.3g} against the float64 draw; {n_past} of "
            f"{int(cells.sum())} cells past 1e-4 sd of the plain version "
            f"(max {d[cells].max().item():.3g} sd){far}")


def _column_law(label, torch, kern, plain, keep, reps):
    """The law of a form's in-kernel draws: per column, the mean and
    variance of Z over ``reps`` calls and the column's cells where
    ``keep`` (C, ny, ns), kernel against the plain version's, within 4
    standard errors (``_moments_agree``).  Returns the columns checked."""
    ks = torch.stack([kern() for _ in range(reps)])
    ps = torch.stack([plain() for _ in range(reps)])
    done = 0
    for j in range(ks.shape[-1]):
        m = keep[..., j].expand(reps, *keep.shape[:2])
        a, b = ks[..., j][m], ps[..., j][m]
        if a.numel() == 0 or float(b.var()) == 0.0:
            continue
        _moments_agree(f"{label} column {j}", a, b)
        done += 1
    return done


def check_b5(torch, trand, dev, card):
    """B5, one kernel (the whole Z update), through both wrappers:
    ``poisson_z`` (the Poisson columns alone, the others kept) and
    ``z_mixed`` (every column, with missing cells), against their plain
    versions with injected draws (1e-4 relative to max(|plain|, 1);
    probit cells by ``_probit_gate``), the NaN guard (a cell whose draw is
    not finite keeps Zprev), bit-identical reruns from one Philox key, the
    law of the in-kernel draws (each column's mean and variance against
    the plain version's over 300 calls, 4 SE); timed at 4 x 1000 x 1000,
    every column Poisson, beside B5's first version
    (``scripts/older/poisson_z.cu``), and at config 5's shape beside the Z
    block as the sampler ran it before."""
    C, ny, ns = HEADLINE["n_chains"], HEADLINE["ny"], HEADLINE["ns"]
    n5, s5 = CONFIG5["ny"], CONFIG5["ns"]
    first = build_source("scripts/older/poisson_z.cu", "poisson_z_first")
    worst = 0.0
    for shape in ((C, n5, s5), (C, ny, ns), (C, 37, 30)):
        Y, Zprev, E, iSigma, fam, e1, e2 = poisson_inputs(torch, dev, *shape,
                                                          seed=5)
        E = E.clone()
        E[:, 6, ::3] = float("inf")            # draws that are not finite
        zk = trand.poisson_z(Y, Zprev, E, iSigma, fam, eps_pg=e1, eps_z=e2)
        zp = trand._poisson_z_plain(Y, Zprev, E, iSigma, fam, e1, e2)
        assert torch.isfinite(zk).all(), "B5: non-finite draws"
        assert torch.equal(zk[..., fam != 3], Zprev[..., fam != 3]), \
            "B5: a non-Poisson column changed"
        assert torch.equal(zk[:, 6, ::3], Zprev[:, 6, ::3]), "B5: NaN guard"
        err = ((zk - zp).abs() / zp.abs().clamp_min(1.0)).max().item()
        assert err <= 1e-4, f"B5 injected normals: rel diff {err} > 1e-4"
        worst = max(worst, (zk - zp).abs().max().item())
        key = FixedPhilox(0x5EED + shape[1], 77)
        r1 = trand.poisson_z(Y, Zprev, E, iSigma, fam, key)
        r2 = trand.poisson_z(Y, Zprev, E, iSigma, fam, key)
        assert torch_equal_bits(r1, r2), "B5: a rerun gave other bits"
        print(f"B5 check: injected normals at {shape}, max |kernel - plain| "
              f"/ max(|plain|, 1) = {err:.3g} (tolerance 1e-4); non-finite "
              f"draws keep Zprev; a rerun gives the same bits")
    # the mixed form: config 5's families, with and without missing cells
    for shape, na in (((C, n5, s5), 0.0), ((C, n5, s5), 0.1),
                      ((C, ny, ns), 0.1), ((C, 37, 30), 0.1)):
        args, nz = mixed_inputs(torch, dev, *shape, seed=9, na=na)
        Y, Zprev, E, iSigma, fam, mask = args
        obs = (mask > 0 if mask is not None else torch.ones_like(Y) > 0)
        guard = ((fam == 3) & obs[6]
                 & (torch.arange(shape[2], device=dev) % 3 == 0))
        E = E.clone()                         # Poisson draws not finite
        E[:, 6, guard] = float("inf")
        args = (Y, Zprev, E, iSigma, fam, mask)
        zk = trand.z_mixed(*args, **nz)
        zp = trand._z_mixed_plain(*args, **nz)
        assert guard.any() and torch.equal(zk[:, 6][:, guard],
                                           Zprev[:, 6][:, guard]), \
            "B5 mixed: NaN guard"
        assert torch.isfinite(zk).all(), "B5 mixed: non-finite draws"
        # probit cells: B1's draw (bit for bit B1's E-reading kernel on the
        # same uniforms), held as check_b1 holds it on these cells
        # (``_probit_gate``: near s -> 1 kernel and plain round s apart);
        # every other cell to 1e-4 of max(|plain|, 1)
        sd = (iSigma ** -0.5)[:, None, :].expand_as(zk)
        prob = (fam == 2) & obs
        zb = trand.truncated_normal_onesided(E, iSigma ** -0.5, Y,
                                             u=nz["u"])
        assert torch_equal_bits(zk[:, prob], zb[:, prob]), \
            "B5 mixed: probit cells differ from B1's E-reading form"
        probit_line = _probit_gate(torch, f"B5 mixed {shape} na {na}", zk,
                                   zp, E, sd, Y, nz["u"], prob)
        other = ~prob.expand_as(zk)
        err = ((zk - zp).abs() / zp.abs().clamp_min(1.0))[other].max().item()
        assert err <= 1e-4, f"B5 mixed {shape} na {na}: rel diff {err}"
        worst = max(worst, (zk - zp).abs()[other].max().item())
        key = FixedPhilox(0x5EED + shape[1], 78)
        r1 = trand.z_mixed(*args, key)
        r2 = trand.z_mixed(*args, key)
        assert torch_equal_bits(r1, r2), "B5 mixed: a rerun gave other bits"
        # its Poisson cells draw what poisson_z (the other columns kept)
        # draws at one key
        if mask is None:
            re = trand.poisson_z(Y, Zprev, E, iSigma, fam, key)
            assert torch_equal_bits(r1[..., fam == 3], re[..., fam == 3]), \
                "B5 mixed: Poisson cells differ from poisson_z's"
        print(f"B5 mixed form check at {shape}, {na:.0%} missing, with u, "
              f"eps_pg, eps_z, eps_na injected: max |kernel - plain| / "
              f"max(|plain|, 1) = {err:.3g} (tolerance 1e-4) on normal, "
              f"Poisson and imputed cells; probit cells bit for bit B1's, "
              f"{probit_line}; non-finite draws keep Zprev; a rerun gives "
              f"the same bits"
              + ("" if mask is not None else "; its Poisson cells equal "
                 "poisson_z's at one key"))
    # the law of the in-kernel draws, a column at a time
    Y, Zprev, E, iSigma, fam, _, _ = poisson_inputs(torch, dev, C, 64, 32,
                                                    seed=7)
    rng = trand.Rng(13, dev)
    cols = _column_law(
        "B5 law", torch, lambda: trand.poisson_z(Y, Zprev, E, iSigma, fam,
                                                 rng),
        lambda: trand._poisson_z_plain(Y, Zprev, E, iSigma, fam,
                                       rng.normal(E.shape),
                                       rng.normal(E.shape)),
        (fam == 3).expand(C, 64, 32), 300)
    args, _ = mixed_inputs(torch, dev, C, 64, 30, seed=8, na=0.1)
    Ym, Zm, Em, iSm, fm, mk = args
    cols_m = _column_law(
        "B5 mixed law", torch, lambda: trand.z_mixed(*args, rng),
        lambda: trand._z_mixed_plain(
            *args, rng.uniform(Em.shape), rng.normal(Em.shape),
            rng.normal(Em.shape), rng.normal(Em.shape)),
        torch.ones_like(Zm) > 0, 300)
    print(f"B5 law of the in-kernel draws: each column's mean and variance "
          f"over 300 calls within 4 SE of the plain version's ({cols} "
          f"Poisson columns; mixed form {cols_m} columns: probit, Poisson "
          f"and imputed cells) [{card}]")

    Y, Zprev, E, iSigma, fam, e1, e2 = poisson_inputs(torch, dev, C, ny, ns,
                                                      seed=5)
    # timed as a Poisson-only model runs it: the whole Z update, every
    # column Poisson, no missing cells
    fam3 = torch.full_like(fam, 3)

    def kern():
        trand.z_mixed(Y, Zprev, E, iSigma, fam3, None, rng)

    def plain():
        trand._z_mixed_plain(Y, Zprev, E, iSigma, fam3, None, None,
                             rng.normal(E.shape), rng.normal(E.shape), None)

    def first_v():
        first_b5(torch, first, Y, Zprev, E, iSigma, fam3, *rng.philox())

    ms = device_ms(torch, kern, "poisson_z_kernel")
    first_ms = device_ms(torch, first_v, "poisson_z_kernel")
    plain_ms = device_ms(torch, plain, calls=10)
    ev, plain_ev = event_ms(torch, kern), event_ms(torch, plain, batch=5)
    held = held_event_ms(torch, kern)
    cells = C * ny * ns
    # bytes: Zprev, E and Z per cell, Y per site x species, iSigma per chain
    # x species, fam per species; operations: ~150 per cell (a Philox call
    # a pair of cells, two Box-Muller normals, tanhf, the PG moments and the
    # Gaussian draw)
    b, by = bound_ms(4.0 * (3 * cells + ny * ns + C * ns + ns), 150.0 * cells)
    print(f"B5 device time of the whole Z update at {C}x{ny}x{ns}, every "
          f"column Poisson: {ms:.5f} ms (first version {first_ms:.5f} ms in "
          f"this call; plain {plain_ms:.4f} ms, bound {b:.4f} ms by {by}; "
          f"held stream {held:.5f} ms, with enqueue {ev:.4f} ms, plain "
          f"{plain_ev:.4f} ms) [{card}]")
    # config 5's own shape, the path B5 runs on: 300 x 90, its last 30
    # columns lognormal-Poisson; poisson_z draws those alone (the bound
    # counts their cells), the sampler's launch every column
    Y5, Z5, E5, iS5, _, _, _ = poisson_inputs(torch, dev, C, n5, s5, seed=6)
    fam5 = config5_families(torch, dev)

    def kern5():
        trand.poisson_z(Y5, Z5, E5, iS5, fam5, rng)

    def first5():
        first_b5(torch, first, Y5, Z5, E5, iS5, fam5, *rng.philox())

    def mixed5():
        trand.z_mixed(Y5, Z5, E5, iS5, fam5, None, rng)

    def before5():
        _z_block_before(torch, trand, first, Y5, Z5, E5, iS5, fam5, None,
                        rng)

    ms5 = device_ms(torch, kern5, "poisson_z_kernel")
    first5_ms = device_ms(torch, first5, "poisson_z_kernel")
    mixed_ms = device_ms(torch, mixed5, "poisson_z_kernel")
    before_ms = device_ms(torch, before5, calls=20)
    mixed_ev, before_ev = event_ms(torch, mixed5), event_ms(torch, before5)
    pc = C * n5 * int((fam5 == 3).sum())
    b5, by5 = bound_ms(4.0 * (3 * pc + n5 * s5 + C * s5 + s5), 150.0 * pc)
    c5 = C * n5 * s5
    bm, bym = bound_ms(4.0 * (3 * c5 + n5 * s5 + C * s5 + s5), 150.0 * c5)
    print(f"B5 at config 5's shape {C}x{n5}x{s5}: the whole Z update (the "
          f"sampler's launch) {mixed_ms:.5f} ms (bound {bm:.6f} ms by {bym}),"
          f" with enqueue {mixed_ev:.4f} ms, against the Z block as the "
          f"sampler ran it before (B1, B5's first version, the torch ops) "
          f"{before_ms:.5f} ms of device work, with enqueue {before_ev:.4f} "
          f"ms; poisson_z, its 30 Poisson columns alone, {ms5:.5f} ms "
          f"(first version {first5_ms:.5f} ms; bound {b5:.6f} ms by {by5}) "
          f"[{card}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, event_ms=ev,
                plain_event_ms=plain_ev, held_ms=held, shape=[C, ny, ns],
                first_ms=first_ms, config5_ms=mixed_ms,
                config5_bound_ms=bm, config5_event_ms=mixed_ev,
                config5_before_ms=before_ms,
                config5_before_event_ms=before_ev,
                config5_poisson_ms=ms5, config5_poisson_first_ms=first5_ms,
                config5_poisson_bound_ms=b5)


def gram_inputs(torch, dev, C, ny, ns, P, seed):
    """A 10%-missing mask with one all-missing species and one all-missing
    row, and the per-species (XE, Z) and per-row (Lambda, S, iSigma)
    operands."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = (torch.rand((ny, ns), generator=g, device=dev) > 0.1).float()
    mask[:, 3] = 0.0
    mask[5, :] = 0.0
    XE = torch.randn((C, ny, P), generator=g, device=dev)
    Z = torch.randn((C, ny, ns), generator=g, device=dev)
    lam = torch.randn((C, P, ns), generator=g, device=dev)
    iSigma = torch.rand((C, ns), generator=g, device=dev) + 0.5
    return mask, XE, Z, lam, iSigma


def check_b6(torch, tgram, dev, card):
    C, ny, ns, nf = (HEADLINE["n_chains"], HEADLINE["ny"], HEADLINE["ns"],
                     HEADLINE["nf"])
    worst = 0.0
    forms = {}
    # P = 4 (config 5's nc + nf), 10 and 8 (the NA headline's BetaLambda
    # and Eta), 18 (nc + the default nf_cap 16)
    for P in (4, 8, 10, 18):
        mask, XE, Z, lam, iSigma = gram_inputs(torch, dev, C, ny, ns, P,
                                               seed=P)
        args = {"species": (XE, mask.T, Z.transpose(1, 2), None),
                "row": (lam.transpose(1, 2), mask, Z, iSigma)}
        for form, (v, w, s_, a) in args.items():
            Gk, Rk = tgram.masked_gram(v, w, s_, a)
            Gp, Rp = tgram._masked_gram_plain(v, w, s_, a)
            empty = (Gk[:, 3], Rk[:, 3]) if form == "species" else (
                Gk[:, 5], Rk[:, 5])
            assert not any(t.any() for t in empty), \
                f"B6 {form} P={P}: the all-missing output is not zero"
            rels = []
            for name, k, p in (("G", Gk, Gp), ("R", Rk, Rp)):
                assert torch.isfinite(k).all(), f"B6 {form} {name} P={P}"
                diff = (k - p).abs().max().item()
                rels.append(diff / p.abs().max().item())
                assert rels[-1] <= 1e-4, \
                    f"B6 {form} {name} P={P}: rel diff {rels[-1]} > 1e-4"
                worst = max(worst, diff)
            again = tgram.masked_gram(v, w, s_, a)
            assert torch.equal(Gk, again[0]) and torch.equal(Rk, again[1]), \
                f"B6 {form} P={P}: two runs differ"
            print(f"B6 check: {form} form, P={P}: max |kernel - plain| / "
                  f"max |plain| = {rels[0]:.3g} (G), {rels[1]:.3g} (R) "
                  f"(tolerance 1e-4); the all-missing {form} is zero; two "
                  f"runs bit-identical")
            forms[(form, P)] = (v, w, s_, a)

    res = {}
    for form, P in (("species", 2 + nf), ("row", nf)):
        v, w, s_, a = forms[(form, P)]
        Cv, Kd, _ = v.shape
        O = w.shape[0]
        wa = w[None] if a is None else w[None] * a[:, None, :]
        wa = wa.expand(Cv, -1, -1)

        def kern():
            tgram.masked_gram(v, w, s_, a)

        def plain():
            tgram._masked_gram_plain(v, w, s_, a)

        def library():
            torch.einsum("cok,ckp,ckq->copq", wa, v, v)

        parts = [device_ms(torch, kern, m)
                 for m in ("masked_gram_columns_kernel", "masked_gram_kernel",
                           "masked_gram_sum_kernel")]
        ms = sum(parts)
        plain_ms = device_ms(torch, plain, calls=10)
        lib_ms = device_ms(torch, library, calls=10)
        ev, plain_ev = event_ms(torch, kern), event_ms(torch, plain, batch=5)
        held = held_event_ms(torch, kern)
        # bytes: v, w, s (and a) read once, G and R written once;
        # operations: a multiply-add per (chain, output, k) for each of the
        # P(P+1)/2 gram entries and P right-hand-side entries
        nbytes = 4.0 * (Cv * Kd * P + O * Kd + Cv * O * Kd + Cv * O * P * P
                        + Cv * O * P + (0 if a is None else Cv * Kd))
        b, by = bound_ms(nbytes, 2.0 * Cv * O * Kd * (P * (P + 1) / 2 + P))
        S, _ = tgram.gram_splits(Cv, O, Kd, P)
        print(f"B6 masked_gram device time, {form} form (C={Cv}, O={O}, "
              f"K={Kd}, P={P}, {S} k splits): {ms:.4f} ms ("
              f"{' + '.join(f'{x:.4f}' for x in parts)}; plain "
              f"{plain_ms:.4f} ms, one torch.einsum "
              f"for G {lib_ms:.4f} ms, bound {b:.5f} ms by {by}; held stream "
              f"{held:.5f} ms, with enqueue {ev:.4f} ms, plain "
              f"{plain_ev:.4f} ms) [{card}]")
        res[form] = dict(max_abs_err=worst, ms=ms, parts_ms=parts,
                         plain_ms=plain_ms, bound_ms=b, bound_by=by,
                         library_ms=lib_ms, event_ms=ev,
                         plain_event_ms=plain_ev, held_ms=held,
                         shape=[Cv, O, Kd, P])
    # the line reports the per-species form, the larger of the two per
    # sweep, with the per-row form's times beside it
    return dict(res["species"], **{f"row_{k}": res["row"][k] for k in (
        "ms", "plain_ms", "bound_ms", "library_ms", "shape")})


def nngp_level(torch, dev, n, k, side, seed):
    """An NNGP level's tensors on the card, as ``LevelData`` holds them: the
    port's grids for ``n`` uniform units on a ``side`` x ``side`` square
    with ``k`` neighbours over the default 101-point alpha grid, and the
    reverse-neighbour lists.  Returns the level and its unit count that
    have at least one real neighbour listed."""
    from types import SimpleNamespace

    from hmsc_tpu_torch.mcmc.structs import (reverse_neighbours,
                                             unit_last_grids)
    from hmsc_tpu_torch.precompute import _nngp_grids

    pts = np.random.default_rng(seed).uniform(size=(n, 2)) * side
    diag = float(np.sqrt(((pts.max(0) - pts.min(0)) ** 2).sum()))
    lp = _nngp_grids(pts, k, diag * np.arange(101) / 100)
    rev = reverse_neighbours(lp.nn_idx, lp.nn_n)
    unit = unit_last_grids(lp.nn_idx, lp.nn_coef)

    def t(a, dt=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dt, device=dev)

    i32 = torch.int32
    return SimpleNamespace(
        nn_idx=t(lp.nn_idx, i32), nn_coef=t(lp.nn_coef), nn_D=t(lp.nn_D),
        nn_idx_u=t(unit[0], i32), nn_coef_u=t(unit[1]),
        nn_n=t(lp.nn_n, i32),
        rev_ptr=t(rev[0], i32), rev_pos=t(rev[1], i32))


def _rel(k, p):
    """max |kernel - plain| / max |plain|."""
    return ((k - p).abs().max() / p.abs().max()).item()


def _grid_bytes(lvd, alpha):
    """Bytes of the coefficient and variance slices at the distinct alpha
    indices in use (what this run's data needs), and of the lists."""
    n, k = lvd.nn_idx.shape
    used = int(alpha.unique().numel())
    return 4.0 * (used * n * (k + 1) + n * k)


# config 3b's kernel shapes and the 5000-unit NNGP level of
# benchmarks/bench_shard.py:260 (8 neighbours, 20 x 20 square)
B8_SHAPES = ((1000, 10, 10.0), (5000, 8, 20.0))
# B8b also runs on the dense-NNGP path (np 100: fewer units than a block
# has threads)
B8B_SHAPES = B8_SHAPES + ((CONFIG3["dense_nngp"]["np"], 10, 10.0),)
B8_C, B8_NF, B8_G = 4, 2, 101


def check_b8a(torch, tsp, dev, card):
    res = {}
    for n, k, side in B8_SHAPES:
        lvd = nngp_level(torch, dev, n, k, side, seed=n)
        g = torch.Generator(device=dev).manual_seed(n + 1)
        alpha = torch.randint(1, B8_G, (B8_C, B8_NF), generator=g,
                              device=dev, dtype=torch.int32)
        alpha[0, 0] = 0                    # planted: iW = I for this factor
        x = torch.randn((B8_C, n, B8_NF), generator=g, device=dev)
        u = torch.randn((B8_C, n, B8_NF), generator=g, device=dev)
        M = torch.randn((B8_C, n, B8_NF, B8_NF), generator=g, device=dev)
        LiSL = (M @ M.transpose(2, 3)).contiguous()
        fk = tsp.vecchia_riw(lvd, alpha, x)
        tk = tsp.vecchia_riw_t(lvd, alpha, u)
        pk = tsp.vecchia_pmv(lvd, alpha, x, LiSL)
        t_p = tsp._vecchia_riw_plain(lvd, alpha, x, True)
        pairs = (("forward", fk, tsp._vecchia_riw_plain(lvd, alpha, x,
                                                          False)),
                 ("transpose", tk, tsp._vecchia_riw_t_plain(
                     lvd, alpha, u, None, None, False)),
                 ("pmv", pk, tsp._vecchia_riw_t_plain(lvd, alpha, t_p, LiSL,
                                                      x, True)))
        errs = []
        for label, kk, pp in pairs:
            assert torch.isfinite(kk).all(), f"B8a {label}: non-finite"
            rel = _rel(kk, pp)
            # the neighbour sums are taken in another order than the plain
            # version's einsum and index_add_
            assert rel <= 1e-5, f"B8a {label} np={n}: rel diff {rel} > 1e-5"
            errs.append((kk - pp).abs().max().item())
        lhs = (fk.double() * u.double()).sum().item()
        rhs = (x.double() * tk.double()).sum().item()
        scale = (fk.double() * u.double()).abs().sum().item()
        adj = abs(lhs - rhs) / scale
        assert adj <= 1e-5, f"B8a adjoint identity np={n}: {adj} > 1e-5"
        assert torch.equal(fk[0, :, 0], x[0, :, 0]) and torch.equal(
            tk[0, :, 0], u[0, :, 0]), "B8a: alpha = 0 is not the identity"
        assert torch.equal(pk, tsp.vecchia_pmv(lvd, alpha, x, LiSL)), \
            "B8a: two runs differ"
        print(f"B8a check np={n} k={k}: max |kernel - plain| / max |plain| "
              f"{_rel(fk, pairs[0][2]):.3g} (forward), "
              f"{_rel(tk, pairs[1][2]):.3g} (transpose), "
              f"{_rel(pk, pairs[2][2]):.3g} (pmv) (tolerance 1e-5: another "
              f"summation order); <RiW x, u> - <x, RiW' u> relative "
              f"{adj:.3g} (1e-5); alpha 0 exactly the identity; two runs "
              f"bit-identical")

        def kern():
            tsp.vecchia_pmv(lvd, alpha, x, LiSL)

        def plain():
            t = tsp._vecchia_riw_plain(lvd, alpha, x, True)
            tsp._vecchia_riw_t_plain(lvd, alpha, t, LiSL, x, True)

        R, Rt, v = riw_csr(torch, lvd, alpha, x)
        lib_err = _rel((R @ v).reshape(B8_C, B8_NF, n).transpose(1, 2), fk)
        assert lib_err <= 1e-5, f"B8a: the CSR yardstick differs ({lib_err})"

        def library():
            Rt @ (R @ v)

        ms_f = device_ms(torch, kern, "vecchia_fwd_kernel")
        ms_a = device_ms(torch, kern, "vecchia_adj_kernel")
        plain_ms = device_ms(torch, plain, calls=10)
        lib_ms = device_ms(torch, library, calls=10)
        ev, plain_ev = event_ms(torch, kern), event_ms(torch, plain, batch=5)
        held = held_event_ms(torch, kern)
        nnz = int(lvd.rev_pos.numel())
        cells = B8_C * n * B8_NF
        # bytes: x, LiSL and alpha in, P x out, the grid slices at the
        # alphas in use, the neighbour lists and the reverse CSR (rev_ptr,
        # rev_pos); operations: the
        # forward's 2k + 3 a cell, the transpose's 2 a real neighbour per
        # (chain, factor) and the likelihood's 2 nf a cell
        nbytes = (4.0 * (2 * cells + cells * B8_NF + B8_C * B8_NF)
                  + _grid_bytes(lvd, alpha) + 4.0 * (n + 1 + nnz))
        ops = cells * (2 * k + 3 + 2 * B8_NF + 1) + 2.0 * B8_C * B8_NF * nnz
        b, by = bound_ms(nbytes, ops)
        print(f"B8a vecchia_apply device time, one P x (forward + transpose) "
              f"at C {B8_C}, np {n}, nf {B8_NF}, k {k}: {ms_f + ms_a:.5f} ms "
              f"({ms_f:.5f} + {ms_a:.5f}; plain {plain_ms:.4f} ms, "
              f"torch.sparse CSR RiW then RiW' {lib_ms:.5f} ms, bound "
              f"{b:.6f} ms by {by}; held stream {held:.5f} ms, with enqueue "
              f"{ev:.4f} ms, plain {plain_ev:.4f} ms) [{card}]")
        res[n] = dict(max_abs_err=max(errs), apply_ms=ms_f + ms_a,
                      fwd_ms=ms_f, adj_ms=ms_a, apply_plain_ms=plain_ms,
                      apply_bound_ms=b, apply_library_ms=lib_ms,
                      apply_event_ms=ev, apply_held_ms=held,
                      **check_b8a_cg(torch, tsp, dev, card, lvd, n, k))
    return res[B8_SHAPES[0][0]]


# B8e: the site meshes its check splits the B8a shapes' levels over
B8E_RANKS = (2, 4)


def as_level(lvd):
    """A level of ``nngp_level`` as the sampler's ``LevelData``."""
    from hmsc_tpu_torch.mcmc.structs import LevelData

    return LevelData(pi_row=None, unit_count=None, x_row=None, x_unit=None,
                     nu=None, a1=None, b1=None, a2=None, b2=None,
                     **vars(lvd))


def check_b8e(torch, tsp, dev, card):
    """B8e, the site-local Vecchia apply, at the B8a shapes' levels split
    over 2 and 4 ranks (one process: each rank's block made by
    ``structs.site_slice_level``): each rank's partials of both forms
    against the plain version (1e-5), their sum in rank order against
    B8a's unsharded ``vecchia_pmv`` / ``vecchia_riw_t`` (1e-5), reruns
    bit-identical; rank 0's pmv form timed (both launches)."""
    from hmsc_tpu_torch.mcmc.partition import ShardCtx
    from hmsc_tpu_torch.mcmc.structs import site_slice_level

    res = {}
    for n, k, side in B8_SHAPES:
        lvd = as_level(nngp_level(torch, dev, n, k, side, seed=n))
        g = torch.Generator(device=dev).manual_seed(n + 7)
        alpha = torch.randint(1, B8_G, (B8_C, B8_NF), generator=g,
                              device=dev, dtype=torch.int32)
        alpha[0, 0] = 0
        x = torch.randn((B8_C, n, B8_NF), generator=g, device=dev)
        u = torch.randn((B8_C, n, B8_NF), generator=g, device=dev)
        M = torch.randn((B8_C, n, B8_NF, B8_NF), generator=g, device=dev)
        LiSL = (M @ M.transpose(2, 3)).contiguous()
        want_p = tsp.vecchia_pmv(lvd, alpha, x, LiSL)
        want_r = tsp.vecchia_riw_t(lvd, alpha, u)
        for m in B8E_RANKS:
            sum_p, sum_r, errs, rels = 0.0, 0.0, [], []
            for r in range(m):
                ctx = ShardCtx(m=m, rank=r, ny=n, np_r=(n,))
                lv = site_slice_level(lvd, ctx)
                off = ctx.site_offset(n)
                L_r, u_r = ctx.slice_site(LiSL, 1), ctx.slice_site(u, 1)
                pk = tsp.vecchia_site_pmv(lv, alpha, x, L_r, off)
                rk = tsp.vecchia_site_riw_t(lv, alpha, u_r, n, off)
                for label, kk, pp in (
                        ("pmv", pk, tsp._vecchia_site_plain(
                            lv, alpha, x, None, L_r, n, off)),
                        ("riw_t", rk, tsp._vecchia_site_plain(
                            lv, alpha, None, u_r, None, n, off))):
                    assert torch.isfinite(kk).all(), f"B8e {label}: NaN"
                    rel = _rel(kk, pp)
                    # the neighbour sums in another order than the plain
                    # version's einsum and index_add_
                    assert rel <= 1e-5, (f"B8e {label} np={n} m={m} rank "
                                         f"{r}: rel diff {rel} > 1e-5")
                    errs.append((kk - pp).abs().max().item())
                    rels.append(rel)
                assert torch.equal(pk, tsp.vecchia_site_pmv(
                    lv, alpha, x, L_r, off)) and torch.equal(
                        rk, tsp.vecchia_site_riw_t(lv, alpha, u_r, n, off)), \
                    f"B8e np={n} m={m} rank {r}: two runs differ"
                sum_p, sum_r = sum_p + pk, sum_r + rk      # rank order
            rel_p, rel_r = _rel(sum_p, want_p), _rel(sum_r, want_r)
            assert rel_p <= 1e-5 and rel_r <= 1e-5, (
                f"B8e np={n} m={m}: sum over ranks against B8a rel diff "
                f"{rel_p} (pmv), {rel_r} (riw_t) > 1e-5")
            ctx = ShardCtx(m=m, rank=0, ny=n, np_r=(n,))
            lv = site_slice_level(lvd, ctx)
            L_0 = ctx.slice_site(LiSL, 1)

            def kern():
                tsp.vecchia_site_pmv(lv, alpha, x, L_0, 0)

            def plain():
                tsp._vecchia_site_plain(lv, alpha, x, None, L_0, n, 0)

            ms_t = device_ms(torch, kern, "vecchia_site_t_kernel")
            ms_a = device_ms(torch, kern, "vecchia_site_adj_kernel")
            plain_ms = device_ms(torch, plain, calls=10)
            ev = event_ms(torch, kern)
            n_l = n // m
            nnz = int(lv.rev_pos.numel())
            cells, cells_l = B8_C * n * B8_NF, B8_C * n_l * B8_NF
            # bytes: x and the partial (full width), the rank's LiSL block
            # and alpha in, its grid slices at the alphas in use and lists,
            # its reverse CSR (np + 1 offsets, its nnz positions);
            # operations: the forward's 2k + 3 a local cell, the adjoint's
            # 2 a local real neighbour per (chain, factor), the likelihood's
            # 2 nf + 1 a local cell
            nbytes = (4.0 * (2 * cells + cells_l * B8_NF + B8_C * B8_NF)
                      + _grid_bytes(lv, alpha) + 4.0 * (n + 1 + nnz))
            ops = (cells_l * (2 * k + 3 + 2 * B8_NF + 1)
                   + 2.0 * B8_C * B8_NF * nnz)
            b, by = bound_ms(nbytes, ops)
            print(f"B8e check np={n} k={k} on {m} ranks: each rank's "
                  f"partial against the plain version max rel "
                  f"{max(rels):.3g} (1e-5: another summation order), the "
                  f"partials summed in rank order against B8a's unsharded "
                  f"apply {rel_p:.3g} (pmv), {rel_r:.3g} (riw_t) (1e-5); "
                  f"reruns bit-identical.  Rank 0's P x partial (np_l "
                  f"{n_l}, full-width output): {ms_t + ms_a:.5f} ms device "
                  f"({ms_t:.5f} rows + {ms_a:.5f} adjoint), {ev:.4f} ms "
                  f"with enqueue (events), plain {plain_ms:.4f} ms, bound "
                  f"{b:.6f} ms by {by} [{card}]")
            res[(n, m)] = dict(max_abs_err=max(errs), ms=ms_t + ms_a,
                               event_ms=ev, plain_ms=plain_ms, bound_ms=b,
                               bound_by=by, library_ms=None)
    first = res[(B8_SHAPES[0][0], 2)]
    return {**first, "by_shape": {f"np{n}_m{m}": v
                                  for (n, m), v in res.items()}}


def b8a_cg_cost(lvd, alpha, n, k, iters):
    """The bound of one fused CG draw (C chains, ``iters`` their
    iterations): bytes, each read once: F, eps1, b_like, x0 and LiSL in,
    x, res and the counts out, the grid slices at the alphas in use, the
    neighbour lists and the reverse CSR; operations: the right-hand side
    (a transpose: 2 a real neighbour, 3 a cell), one P x a cell of 2k + 3
    (forward) + 2 a real neighbour (transpose) + 2 nf + 1 (likelihood) for
    the initial residual, each iteration and the true residual, and 10 a
    cell an iteration for the dot products and updates."""
    C, nf = B8_C, B8_NF
    cells = C * n * nf
    nnz = int(lvd.rev_pos.numel())
    nbytes = (4.0 * (4 * cells + cells * nf + cells + 2 * C)
              + _grid_bytes(lvd, alpha) + 4.0 * (n + 1 + nnz))
    pmv = (n * nf * (2 * k + 3 + 2 * nf + 1) + 2.0 * nf * nnz)
    ops = C * (n * nf * 3 + 2.0 * nf * nnz) + sum(
        (it + 2) * pmv + it * 10.0 * n * nf for it in iters)
    return bound_ms(nbytes, ops)


# the species and sites a unit of config 3b's generator has: the likelihood
# gram of a unit is LiSL = sites x Lambda iSigma Lambda'
B8A_CG_NS, B8A_CG_SITES = 50, 2


def b8a_cg_systems(torch, dev, n, seed):
    """Two CG systems for C chains on an ``n``-unit level, each (alpha,
    LiSL, F, eps1, b_like, x0): "sampler", built as the Eta draw builds it
    (config 3b's likelihood: 50 species, 2 sites a unit, Lambda ~ N(0, 1),
    iSigma ~ U(0.5, 2); F and b_like from the sites' residuals and xi;
    x0 ~ N(0, 1), a previous draw's scale), which CG solves in a few
    iterations; and "hard", a random LiSL = M M' / 10 that leaves the prior
    ill-conditioned at a large alpha (hundreds of iterations)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    C, nf = B8_C, B8_NF
    alpha = torch.randint(1, B8_G, (C, nf), generator=g, device=dev,
                          dtype=torch.int32)
    alpha[0, 0] = 0
    shape = (C, n, nf)

    def rn(*sh):
        return torch.randn(sh, generator=g, device=dev)

    lam = rn(C, nf, B8A_CG_NS)
    isig = 0.5 + 1.5 * torch.rand((C, B8A_CG_NS), generator=g, device=dev)
    gram = torch.einsum("cfj,cj,cgj->cfg", lam, isig, lam) * B8A_CG_SITES
    S = rn(C, n * B8A_CG_SITES, B8A_CG_NS)
    xi = rn(C, n * B8A_CG_SITES, B8A_CG_NS)
    unit = torch.arange(n, device=dev).repeat_interleave(B8A_CG_SITES)

    def per_unit(v):                      # (C, sites, ns) -> (C, np, nf)
        out = torch.zeros(shape, device=dev)
        return out.index_add_(1, unit, (v * isig[:, None, :])
                              @ lam.transpose(1, 2))

    sampler = (alpha, gram[:, None].expand(C, n, nf, nf).contiguous(),
               per_unit(S), rn(*shape),
               per_unit(xi / isig.sqrt()[:, None, :]), rn(*shape))
    M = rn(C, n, nf, nf)
    hard = (alpha, (0.1 * M @ M.transpose(2, 3)).contiguous(), rn(*shape),
            rn(*shape), rn(*shape), rn(*shape))
    return {"sampler": sampler, "hard": hard}


def deterministic_plain(torch, fn, *args):
    """``fn(*args)`` with PyTorch's deterministic algorithms: on the card
    ``index_add_`` (the plain transpose apply's segment sum) otherwise adds
    with atomics in a varying order, so the plain CG loop's float32
    iterates, and the iteration at which a hard system crosses its stopping
    threshold, would change from run to run (``warn_only``: the GEMMs,
    deterministic on one stream, only warn)."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CUBLAS_WORKSPACE.*")
            return fn(*args)
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def check_b8a_cg(torch, tsp, dev, card, lvd, n, k):
    """B8a's fused CG draw (``vecchia_cg``, one launch) against the plain
    host loop (``_vecchia_cg_plain``, run twice to the same bits under
    :func:`deterministic_plain`) on the same inputs
    (:func:`b8a_cg_systems`) at CG_TOL 1e-5: per chain both true relative
    residuals below 1e-4, x within 1e-4 of the plain x (max norm relative
    to max |x|), two runs bit-identical, with the vectors in shared and in
    global memory; iteration counts within 1 on the sampler's system, and
    within 1 or 2% on the hard one (hundreds of float32 iterations, summed
    in another order, cross the stopping threshold a few apart), where x
    is held to 1e-3 on a chain the plain loop left at maxiter short of its
    tolerance (an unconverged iterate).  Times on
    the sampler's system: the draw's device time (one launch), its cost a
    further iteration (a draw of 10 iterations against one of 2, tol 0),
    the enqueue-included event time."""
    from hmsc_tpu_torch.mcmc import spatial as tms

    tol, maxiter = tms.CG_TOL, tms.CG_MAXITER
    systems = b8a_cg_systems(torch, dev, n, seed=n + 7)
    G, units, threads, smem, _ = tsp.cg_geometry(n, B8_NF)
    saved = tsp._CG_SMEM_MAX
    for name, (alpha, LiSL, F, eps1, b_like, x0) in systems.items():
        call = (lvd, alpha, LiSL, F, eps1, b_like, x0, tol, maxiter)
        xp, rp, kp = deterministic_plain(torch, tsp._vecchia_cg_plain, *call)
        xp2, _, kp2 = deterministic_plain(torch, tsp._vecchia_cg_plain, *call)
        assert torch.equal(xp, xp2) and torch.equal(kp, kp2), \
            f"B8a CG np={n} {name}: two plain loops differ"
        lines = []
        for label, cap in (("shared memory", saved), ("global memory", 0)):
            tsp._CG_SMEM_MAX = cap
            try:
                xk, rk, kk = tsp.vecchia_cg(*call)
                xk2, rk2, kk2 = tsp.vecchia_cg(*call)
            finally:
                tsp._CG_SMEM_MAX = saved
            torch.cuda.synchronize()
            where = f"B8a CG np={n} {name} ({label})"
            assert torch.equal(xk, xk2) and torch.equal(rk, rk2) and \
                torch.equal(kk, kk2), f"{where}: two runs differ"
            assert torch.isfinite(xk).all(), f"{where}: non-finite x"
            assert (rk < 1e-4).all() and (rp < 1e-4).all(), \
                f"{where}: residuals {rk.tolist()}, plain {rp.tolist()}"
            xerr = ((xk - xp).abs().amax(dim=(1, 2))
                    / xp.abs().amax(dim=(1, 2)))
            # a chain the plain loop stopped at maxiter, short of tol, is an
            # unconverged iterate (hard system at np 5000): 1e-3
            xtol = torch.where(kp < maxiter, 1e-4, 1e-3)
            assert (xerr <= xtol).all(), \
                f"{where}: x differs by {xerr.tolist()}"
            slack = 1 if name == "sampler" else torch.clamp_min(
                (0.02 * kp).floor(), 1)
            assert ((kk - kp).abs() <= slack).all(), \
                f"{where}: iterations {kk.tolist()} against the plain " \
                f"loop's {kp.tolist()}"
            lines.append(f"{label}: residuals "
                         f"{[f'{v:.2e}' for v in rk.tolist()]}, x max rel "
                         f"diff {xerr.max().item():.2e}, iterations "
                         f"{kk.tolist()}")
        print(f"B8a CG draw check np={n} k={k}, {name} system (clusters of "
              f"{G} CTAs of {threads} threads, {units} units a CTA, {smem} "
              f"bytes of shared memory): plain loop (deterministic, two runs "
              f"bit-identical) residuals "
              f"{[f'{v:.2e}' for v in rp.tolist()]}, iterations "
              f"{kp.tolist()}; kernel, " + "; ".join(lines) + " (residuals "
              f"< 1e-4, x 1e-4 of max |x| (1e-3 at maxiter), iterations "
              f"within "
              f"{'1' if name == 'sampler' else '1 or 2%'}); two runs "
              f"bit-identical")

    alpha, LiSL, F, eps1, b_like, x0 = systems["sampler"]
    call = (lvd, alpha, LiSL, F, eps1, b_like, x0, tol, maxiter)
    kk = tsp.vecchia_cg(*call)[2]

    def kern():
        tsp.vecchia_cg(*call)

    def plain():
        tsp._vecchia_cg_plain(*call)

    def fixed(m):
        return lambda: tsp.vecchia_cg(lvd, alpha, LiSL, F, eps1, b_like, x0,
                                      0.0, m)

    ms = device_ms(torch, kern, "vecchia_cg_kernel")
    ms2 = device_ms(torch, fixed(2), "vecchia_cg_kernel")
    ms10 = device_ms(torch, fixed(10), "vecchia_cg_kernel")
    plain_ms = device_ms(torch, plain, calls=5)
    ev = event_ms(torch, kern)
    plain_ev = event_ms(torch, plain, batch=3)
    held = held_event_ms(torch, kern)
    b, by = b8a_cg_cost(lvd, alpha, n, k, kk.tolist())
    per_it = (ms10 - ms2) / 8
    print(f"B8a vecchia_cg device time, one CG draw (one launch) at C {B8_C}"
          f", np {n}, nf {B8_NF}, k {k}, the sampler's system, iterations "
          f"{kk.tolist()}: {ms:.5f} ms (2 iterations {ms2:.5f} ms, 10 "
          f"iterations {ms10:.5f} ms: {per_it:.5f} ms a further iteration; "
          f"plain host loop {plain_ms:.4f} ms; bound {b:.6f} ms by {by}; "
          f"held stream {held:.5f} ms, with enqueue {ev:.4f} ms, plain "
          f"{plain_ev:.4f} ms) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=None, event_ms=ev, plain_event_ms=plain_ev,
                held_ms=held, ms_2_iterations=ms2, ms_10_iterations=ms10,
                ms_an_iteration=per_it, iterations=kk.tolist(),
                shape=[B8_C, n, B8_NF, k])


def riw_csr(torch, lvd, alpha, x):
    """The same RiW as torch.sparse CSR matrices, block-diagonal over
    (chain, factor) (real neighbours only), its transpose, and x as the
    matching column: the library yardstick of B8a, timed only."""
    nn = lvd.nn_idx.long().cpu().numpy()
    nn_n = lvd.nn_n.cpu().numpy()
    coef, D = lvd.nn_coef.cpu().numpy(), lvd.nn_D.cpu().numpy()
    n, k = nn.shape
    real = np.arange(k)[None, :] < nn_n[:, None]
    ri, rk = np.nonzero(real)
    rows, cols, vals = [], [], []
    C, nf = alpha.shape
    for c in range(C):
        for f in range(nf):
            a = int(alpha[c, f])
            off = (c * nf + f) * n
            sq = np.sqrt(D[a])
            rows += [np.arange(n) + off, ri + off]
            cols += [np.arange(n) + off, nn[ri, rk] + off]
            vals += [1.0 / sq, -coef[a, ri, rk] / sq[ri]]
    idx = torch.tensor(np.stack([np.concatenate(rows), np.concatenate(cols)]))
    val = torch.tensor(np.concatenate(vals), dtype=torch.float32)
    N = C * nf * n
    v = x.transpose(1, 2).reshape(N, 1).contiguous()
    with warnings.catch_warnings():               # "CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        R, Rt = (torch.sparse_coo_tensor(i, val, (N, N), check_invariants=True)
                 .coalesce().to_sparse_csr().to(x.device)
                 for i in (idx, idx.flip(0)))
    return R, Rt, v


# B8b's extra checks: an odd unit count, C nf = 32 columns (4 chains x nf
# 8, dense NNGP's largest nf_max), at config 3b's level, and its first 11
# grid points (a grid of fewer points than the card has SMs)
B8B_CHECKS = ((999, 10, 10.0, B8_NF, B8_G), (1000, 10, 10.0, 8, B8_G),
              (1000, 10, 10.0, B8_NF, 11))


def check_b8b(torch, tsp, dev, card):
    res = {}
    shapes = [(n, k, side, B8_NF, B8_G, True) for n, k, side in B8B_SHAPES
              ] + [(*c, False) for c in B8B_CHECKS]
    for n, k, side, nf, G, timed in shapes:
        lvd = nngp_level(torch, dev, n, k, side, seed=n)
        if G < B8_G:                              # the grid's first G points
            lvd.nn_coef, lvd.nn_D = lvd.nn_coef[:G], lvd.nn_D[:G]
            lvd.nn_coef_u = lvd.nn_coef_u[:G]
        g = torch.Generator(device=dev).manual_seed(n + 2)
        alpha = torch.randint(0, G, (B8_C, nf), generator=g,
                              device=dev, dtype=torch.int32)
        eta = torch.randn((B8_C, n, nf), generator=g, device=dev)
        vk = tsp.nngp_quad_grid(lvd, eta)
        vp = tsp._nngp_quad_grid_plain(lvd, eta)
        ak = tsp.nngp_quad_at(lvd, alpha, eta)
        ap = tsp._nngp_quad_at_plain(lvd, alpha, eta)
        assert torch.isfinite(vk).all() and torch.isfinite(ak).all(), "B8b"
        # the order of summation differs from the plain version's: sums of
        # n positive terms (the quadratics) are held entry by entry, the
        # signed 1' iW eta = sum r1 re against its scale sqrt(q1 q), which
        # bounds both it and the sum of its terms' magnitudes
        e_grid = ((vk - vp).abs() / vp.abs()).max().item()
        e_q = ((ak[..., :2] - ap[..., :2]).abs() / ap[..., :2].abs()).max(
            ).item()
        e_s = ((ak[..., 2] - ap[..., 2]).abs()
               / (ap[..., 0] * ap[..., 1]).sqrt()).max().item()
        for label, e in (("grid", e_grid), ("at-alpha quadratics", e_q),
                         ("at-alpha 1' iW eta", e_s)):
            assert e <= 1e-5, f"B8b {label} np={n} C nf={B8_C * nf} G={G}: " \
                              f"rel diff {e} > 1e-5"
        assert torch.equal(vk, tsp.nngp_quad_grid(lvd, eta)), \
            "B8b grid mode: two runs differ"
        assert torch.equal(ak, tsp.nngp_quad_at(lvd, alpha, eta)), \
            "B8b at alpha: two runs differ"
        geo = tsp.quad_geometry(B8_C, n, nf)
        print(f"B8b check np={n} k={k} C nf={B8_C * nf} G={G}: grid rel diff "
              f"{e_grid:.3g}, at-alpha {e_q:.3g} (q, 1' iW 1) and {e_s:.3g} "
              f"(1' iW eta) (tolerance 1e-5: another summation order); two "
              f"runs bit-identical in both modes; grid launch {geo}, at "
              f"alpha {tsp.quad_at_geometry(n)}")
        if not timed:
            continue

        def grid():
            tsp.nngp_quad_grid(lvd, eta)

        def grid_plain():
            tsp._nngp_quad_grid_plain(lvd, eta)

        def at():
            tsp.nngp_quad_at(lvd, alpha, eta)

        def at_plain():
            tsp._nngp_quad_at_plain(lvd, alpha, eta)

        ms = device_ms(torch, grid, "nngp_quad_grid_kernel")
        plain_ms = device_ms(torch, grid_plain, calls=10)
        at_ms = device_ms(torch, at, "nngp_quad_at_kernel")
        at_plain_ms = device_ms(torch, at_plain, calls=10)
        ev, plain_ev = event_ms(torch, grid), event_ms(torch, grid_plain,
                                                       batch=5)
        held = held_event_ms(torch, grid)
        at_ev = event_ms(torch, at)
        cells = B8_C * n * nf
        # grid mode: the whole coefficient and variance grids, the lists,
        # eta in and C nf G out; 2k + 4 operations a cell and grid point.
        # at-alpha mode: the slices in use; 3k + 10 operations a cell
        b, by = bound_ms(4.0 * (B8_G * n * (k + 1) + n * k + cells
                                + B8_C * nf * B8_G),
                         B8_G * cells * (2 * k + 4))
        b_at, by_at = bound_ms(_grid_bytes(lvd, alpha) + 4.0 * (cells + 4
                                                                * B8_C * nf),
                               cells * (3 * k + 10))
        print(f"B8b nngp_quad device time at C {B8_C}, np {n}, nf {nf}, "
              f"k {k}, G {B8_G}: grid {ms:.5f} ms (plain {plain_ms:.4f} ms, "
              f"bound {b:.5f} ms by {by}; held stream {held:.5f} ms, with "
              f"enqueue {ev:.4f} ms, plain {plain_ev:.4f} ms); at-alpha "
              f"{at_ms:.5f} ms (plain {at_plain_ms:.4f} ms, bound "
              f"{b_at:.6f} ms by {by_at}; with enqueue {at_ev:.4f} ms) "
              f"[{card}]")
        res[n] = dict(max_abs_err=max((vk - vp).abs().max().item(),
                                      (ak - ap).abs().max().item()),
                      ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                      library_ms=None, event_ms=ev, plain_event_ms=plain_ev,
                      held_ms=held, at_ms=at_ms, at_plain_ms=at_plain_ms,
                      at_bound_ms=b_at, at_event_ms=at_ev,
                      shape=[B8_C, n, nf, k, B8_G])
    out = res[B8_SHAPES[0][0]]
    for n, r in res.items():
        if n != B8_SHAPES[0][0]:
            out.update({f"np{n}_ms": r["ms"], f"np{n}_at_ms": r["at_ms"],
                        f"np{n}_bound_ms": r["bound_ms"]})
    return out


# B8c's shapes: (np, nf, neighbours) at C 4: the dense-NNGP path's np 100,
# an odd np, the largest np the dense/CG crossover (np nf <= 256) admits at
# nf 2 and at nf 1, and a list of 40 neighbours (a unit's places outnumber
# a warp's lanes; more than 48 KB of shared memory a block)
B8C_SHAPES = ((97, 2, 10), (CONFIG3["dense_nngp"]["np"], 2, 10),
              (128, 2, 10), (256, 1, 10), (100, 2, 40))
# the first version of B8c (RiW a thread a row, then the gram by
# torch.matmul), built from its source to be timed beside the shipped one
B8C_FIRST_SOURCE = "scripts/older/nngp_riw_factor.cu"


def build_source(path, tag):
    """An extra kernel source with a plain C interface, compiled by nvcc for
    the card into the port's build directory and loaded with ctypes."""
    import ctypes
    import pathlib

    from hmsc_tpu_torch import kernels as K

    src = pathlib.Path(__file__).resolve().parent / path
    out = K._build_dir() / f"{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([K._nvcc(), *K._FLAGS, "-shared", "-I", str(K._CSRC),
                    str(src), "-o", str(out)], check=True,
                   capture_output=True, timeout=600)
    return ctypes.CDLL(str(out))


def first_b8c(torch, lib, lvd, alpha):
    """B8c's first version on the card: the factor RiW in one launch, then
    its gram (torch.matmul), as the dense NNGP draw formed iW before."""
    import ctypes

    C, nf = alpha.shape
    n, k = lvd.nn_idx.shape
    fn = lib.hmsc_nngp_riw
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    RiW = lvd.nn_coef.new_empty((C, nf, n, n))
    code = fn(lvd.nn_idx.data_ptr(), lvd.nn_coef.data_ptr(),
              lvd.nn_D.data_ptr(), alpha.data_ptr(), RiW.data_ptr(), C, n,
              nf, k, torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"B8c first version: cudaError {code}"
    return RiW.transpose(2, 3) @ RiW


def check_b8c(torch, tsp, dev, card):
    """B8c writes iW = RiW' RiW in one launch: against its plain version
    (the scatter, then the gram) at ``B8C_SHAPES``, max |kernel - plain| /
    max |plain| <= 1e-5 (the gram's sums in another order), alpha 0 giving
    I, a rerun to the same bits; timed beside its first version (the
    factor a thread a row, then torch.matmul) on the same inputs."""
    first = build_source(B8C_FIRST_SOURCE, "nngp_riw_first")
    res = {}
    for n, nf, k in B8C_SHAPES:
        lvd = nngp_level(torch, dev, n, k, 10.0, seed=n)
        g = torch.Generator(device=dev).manual_seed(n + 3)
        alpha = torch.randint(0, B8_G, (B8_C, nf), generator=g,
                              device=dev, dtype=torch.int32)
        alpha[0, 0] = 0
        Wk = tsp.nngp_riw_dense(lvd, alpha)
        Wp = tsp._nngp_riw_dense_plain(lvd, alpha)
        Wf = first_b8c(torch, first, lvd, alpha)
        torch.cuda.synchronize()
        err = _rel(Wk, Wp)
        err_first = _rel(Wf, Wp)
        assert err <= 1e-5, f"B8c np={n}: max |diff| / max {err} > 1e-5"
        assert err_first <= 1e-5, f"B8c first version np={n}: {err_first}"
        assert torch.isfinite(Wk).all(), f"B8c np={n}: non-finite"
        eye = torch.eye(n, device=dev)
        assert torch.equal(Wk[0, 0], eye), "B8c: alpha = 0 is not I"
        assert torch.equal(Wk, tsp.nngp_riw_dense(lvd, alpha)), \
            f"B8c np={n}: a rerun gave other bits"
        print(f"B8c check np={n}, nf {nf}, k {k}: max |kernel - plain| / "
              f"max |plain|"
              f" = {err:.3g} (tolerance 1e-5; the first version "
              f"{err_first:.3g}); alpha 0 gives I exactly; a rerun gives the "
              f"same bits")

        def kern():
            tsp.nngp_riw_dense(lvd, alpha)

        def plain():
            tsp._nngp_riw_dense_plain(lvd, alpha)

        def older():
            first_b8c(torch, first, lvd, alpha)

        ms = device_ms(torch, kern, "nngp_iw_kernel")
        plain_ms = device_ms(torch, plain, calls=10)
        first_ms = device_ms(torch, older)
        ev, plain_ev = event_ms(torch, kern), event_ms(torch, plain, batch=5)
        first_ev = event_ms(torch, older)
        held = held_event_ms(torch, kern)
        # bytes: iW out, the grid slices in use, the lists, counts and the
        # reverse-neighbour lists in; operations: a multiply-add for each
        # (i, j, l) with j and l in {i} and unit i's real neighbours
        nn_n = lvd.nn_n.long()
        used = alpha.unique().numel()
        nbytes = (4.0 * B8_C * nf * n * n + _grid_bytes(lvd, alpha)
                  + 4.0 * (n + lvd.rev_ptr.numel() + lvd.rev_pos.numel()))
        ops = 2.0 * B8_C * nf * float(((nn_n + 1) ** 2).sum())
        b, by = bound_ms(nbytes, ops)
        print(f"B8c nngp_riw device time at C {B8_C}, nf {nf}, np {n}, k "
              f"{k}: "
              f"{ms:.5f} ms (the first version and its gram {first_ms:.5f} "
              f"ms, with enqueue {first_ev:.4f} ms; plain {plain_ms:.4f} ms, "
              f"bound {b:.6f} ms by {by}; held stream {held:.5f} ms, with "
              f"enqueue {ev:.4f} ms, plain {plain_ev:.4f} ms; {used} grid "
              f"slices in use) [{card}]")
        res[n, k] = dict(max_abs_err=float((Wk - Wp).abs().max()),
                         rel_err=err,
                      ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                      library_ms=None, event_ms=ev, plain_event_ms=plain_ev,
                         held_ms=held, first_ms=first_ms,
                         first_event_ms=first_ev, shape=[B8_C, nf, n, n, k])
    out = dict(res[CONFIG3["dense_nngp"]["np"], 10])
    out["by_shape"] = {f"np {n} k {k}": {f: r[f] for f in (
        "ms", "first_ms", "bound_ms", "rel_err")} for (n, k), r in res.items()}
    return out


def gpp_level(torch, dev, n, n_knots, side, seed):
    """A GPP level's tensors on the card, as ``LevelData`` holds them (the
    types of ``mcmc.structs._tensor``: idDW12g, Fg and iFg in float64): the
    port's grids for ``n`` uniform units on a ``side`` x ``side`` square,
    knots from ``construct_knots(xy, n_knots)``, over the default
    101-point alpha grid.  Returns the level and its host grids (numpy,
    float64)."""
    from types import SimpleNamespace

    from hmsc_tpu_torch.mcmc.structs import _tensor
    from hmsc_tpu_torch.precompute import _gpp_grids, construct_knots

    pts = np.random.default_rng(seed).uniform(size=(n, 2)) * side
    diag = float(np.sqrt(((pts.max(0) - pts.min(0)) ** 2).sum()))
    alphas = diag * np.arange(101) / 100
    lp = _gpp_grids(pts, construct_knots(pts, n_knots=n_knots), alphas)
    alphapw = np.column_stack([alphas, np.full(101, 1 / 101)])
    return SimpleNamespace(
        alphapw=_tensor("alphapw", alphapw, dev, torch.float32),
        **{k: _tensor(k, getattr(lp, k), dev, torch.float32)
           for k in ("idDg", "idDW12g", "Fg", "iFg", "detDg")}), lp


# config 3c's kernel shapes (C 4, np 1000, nK 100, nf 2) and a small one
# (C 2, np 60, nK 9, nf 3); the factors' alpha indices cycle through 0
# (W = I), mid-grid and the last
B8D_SHAPES = ((4, 1000, 10, 2, 10.0), (2, 60, 3, 3, 10.0))
B8D_ALPHAS = (0, 50, 100)


def _gpp_alpha(torch, dev, C, nf):
    a = [[B8D_ALPHAS[(c * nf + f) % 3] for f in range(nf)] for c in range(C)]
    return torch.tensor(a, dtype=torch.int32, device=dev)


def _gpp_used_bytes(lvd, alpha, skip_zero=False):
    """Bytes of the grid slices at the distinct alpha indices in use: idD
    (float32), idD W12 and F or iF (float64); with ``skip_zero``, only
    those off alpha 0 (W = I, where B8d-3 reads no slice)."""
    _, n, nK = lvd.idDW12g.shape
    a = alpha.unique().long()
    if skip_zero:
        a = a[lvd.alphapw[a, 0] != 0]
    return int(a.numel()) * (4.0 * n + 8.0 * (n * nK + nK * nK))


def _gpp_quad_grid_f32(torch, lvd, eta):
    """The GPP grid quadratic as the JAX package forms it, in float32 (the
    grids rounded to float32, float32 sums): the reading the B8d-3 check
    must reject."""
    t1 = torch.einsum("gu,cuh->chg", lvd.idDg, eta ** 2)
    Et = torch.einsum("cuh,gum->chgm", eta, lvd.idDW12g.float())
    t2 = torch.einsum("chgm,gmn,chgn->chg", Et, lvd.iFg.float(), Et)
    return torch.where(lvd.alphapw[:, 0] == 0, (eta * eta).sum(1)[..., None],
                       t1 - t2)


# C1: the GPP draw and the location move's ones-form 1' iW 1 at config 3c's
# shape and these alpha indices (3c's range, mid-grid, the last), against
# float64 references built from grids made in float64 on the host; the
# port's must lie within 1e-3 of the draw's sd and 1e-3 of the ones-form
GPP_DRAW_ALPHAS = (14, 50, 100)


def _gpp_draw64(torch, tsp, lvd, alpha, LiSL, F, e1, e2):
    """The GPP Eta draw in float64 throughout (plain B8d-1, B8d-2, a
    float64 Cholesky and solves) from the level ``lvd``'s grids widened."""
    from types import SimpleNamespace

    from hmsc_tpu_torch.mcmc.spatial import gpp_draw
    from hmsc_tpu_torch.ops.linalg import chol_spd

    l64 = SimpleNamespace(**{k: v.double() for k, v in vars(lvd).items()})
    iA, LiA = tsp._gpp_unit_plain(l64, alpha, LiSL.double())
    return gpp_draw((tsp.gpp_m1_at(l64, alpha), iA, LiA, chol_spd(
        tsp._gpp_knot_plain(l64, alpha, iA))), F.double(), e1.double(),
        e2.double())


def check_gpp_draw(torch, tsp, dev, lvd, lp, LiSL, gen, card):
    """The GPP Eta draw at config 3c's shapes with every factor at each of
    ``GPP_DRAW_ALPHAS``: the port's draw (float32 per-unit work, H summed,
    factorised and solved in float64 from the float64 grids) against (i)
    the float64 draw from the same device grids and (ii) the float64 draw
    from grids made in float64 on the host (``lp``), each to 1e-3 of the
    reference's standard deviation; and the location move's ones-form
    ``1' iW 1`` (B8d-3 at alpha) against its float64 value from the host
    grids, to 1e-3 of it.  Beside them, for the record (C1): the same
    float64 draw and ones-form from the grids rounded to float32 (the
    port's grids before they were held in float64), and the all-float32
    draw (H rounded to float32 and factorised in float32, as the JAX
    package does)."""
    from types import SimpleNamespace

    from hmsc_tpu_torch.mcmc.spatial import gpp_draw, gpp_factor
    from hmsc_tpu_torch.ops.linalg import chol_spd

    C, n, nf, _ = LiSL.shape
    nK = lvd.idDW12g.shape[2]
    host = SimpleNamespace(alphapw=lvd.alphapw, **{
        k: torch.tensor(getattr(lp, k), dtype=torch.float64, device=dev)
        for k in ("idDg", "idDW12g", "Fg", "iFg")})
    f32 = SimpleNamespace(**vars(lvd))
    f32.idDW12g, f32.Fg = lvd.idDW12g.float(), lvd.Fg.float()
    F = 10.0 * torch.randn((C, n, nf), generator=gen, device=dev)
    e1 = torch.randn((C, n, nf), generator=gen, device=dev)
    e2 = torch.randn((C, nf * nK), generator=gen, device=dev)
    eta = torch.randn((C, n, nf), generator=gen, device=dev)
    for a in GPP_DRAW_ALPHAS:
        alpha = torch.full((C, nf), a, dtype=torch.int32, device=dev)
        M1, iA, LiA, LH = gpp_factor(lvd, alpha, LiSL)
        got = gpp_draw((M1, iA, LiA, LH), F, e1, e2).double()
        allf32 = gpp_draw((M1, iA, LiA, chol_spd(tsp.gpp_knot(lvd, alpha, iA)
                                                 .float())), F, e1, e2)
        ref = _gpp_draw64(torch, tsp, lvd, alpha, LiSL, F, e1, e2)
        ref_host = _gpp_draw64(torch, tsp, host, alpha, LiSL, F, e1, e2)
        ref_f32 = _gpp_draw64(torch, tsp, f32, alpha, LiSL, F, e1, e2)
        sd, sd_h = ref.std().item(), ref_host.std().item()
        err = (got - ref).abs().max().item() / sd
        err_h = (got - ref_host).abs().max().item() / sd_h
        err_f32 = (ref_f32 - ref_host).abs().max().item() / sd_h
        err_all = (allf32.double() - ref).abs().max().item() / sd
        assert torch.isfinite(got).all(), f"GPP draw at alpha index {a}"
        assert err <= 1e-3, f"GPP draw at alpha index {a}: {err} sd > 1e-3"
        assert err_h <= 1e-3, (f"GPP draw at alpha index {a}: {err_h} sd "
                               f"from the host's float64 grids > 1e-3")
        q1 = tsp.gpp_quad_at(lvd, alpha, eta)[..., 1].double()
        q1_host = tsp._gpp_quad_at_plain(host, alpha, eta.double())[..., 1]
        q1_f32 = tsp._gpp_quad_at_plain(f32, alpha, eta.double())[..., 1]
        rel = ((q1 - q1_host).abs() / q1_host.abs()).max().item()
        rel_f32 = ((q1_f32 - q1_host).abs() / q1_host.abs()).max().item()
        assert rel <= 1e-3, f"ones-form at alpha index {a}: rel {rel} > 1e-3"
        print(f"GPP draw at C {C}, np {n}, nK {nK}, nf {nf}, alpha index "
              f"{a}: max |port - float64| {err:.3g} sd (1e-3); against the "
              f"host's float64 grids {err_h:.3g} sd (1e-3), float32 grids "
              f"{err_f32:.3g} sd; the all-float32 draw {err_all:.3g} sd. "
              f"Ones-form 1' iW 1 against the host's float64 grids: port "
              f"{rel:.3g} (1e-3), float32 grids {rel_f32:.3g} [{card}]")


def check_b8d(torch, tsp, dev, card):
    """B8d-1 (gpp_unit), B8d-2 (gpp_knot) and B8d-3 (gpp_quad) against
    their plain versions at each of ``B8D_SHAPES``; times at 3c's."""
    res = {}
    for C, n, nk_side, nf, side in B8D_SHAPES:
        lvd, lp = gpp_level(torch, dev, n, nk_side, side, seed=n + 7)
        nK = lvd.idDW12g.shape[2]
        g = torch.Generator(device=dev).manual_seed(n + 4)
        alpha = _gpp_alpha(torch, dev, C, nf)
        M = torch.randn((C, n, nf, nf), generator=g, device=dev)
        LiSL = (M @ M.transpose(2, 3) * 20.0).contiguous()
        bad = [(0, 3), (C - 1, n // 2)]
        LiSL_bad = LiSL.clone()
        for c, u in bad:
            LiSL_bad[c, u] -= 1e4 * torch.eye(nf, device=dev)

        # B8d-1: per-unit blocks; NaN where a block is indefinite
        iAk, LiAk = tsp.gpp_unit(lvd, alpha, LiSL_bad)
        iAp, LiAp = tsp._gpp_unit_plain(lvd, alpha, LiSL_bad)
        nanm = torch.zeros((C, n), dtype=torch.bool, device=dev)
        for c, u in bad:
            nanm[c, u] = True
        errs1 = []
        for label, k, p in (("iA", iAk, iAp), ("LiA", LiAk, LiAp)):
            assert torch.isnan(k[nanm]).all() and torch.isnan(p[nanm]).all(),\
                f"B8d-1 {label}: planted indefinite blocks are not NaN"
            assert torch.isfinite(k[~nanm]).all(), f"B8d-1 {label}"
            # two float32 factorisations of an nf x nf block: against each
            # block's largest entry
            scale = p[~nanm].abs().amax(dim=(1, 2), keepdim=True)
            e = ((k[~nanm] - p[~nanm]).abs() / scale).max().item()
            assert e <= 1e-4, f"B8d-1 {label} np={n}: rel diff {e} > 1e-4"
            errs1.append(e)

        # B8d-2: the knot correction, on the kernel's iA of the PD blocks,
        # against the plain version (both sum in float64 and return H in
        # float64), to 1e-9 of each chain's largest |H| entry; at 3c's
        # shape the float32 sum (one torch.einsum on the grids rounded to
        # float32, as the JAX package forms H) must miss it
        iA, _ = tsp.gpp_unit(lvd, alpha, LiSL)
        Hk = tsp.gpp_knot(lvd, alpha, iA)
        Hp = tsp._gpp_knot_plain(lvd, alpha, iA)
        M1 = tsp.gpp_m1_at(lvd, alpha)
        M1f, iA64 = M1.float(), iA.double()
        Hf = -torch.einsum("chum,cuhg,cgun->chmgn", M1f, iA, M1f)
        for f in range(nf):
            Hf[:, f, :, f, :] += lvd.Fg[alpha[:, f].long()].float()
        Hs = Hp.abs().amax(dim=(1, 2), keepdim=True)
        e2 = ((Hk - Hp).abs() / Hs).max().item()
        e2f = ((Hf.reshape(Hp.shape).double() - Hp).abs() / Hs).max().item()
        assert Hk.dtype == torch.float64 and torch.isfinite(Hk).all(), \
            "B8d-2: H must be finite float64"
        assert e2 <= 1e-9, f"B8d-2 np={n}: diff / max|H| {e2} > 1e-9"
        at_3c = (C, n) == B8D_SHAPES[0][:2]
        assert e2f > 1e-9 or not at_3c, "B8d-2: the float32 H passes"
        assert torch.equal(Hk, tsp.gpp_knot(lvd, alpha, iA)), \
            "B8d-2: two runs differ"

        # B8d-3: grid and at-alpha quadratics (double sums, float32 out),
        # each to 1e-5 of the plain value plus 1e-12 of the sum of its
        # terms' magnitudes (the ones-form 1' iW eta may be near 0); at 3c's
        # shape the float32 grid form (the JAX package's) must miss it
        eta = torch.randn((C, n, nf), generator=g, device=dev)
        vk = tsp.gpp_quad_grid(lvd, eta)
        vp = tsp._gpp_quad_grid_plain(lvd, eta)
        ak = tsp.gpp_quad_at(lvd, alpha, eta)
        ap = tsp._gpp_quad_at_plain(lvd, alpha, eta)
        assert torch.isfinite(vk).all() and torch.isfinite(ak).all(), "B8d-3"
        ea = eta.abs()
        W32 = lvd.idDW12g.float()
        Ee = torch.einsum("cuh,gum->chgm", ea, W32)
        iFa = lvd.iFg.abs().float()
        mg = (torch.einsum("gu,cuh->chg", lvd.idDg, ea ** 2)
              + torch.einsum("chgm,gmn,chgn->chg", Ee, iFa, Ee))
        e3 = ((vk - vp).abs() / (1e-5 * vp.abs() + 1e-12 * mg)).max().item()
        e3f = ((_gpp_quad_grid_f32(torch, lvd, eta) - vp).abs()
               / (1e-5 * vp.abs() + 1e-12 * mg)).max().item()
        a_ = alpha.long()
        W12a = W32[a_]
        Eea = torch.einsum("cuh,chum->chm", ea, W12a)
        E1a = W12a.sum(dim=2)
        idDa, iFat = lvd.idDg[a_], iFa[a_]
        mags = torch.stack([
            torch.einsum("chu,cuh->ch", idDa, ea ** 2)
            + torch.einsum("chm,chmn,chn->ch", Eea, iFat, Eea),
            idDa.sum(dim=2) + torch.einsum("chm,chmn,chn->ch", E1a, iFat,
                                           E1a),
            torch.einsum("chu,cuh->ch", idDa, ea)
            + torch.einsum("chm,chmn,chn->ch", E1a, iFat, Eea)], dim=2)
        zero = tsp.gpp_alpha_zero(lvd, alpha)[..., None]
        mags = torch.where(zero, torch.stack(
            [(ea ** 2).sum(1), torch.full_like(ea[:, 0], float(n)),
             ea.sum(1)], dim=2), mags)
        e3a = ((ak - ap).abs() / (1e-5 * ap.abs() + 1e-12 * mags)).max(
        ).item()
        for label, e in (("grid", e3), ("at-alpha", e3a)):
            assert e <= 1.0, f"B8d-3 {label} np={n}: {e} x the tolerance"
        assert e3f > 1.0 or not at_3c, "B8d-3: the float32 form passes"
        assert torch.equal(vk, tsp.gpp_quad_grid(lvd, eta)) and torch.equal(
            ak, tsp.gpp_quad_at(lvd, alpha, eta)), "B8d-3: two runs differ"
        abs_err = dict(
            gpp_unit=max((iAk - iAp)[~nanm].abs().max().item(),
                         (LiAk - LiAp)[~nanm].abs().max().item()),
            gpp_knot=(Hk - Hp).abs().max().item(),
            gpp_quad=max((vk - vp).abs().max().item(),
                         (ak - ap).abs().max().item()))
        print(f"B8d check C={C} np={n} nK={nK} nf={nf}, alpha indices "
              f"{sorted(set(alpha.flatten().tolist()))}: B8d-1 max |kernel -"
              f" plain| / block max {errs1[0]:.3g} (iA), {errs1[1]:.3g} "
              f"(LiA) (1e-4), planted indefinite blocks NaN; B8d-2 "
              f"{e2:.3g} of max|H| (1e-9; float32 H {e2f:.3g}); B8d-3 "
              f"{e3:.3g} (grid), {e3a:.3g} (at-alpha) of 1e-5 |v| + 1e-12 "
              f"of the terms' magnitudes (float32 grid form {e3f:.3g}); "
              f"B8d-2 and B8d-3 two runs bit-identical")
        if (C, n) != B8D_SHAPES[0][:2]:
            continue
        check_gpp_draw(torch, tsp, dev, lvd, lp, LiSL, g, card)

        def unit():
            tsp.gpp_unit(lvd, alpha, LiSL)

        def unit_plain():
            tsp._gpp_unit_plain(lvd, alpha, LiSL)

        def knot():
            tsp.gpp_knot(lvd, alpha, iA)

        def knot_plain():
            tsp._gpp_knot_plain(lvd, alpha, iA)

        def knot_library():
            torch.einsum("chum,cuhg,cgun->chmgn", M1f, iA, M1f)

        def knot_library64():
            torch.einsum("chum,cuhg,cgun->chmgn", M1, iA64, M1)

        def grid():
            tsp.gpp_quad_grid(lvd, eta)

        def grid_plain():
            tsp._gpp_quad_grid_plain(lvd, eta)

        def at():
            tsp.gpp_quad_at(lvd, alpha, eta)

        def at_plain():
            tsp._gpp_quad_at_plain(lvd, alpha, eta)

        G = lvd.idDg.shape[0]
        used = _gpp_used_bytes(lvd, alpha)
        t = {}
        for name, kern, plain, match in (
                ("gpp_unit", unit, unit_plain, ("gpp_unit_kernel",)),
                ("gpp_knot", knot, knot_plain,
                 ("gpp_knot_partial_kernel", "gpp_knot_sum_kernel")),
                ("gpp_quad", grid, grid_plain,
                 ("gpp_quad_grid_partial_kernel",
                  "gpp_quad_grid_final_kernel"))):
            ms_parts = [device_ms(torch, kern, m) for m in match]
            t[name] = dict(
                ms=sum(ms_parts), parts_ms=ms_parts,
                plain_ms=device_ms(torch, plain, calls=10),
                event_ms=event_ms(torch, kern),
                plain_event_ms=event_ms(torch, plain, batch=5),
                held_ms=held_event_ms(torch, kern))
        # bytes: LiSL in, iA and LiA out, the idD slices in use; operations:
        # two nf^3/3 factorisations, the nf^3/3 inverse and nf^3/3 product
        b1 = bound_ms(4.0 * C * n * 3 * nf * nf + 4.0 * int(
            alpha.unique().numel()) * n, C * n * (4 * nf ** 3 / 3))
        # bytes: the M1 slices and F in use (float64), iA in, H out (float64);
        # operations: 2 a (unit, entry of H's lower triangle), M1 iA
        # hoisted and H symmetric (67 TFLOP/s is also float64's tensor-core
        # rate)
        b2 = bound_ms(used + 4.0 * C * n * nf * nf + 8.0 * C * (nf * nK) ** 2,
                      C * n * (nf * nK) * (nf * nK + 1.0))
        # grid mode: the idD, (float64) idD W12 and iF slices of the grid
        # points off alpha 0 (the kernel reads no slice where W = I) once,
        # eta in, C nf G out; operations per (column, grid point): 2 np nK
        # (Et), 3 nK^2, 3 np
        Gk = int((lvd.alphapw[:, 0] != 0).sum().item())
        b3 = bound_ms(4.0 * (Gk * n + C * n * nf + C * nf * G)
                      + 8.0 * Gk * (n * nK + nK * nK),
                      C * nf * Gk * (2.0 * n * nK + 3.0 * nK * nK + 3.0 * n))
        t["gpp_knot"]["library_ms"] = device_ms(torch, knot_library, calls=10)
        t["gpp_knot"]["library64_ms"] = device_ms(torch, knot_library64,
                                                  calls=10)
        t["gpp_unit"]["library_ms"] = t["gpp_quad"]["library_ms"] = None
        at_parts = [device_ms(torch, at, m) for m in (
            "gpp_quad_at_partial_kernel", "gpp_quad_at_final_kernel")]
        at_ms = sum(at_parts)
        at_plain_ms = device_ms(torch, at_plain, calls=10)
        # at alpha: the float64 slices at the distinct alpha indices off 0
        # once (the kernel reads none where W = I), eta in, (q, q1, s) out;
        # operations per column off alpha 0
        cols = int((~tsp.gpp_alpha_zero(lvd, alpha)).sum().item())
        b_at = bound_ms(_gpp_used_bytes(lvd, alpha, skip_zero=True)
                        + 4.0 * (C * n * nf + 3 * C * nf),
                        cols * (4.0 * n * nK + 9.0 * nK * nK + 5.0 * n))
        for name, (bb, by) in (("gpp_unit", b1), ("gpp_knot", b2),
                               ("gpp_quad", b3)):
            t[name].update(bound_ms=bb, bound_by=by,
                           max_abs_err=abs_err[name], shape=[C, n, nK, nf])
        t["gpp_quad"].update(at_ms=at_ms, at_parts_ms=at_parts,
                             at_plain_ms=at_plain_ms, at_bound_ms=b_at[0],
                             at_bound_by=b_at[1])
        for name, label in (("gpp_unit", "B8d-1 gpp_unit"),
                            ("gpp_knot", "B8d-2 gpp_knot"),
                            ("gpp_quad", "B8d-3 gpp_quad grid")):
            r = t[name]
            lib = ("" if r["library_ms"] is None else
                   f", one float32 torch.einsum of the weighted gram "
                   f"{r['library_ms']:.4f} ms, float64 "
                   f"{r['library64_ms']:.4f} ms")
            parts = " + ".join(f"{x:.5f}" for x in r["parts_ms"])
            print(f"{label} device time at C {C}, np {n}, nK {nK}, nf {nf}: "
                  f"{r['ms']:.5f} ms ({parts}; plain "
                  f"{r['plain_ms']:.4f} ms{lib}, bound {r['bound_ms']:.6f} "
                  f"ms by {r['bound_by']}; held stream {r['held_ms']:.5f} "
                  f"ms, with enqueue {r['event_ms']:.4f} ms, plain "
                  f"{r['plain_event_ms']:.4f} ms) [{card}]")
        print(f"B8d-3 gpp_quad at-alpha device time: {at_ms:.5f} ms "
              f"({' + '.join(f'{x:.5f}' for x in at_parts)}; plain "
              f"{at_plain_ms:.4f} ms, bound {b_at[0]:.6f} ms by {b_at[1]}) "
              f"[{card}]")
        res = t
    return res


def da_inputs(torch, dev, C, ny, ns, seed, na=0.0):
    """Z consistent with the signs of Y (as update_z leaves it), a random
    Beta, iV and prior term, every fifth column not probit; planted: an
    all-one column (no upper bound), an all-zero one (no lower bound), and
    prior means past 9 sigma above and below the interval."""
    g = torch.Generator(device=dev).manual_seed(seed)
    Y = (torch.rand((ny, ns), generator=g, device=dev) < 0.5).float()
    Y[:, 0], Y[:, 1] = 1.0, 0.0
    mask = None
    if na:
        mask = (torch.rand((ny, ns), generator=g, device=dev) >= na).float()
        mask[:, 2] = 0.0                         # a column with no data
    nc = 2
    Beta = torch.randn((C, nc, ns), generator=g, device=dev)
    E = Beta[:, 0][:, None] + torch.randn((C, ny, ns), generator=g,
                                          device=dev)
    Z = torch.where(Y > 0.5, E.abs(), -E.abs()) + 1e-3 * torch.where(
        Y > 0.5, 1.0, -1.0)
    Z = Z.contiguous()
    fam = torch.full((ns,), 2, dtype=torch.int32, device=dev)
    fam[4::5] = 1
    v00 = torch.rand((C,), generator=g, device=dev) * 2.0 + 0.5
    up = torch.randn((C, ns), generator=g, device=dev)
    up[:, 3] = 1e3 * v00                         # mean far below the interval
    up[:, 6] = -1e3 * v00                        # mean far above it
    return Z, Y, mask, fam, Beta.contiguous(), up.contiguous(), v00


def _b7_quantile_slack(torch, a, b, u, prob):
    """Per (chain, species), in sd units: 8 float32 ulps of the survival
    probability s of the JAX op's inverse-CDF branch times the quantile's
    slope 1 / phi(ndtri(s)) (float64 on the host; 0 on the far-tail branch
    and on non-probit columns)."""
    from scipy.special import ndtr, ndtri

    a, b, u = (x.double().cpu().numpy() for x in (a, b, u))
    with np.errstate(invalid="ignore", over="ignore"):
        right = (a + np.clip(b, -1e30, 1e30)) > 0
        right = np.where(np.isinf(b), a > 0, right)
        right = np.where(np.isinf(a), b > 0, right)
        a2, b2 = np.where(right, a, -b), np.where(right, b, -a)
        sa, sb = ndtr(-a2), ndtr(-b2)
        s = np.clip(sb + u * (sa - sb), 1e-30, 1 - 2.0 ** -24)
        x = ndtri(s)
        slack = 8 * 2.0 ** -23 * s * np.sqrt(2 * np.pi) * np.exp(x * x / 2)
    slack = np.where((a2 > 9.0) | ~prob.cpu().numpy()[None], 0.0, slack)
    return torch.tensor(slack, dtype=torch.float32, device=prob.device)


def check_b7(torch, trand, dev, card):
    """B7 against its plain version with injected uniforms (one- and
    two-sided intervals, infinite bounds, |a| > 9, u = 1e-38 and u one ulp
    below 1; without and with NA cells), then with its own Philox by the
    probability integral transform (KS)."""
    from scipy import stats

    C, ny, ns = DA_HEADLINE["n_chains"], DA_HEADLINE["ny"], \
        DA_HEADLINE["ns"]
    worst = 0.0
    for na in (0.0, 0.1):
        Z, Y, mask, fam, Beta, up, v00 = da_inputs(torch, dev, C, ny, ns,
                                                   seed=21, na=na)
        g = torch.Generator(device=dev).manual_seed(22)
        u = torch.rand((C, ns), generator=g, device=dev).clamp_min_(1e-38)
        u[0, :8] = 1e-38
        u[1, :8] = 1.0 - 2.0 ** -24
        tk, Zk = trand.da_intercept_draw(Z, Y, mask, fam, Beta, 0, up, v00,
                                         u=u)
        tp, Zp = trand._da_intercept_draw_plain(Z, Y, mask, fam, Beta, 0,
                                                up, v00, u)
        sd = v00[:, None] ** -0.5
        prob = fam == 2
        assert torch.isfinite(tk).all() and torch.isfinite(Zk).all(), "B7"
        assert torch.equal(tk[:, ~prob], Beta[:, 0, ~prob]) and torch.equal(
            Zk[..., ~prob], Z[..., ~prob]), "B7: a non-probit column changed"
        # the planted interval kinds happened
        negR = -(Z - Beta[:, 0][:, None])
        obs = torch.ones_like(Y) if mask is None else mask
        lo = torch.where((Y > 0.5) & (obs > 0), negR, -math.inf).amax(1)
        hi = torch.where((Y <= 0.5) & (obs > 0), negR, math.inf).amin(1)
        mean = Beta[:, 0] - up / v00[:, None]
        a, b = (lo - mean) / sd, (hi - mean) / sd
        assert torch.isinf(hi[:, 0]).all() and torch.isinf(lo[:, 1]).all()
        assert (a[:, 3] > 9).all() and (b[:, 6] < -9).all()
        # t to 1e-4 sd, plus 8 float32 ulps of the survival probability s
        # carried through the inverse CDF's slope 1 / phi(x): at u one ulp
        # below 1 on a half-open interval s sits at 1 - 2^-24, where one
        # ulp of s moves the draw by ~0.1 sd (float32 ndtr and rounding
        # differ between the kernel and PyTorch's elementwise ops there)
        allow = 1e-4 + _b7_quantile_slack(torch, a, b, u, prob)
        e = (tk - tp).abs() / sd
        e_t = (e / allow).max().item()
        # Z = R + t: the same difference, up to Z's own rounding
        e_z = ((Zk - Zp - (tk - tp)[:, None]).abs()
               / (1.0 + Zp.abs())).max().item()
        assert e_t <= 1.0 and e_z <= 1e-5, \
            f"B7 na={na}: t {e_t} of its tolerance, Z {e_z} > 1e-5"
        worst = max(worst, (tk - tp).abs().max().item())
        print(f"B7 check {C}x{ny}x{ns}, {na:.0%} NA: max |kernel - plain| / "
              f"sd {e.max().item():.3g} (t; at most {e_t:.3g} of 1e-4 + 8 "
              f"ulps of s through the quantile's slope), Z - t shift "
              f"{e_z:.3g} (1e-5); infinite bounds, |a| > 9 on both sides, u "
              f"= 1e-38 and 1 - 2^-24 covered; non-probit columns unchanged")
    # its own Philox: the draws' probability integral transform is uniform
    Z, Y, mask, fam, Beta, up, v00 = da_inputs(torch, dev, C, ny, ns,
                                               seed=23)
    up[:, 3], up[:, 6] = 0.0, 0.0
    rng = trand.Rng(24, dev)
    draws = torch.stack([trand.da_intercept_draw(Z, Y, None, fam, Beta, 0,
                                                 up, v00, rng)[0]
                         for _ in range(25)])
    negR = -(Z - Beta[:, 0][:, None])
    lo = torch.where(Y > 0.5, negR, -math.inf).amax(1)
    hi = torch.where(Y <= 0.5, negR, math.inf).amin(1)
    mean = Beta[:, 0] - up / v00[:, None]
    sd = v00[:, None] ** -0.5
    keep = (fam == 2).expand(C, ns)
    z = ((draws - mean) / sd)[:, keep].double().cpu().numpy()
    aa = ((lo - mean) / sd)[keep].double().cpu().numpy()
    bb = ((hi - mean) / sd)[keep].double().cpu().numpy()
    pit = stats.truncnorm.cdf(z, aa[None], bb[None]).ravel()
    p = stats.kstest(pit, "uniform").pvalue
    assert p > 1e-3, f"B7 Philox: KS p {p} <= 1e-3"
    print(f"B7 check: in-kernel Philox, {pit.size} draws: probability "
          f"integral transform KS p {p:.3g} (> 1e-3)")

    Z, Y, mask, fam, Beta, up, v00 = da_inputs(torch, dev, C, ny, ns,
                                               seed=25)

    def kern():
        trand.da_intercept_draw(Z, Y, None, fam, Beta, 0, up, v00, rng)

    def plain():
        trand._da_intercept_draw_plain(Z, Y, None, fam, Beta, 0, up, v00,
                                       rng.uniform((C, ns)))

    ms = device_ms(torch, kern, "truncnorm_da_kernel")
    plain_ms = device_ms(torch, plain, calls=10)
    ev, plain_ev = event_ms(torch, kern), event_ms(torch, plain, batch=5)
    held = held_event_ms(torch, kern)
    cells = C * ny * ns
    # bytes: Z and Y read once, Z written once, the per-species terms;
    # operations: ~4 a cell (the residual, its sign, the extremum) and ~2
    # a cell for the shift, ~150 a draw
    b, by = bound_ms(4.0 * (2 * cells + ny * ns + 4 * C * ns + ns),
                     6.0 * cells + 150.0 * C * ns)
    print(f"B7 truncnorm_da device time: {ms:.4f} ms (plain {plain_ms:.4f} "
          f"ms, bound {b:.4f} ms by {by}; held stream {held:.5f} ms, with "
          f"enqueue {ev:.4f} ms, plain {plain_ev:.4f} ms) at Z "
          f"{C}x{ny}x{ns} [{card}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, event_ms=ev,
                plain_event_ms=plain_ev, held_ms=held, shape=[C, ny, ns])


# ---------------------------------------------------------------------------
# the serving kernels B9a-c, at the headline posterior's shapes
# ---------------------------------------------------------------------------

# the headline's posterior as the serving engine stages it: 4 chains x 200
# samples, nc 2, nf_max 8, 1000 units (+ the mean-field zero row), 1000
# species; query blocks of 1 and 64 rows (the largest bucket)
SERVE = dict(n=800, nc=2, nf=8, ns=1000, units=1000)
SERVE_Q = (0.05, 0.5, 0.95)
# the serve path's timed 64-row quantile queries (p50 and p99)
QUANTILE_QUERIES = 20


def serve_inputs(torch, dev, B, seed, dtype=None, fam=None, sig=None,
                 nf=None):
    """A synthetic posterior at the headline's shapes (``nf`` factors if
    given) and a query block: (X, uidx, Beta, sigma, [Lambda], [Eta], fam,
    ym, ys)."""
    s = SERVE
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(device=dev, dtype=torch.float32)
    n, nc, ns = s["n"], s["nc"], s["ns"]
    nf = s["nf"] if nf is None else nf
    Beta = 0.7 * torch.randn((n, nc, ns), generator=g, **f32)
    sigma = torch.ones((n, ns), **f32) if sig is None else sig
    lam = 0.4 * torch.randn((n, nf, ns), generator=g, **f32)
    eta = torch.randn((n, s["units"] + 1, nf), generator=g, **f32)
    eta[:, -1] = 0.0
    X = torch.cat([torch.ones((B, 1), **f32),
                   torch.randn((B, nc - 1), generator=g, **f32)], dim=1)
    uidx = torch.randint(0, s["units"] + 1, (1, B), generator=g, device=dev,
                         dtype=torch.int32)
    if fam is None:
        fam = torch.full((ns,), 2, device=dev, dtype=torch.int32)
    ym = torch.zeros((ns,), **f32)
    ys = torch.ones((ns,), **f32)
    if dtype is not None:
        Beta, sigma, lam, eta = (t.to(dtype) for t in (Beta, sigma, lam,
                                                       eta))
    return X, uidx, Beta, sigma, [lam], [eta], fam, ym, ys


def binomial_inside(sampled, expected, n, tail=1e-9):
    """Whether every sampled 0 / 1 mean over ``n`` draws, as a count,
    lies within the ``tail`` quantiles of Binomial(n, expected mean)."""
    from scipy import stats

    p = np.clip(np.asarray(expected, np.float64), 0.0, 1.0)
    count = np.rint(np.asarray(sampled, np.float64) * n)
    return bool(np.all((count >= stats.binom.ppf(tail, n, p))
                       & (count <= stats.binom.isf(tail, n, p))))


def _plain_moments(torch, tserve, args, expected, gen=None):
    y = tserve._serve_predict_plain(*args, expected, gen)
    return y.mean(dim=0), y.std(dim=0, correction=0), y


def _kernel_ms(torch, fn, names):
    """Device time of a wrapper that launches several kernels: the sum of
    each kernel's time per launch."""
    return sum(device_ms(torch, fn, name) for name in names)


def b9a_bound(n, B, ns, nc, nf, nbytes_draw=4, moments=True, draws=False):
    """Bytes: the draws of Beta, sigma and Lambda, the Eta rows the block
    gathers, X and uidx read once, mean and sd written once when
    ``moments``, the (n, B, ns) float32 draws written once when ``draws``;
    operations: the linear predictor's 2 (nc + nf) B ns n multiply-adds.
    Returns (bound ms, "bytes" or "operations", bytes ms, operations ms)."""
    nbytes = (nbytes_draw * n * (nc * ns + ns + nf * ns + B * nf)
              + 4 * (B * nc + B) + (4 * 2 * B * ns if moments else 0)
              + (4 * n * B * ns if draws else 0))
    ops = 2.0 * (nc + nf) * B * ns * n
    b, by = bound_ms(nbytes, ops)
    return b, by, nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3


# the B9a instance whose SASS gives the issue-rate floor: float32 draws, 8
# rows a warp (B 64), expected
B9A_SASS = "serve_predict_kernelIfLi8ELb1E"


def cuobjdump():
    """The CUDA toolkit's cuobjdump, or the copy Triton's package carries,
    or None."""
    import os
    import shutil

    cands = [shutil.which("cuobjdump") or "", "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if c and os.path.exists(c)), None)


def _sass(lib_path):
    """``cuobjdump -sass`` of the built library, or None without the tool."""
    tool = cuobjdump()
    if tool is None:
        return None
    r = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                       text=True, timeout=600)
    return r.stdout if r.returncode == 0 else None


def sass_cell_instructions(sass, name, kl, cells_a_pass):
    """Instructions a B9a cell issues, read from the SASS of kernel
    ``name``: the per-draw loop (the largest loop holding both a cp.async,
    LDGSTS, and a special-function op, MUFU), less its nested staging
    loops (those holding LDGSTS) and the Poisson link's block, with its
    nested multiply-add loop counted ceil(kl / 4) times (its trip count),
    over the ``cells_a_pass`` cells a thread computes a draw: a probit
    cell's instructions, counted statically (the identity link's few and
    the branches around the links are in it).  Returns (per cell, the
    loop's details) or None."""
    import re

    lines = sass.splitlines()
    start = next((i for i, ln in enumerate(lines)
                  if "Function :" in ln and name in ln), None)
    if start is None:
        return None
    end = next((i for i in range(start + 1, len(lines))
                if "Function :" in lines[i]), len(lines))
    ins, at = [], {}
    for ln in lines[start + 1:end]:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if not m:
            continue
        at[int(m.group(1), 16)] = len(ins)
        words = m.group(2).split()
        ins.append((words[1] if words[0].startswith("@") and len(words) > 1
                    else words[0], m.group(2)))
    loops = []
    for i, (op, text) in enumerate(ins):
        m = re.search(r"BRA\S*\s+(?:`\()?(0x[0-9a-f]+)", text)
        if op.startswith("BRA") and m and at.get(int(m.group(1), 16),
                                                 i + 1) <= i:
            loops.append((at[int(m.group(1), 16)], i))

    def has(lp, prefix):
        return any(ins[k][0].startswith(prefix)
                   for k in range(lp[0], lp[1] + 1))

    main = [lp for lp in loops if has(lp, "MUFU") and has(lp, "LDGSTS")]
    if not main:
        return None
    top = max(main, key=lambda lp: lp[1] - lp[0])
    inner = [lp for lp in loops if lp != top and top[0] <= lp[0]
             and lp[1] <= top[1]]
    inner = [a for a in inner if not any(
        b != a and b[0] <= a[0] and a[1] <= b[1] for b in inner)]
    body = top[1] - top[0] + 1
    staging = sum(b - a + 1 for a, b in inner if has((a, b), "LDGSTS"))
    fma = sum(b - a + 1 for a, b in inner
              if not has((a, b), "LDGSTS") and has((a, b), "FFMA"))
    # the Poisson link's straight-line block (exp: MUFU.EX2 and no
    # MUFU.RCP, which ndtr's erfc has) runs instead of ndtr's
    targets = (re.search(r"BRA\S*\s+(?:`\()?(0x[0-9a-f]+)", t)
               for _, t in ins[top[0]:top[1]])
    cuts = sorted({top[0], top[1] + 1}
                  | {at[int(m.group(1), 16)] for m in targets
                     if m and int(m.group(1), 16) in at}
                  | {k + 1 for k in range(top[0], top[1] + 1)
                     if ins[k][0].startswith(("BRA", "CALL", "EXIT"))})
    blocks = [(a, b - 1) for a, b in zip(cuts, cuts[1:]) if top[0] <= a < b
              and b - 1 <= top[1]]
    poisson = sum(b - a + 1 for a, b in blocks
                  if has((a, b), "MUFU.EX2") and not has((a, b), "MUFU.RCP"))
    total = body - staging - poisson + fma * (-(-kl // 4) - 1)
    return total / cells_a_pass, dict(loop=body, staging=staging,
                                      poisson=poisson, fma_loop=fma,
                                      trips=-(-kl // 4))


def sm_clock_hz():
    """The card's maximum SM clock (nvidia-smi), in Hz."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60, check=True)
    return float(r.stdout.strip().splitlines()[0]) * 1e6


def b9a_issue_floor(torch, K, B):
    """B9a's issue-rate floor at the headline's shapes and B rows: the
    per-cell instruction count from the SASS of the built library times
    the cells, over the card's issue rate (4 warp instructions a clock on
    each SM, 32 threads each, at the maximum SM clock).  None where the
    toolkit has no cuobjdump."""
    sass = _sass(K.library()._name)
    if sass is None:
        return None
    got = sass_cell_instructions(sass, B9A_SASS, SERVE["nc"] + SERVE["nf"],
                                 8 * 2)
    if got is None:
        return None
    per_cell, parts = got
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * 4 * 32 * sm_clock_hz()
    cells = SERVE["n"] * B * SERVE["ns"]
    return dict(per_cell=per_cell, ms=per_cell * cells / rate * 1e3,
                sms=sms, **parts)


# query rows at which B9a's checks run: one size for each launch geometry
# the serving buckets (1-64 rows) and offline chunks give it at the serve
# shapes (ops/serve.py · predict_geometry: row tiles of 1, 2, 4, 8, 16, 32
# and 64 rows, the warps left over on draw slots), the padded sizes 3, 13
# and 27, and 100 rows in two row tiles
B9A_CHECK_ROWS = (1, 2, 3, 8, 13, 27, 64, 100)


def check_b9a(torch, tserve, K, dev, card):
    """B9a against its plain version: expected moments and draws at every
    row count of ``B9A_CHECK_ROWS``, float32 and bfloat16 draws, to 1e-5; a
    normal / probit / Poisson mix to 1e-5 of max(1, |plain|); two runs
    bit-identical at B 13 and 64; sampled probit means within the 1e-9
    binomial tails of the expected ones; sampled normal draws by KS against
    their law and Poisson draws by KS against the plain sampler's (rates
    0.5, 5, 50, 5000)."""
    from scipy import stats

    worst = 0.0
    for B in B9A_CHECK_ROWS:
        for dt in (torch.float32, torch.bfloat16):
            args = serve_inputs(torch, dev, B, seed=20 + B, dtype=dt)
            mk, sk, yk = tserve.serve_predict(*args, expected=True,
                                              draws=True)
            mp, sp, yp = _plain_moments(torch, tserve, args, True)
            err = max((mk - mp).abs().max().item(),
                      (sk - sp).abs().max().item(),
                      (yk - yp).abs().max().item())
            assert err <= 1e-5, f"B9a expected B {B} {dt}: {err} > 1e-5"
            worst = max(worst, err)
            geo = tserve.predict_geometry(SERVE["n"], B, SERVE["ns"],
                                          SERVE["nc"], SERVE["nf"],
                                          dt == torch.bfloat16)
            print(f"B9a check: expected, B {B} ({geo}), {dt}: max |kernel "
                  f"- plain| over mean, sd and draws = {err:.3g} "
                  "(tolerance 1e-5)")
    ns = SERVE["ns"]
    fam = torch.tensor([1, 2, 3], device=dev, dtype=torch.int32).repeat(
        ns // 3 + 1)[:ns].contiguous()
    g = torch.Generator(device=dev).manual_seed(7)
    sig = 0.1 + 0.9 * torch.rand((SERVE["n"], ns), generator=g, device=dev)
    args = serve_inputs(torch, dev, 64, seed=31, fam=fam, sig=sig)
    mk, sk, _ = tserve.serve_predict(*args, expected=True)
    mp, sp, _ = _plain_moments(torch, tserve, args, True)
    err = max(((mk - mp).abs() / mp.abs().clamp_min(1.0)).max().item(),
              ((sk - sp).abs() / sp.abs().clamp_min(1.0)).max().item())
    assert err <= 1e-5, f"B9a family mix: {err} > 1e-5"
    print(f"B9a check: normal / probit / Poisson columns, expected: max "
          f"|kernel - plain| / max(1, |plain|) = {err:.3g} (tolerance 1e-5)")
    for B in (13, 64):
        args = serve_inputs(torch, dev, B, seed=84)
        m1, s1, _ = tserve.serve_predict(*args, expected=True)
        m2, s2, _ = tserve.serve_predict(*args, expected=True)
        assert torch.equal(m1, m2) and torch.equal(s1, s2), \
            f"B9a B {B}: two runs differ"
    ms_, _, _ = tserve.serve_predict(*args, expected=False, seed=5,
                                     offset=9)
    assert binomial_inside(ms_.cpu().numpy(), m1.cpu().numpy(),
                           SERVE["n"]), "B9a sampled probit: a mean beyond " \
        "the binomial 1e-9 tails"
    print("B9a check: two runs bit-identical (B 13, 64); sampled probit "
          "means within the 1e-9 tails of Binomial(n, expected mean)")
    # sampled draws at a constant linear predictor per column (Lambda 0,
    # X = [1, 0]): Poisson columns at rates 0.5, 5, 50, 5000 (sigma 1e-8),
    # normal columns N(0.3, 2.0)
    rates = (0.5, 5.0, 50.0, 5000.0)
    X, uidx, Beta, sigma, lams, etas, _, ym, ys = serve_inputs(
        torch, dev, 64, seed=3)
    fam = torch.tensor([3, 3, 3, 3, 1, 1], device=dev, dtype=torch.int32)
    mu = torch.tensor([math.log(r) for r in rates] + [0.3, 0.3], device=dev)
    k = fam.numel()
    Beta = torch.zeros_like(Beta[:, :, :k])
    Beta[:, 0, :] = mu
    sigma = torch.full_like(sigma[:, :k], 1e-8)
    sigma[:, 4:] = 2.0
    X = X.clone()
    X[:, 1] = 0.0
    lams = [torch.zeros_like(lams[0][:, :, :k])]
    args = (X, uidx, Beta, sigma, lams, etas, fam, ym[:k].contiguous(),
            ys[:k].contiguous())
    _, _, yk = tserve.serve_predict(*args, expected=False, moments=False,
                                    draws=True, seed=11, offset=2)
    gen = torch.Generator().manual_seed(11)
    yp = tserve._serve_predict_plain(*[a.cpu() if torch.is_tensor(a) else
                                       [t.cpu() for t in a] for a in args],
                                     False, gen)
    yk = yk.reshape(-1, k).cpu().double().numpy()
    yp = yp.reshape(-1, k).double().numpy()
    for c, r in enumerate(rates):
        p = stats.ks_2samp(yk[:, c], yp[:, c]).pvalue
        se_r = math.sqrt(r / yk.shape[0])
        assert p > 1e-4 and abs(yk[:, c].mean() - r) < 6 * se_r, \
            f"B9a Poisson rate {r}: KS p {p}, mean {yk[:, c].mean()}"
        print(f"B9a check: sampled Poisson at rate {r}: KS p = {p:.3g} "
              f"against the plain sampler, mean {yk[:, c].mean():.4f}")
    for c in (4, 5):
        p = stats.kstest(yk[:, c], stats.norm(0.3, math.sqrt(2.0)).cdf
                         ).pvalue
        assert p > 1e-4, f"B9a sampled normal: KS p {p}"
        print(f"B9a check: sampled normal column {c}: KS p = {p:.3g} "
              "against N(0.3, 2)")

    times = {}
    for B in (64, 1):
        args = serve_inputs(torch, dev, B, seed=40 + B)
        for expected in (True, False):
            def kern():
                tserve.serve_predict(*args, expected=expected)

            def kern_draws():
                tserve.serve_predict(*args, expected=expected,
                                     moments=False, draws=True)
            mom = _kernel_ms(torch, kern, ("serve_predict_kernel",
                                           "combine_moments_kernel"))
            drw = device_ms(torch, kern_draws, "serve_predict_kernel")
            times[(B, expected)] = (mom, drw)
            print(f"B9a serve_predict device time, B {B}, "
                  f"{'expected' if expected else 'sampled'}: moments "
                  f"{mom:.4f} ms, draws mode {drw:.4f} ms [{card}]")
    args = serve_inputs(torch, dev, 64, seed=104)
    X, uidx, Beta, sigma, lams, etas = args[:6]

    def kern():
        tserve.serve_predict(*args, expected=True)

    def plain():
        y = tserve._serve_predict_plain(*args, True, None)
        y.mean(dim=0), y.std(dim=0, correction=0)

    rows = etas[0][:, uidx[0].long(), :]

    def library():
        torch.einsum("yc,ncj->nyj", X, Beta) + torch.einsum(
            "nyf,nfj->nyj", rows, lams[0])

    ms = times[(64, True)][0]
    plain_ms = device_ms(torch, plain, calls=10)
    lib_ms = device_ms(torch, library, calls=10)
    ev, plain_ev = event_ms(torch, kern), event_ms(torch, plain, batch=5)
    held = held_event_ms(torch, kern)
    shape = (SERVE["n"], 64, SERVE["ns"], SERVE["nc"], SERVE["nf"])
    b, by, b_bytes, b_ops = b9a_bound(*shape)
    bd, byd, _, _ = b9a_bound(*shape, moments=False, draws=True)
    b1, by1, _, _ = b9a_bound(SERVE["n"], 1, *shape[2:])
    floor = b9a_issue_floor(torch, K, 64)
    fl = ("not measured (no cuobjdump)" if floor is None else
          f"{floor['ms']:.4f} ms ({floor['per_cell']:.1f} instructions a "
          f"cell from the SASS: a per-draw loop of {floor['loop']}, less "
          f"staging {floor['staging']} and the Poisson link "
          f"{floor['poisson']}, multiply-add loop {floor['fma_loop']} x "
          f"{floor['trips']}; 16 cells a thread; {floor['sms']} SMs at the "
          f"maximum SM clock)")
    print(f"B9a serve_predict device time: {ms:.4f} ms (plain {plain_ms:.4f} "
          f"ms, the einsum pair forming L {lib_ms:.4f} ms, bound {b:.4f} ms "
          f"by {by}: FMA {b_ops:.4f} ms, bytes {b_bytes:.4f} ms; issue-rate "
          f"floor {fl}; draws mode {times[(64, True)][1]:.4f} ms, bound "
          f"{bd:.4f} ms by {byd}; sampled {times[(64, False)][0]:.4f} ms; "
          f"B 1: {times[(1, True)][0]:.4f} ms, bound {b1:.5f} ms by {by1}; "
          f"held stream {held:.5f} ms, with enqueue {ev:.4f} ms, plain "
          f"{plain_ev:.4f} ms) at B 64, {SERVE['n']} draws x {SERVE['ns']} "
          f"species, expected moments [{card}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, bound_bytes_ms=b_bytes, bound_ops_ms=b_ops,
                issue_floor_ms=None if floor is None else floor["ms"],
                issue_per_cell=None if floor is None else floor["per_cell"],
                library_ms=lib_ms, event_ms=ev,
                plain_event_ms=plain_ev, held_ms=held,
                ms_b1=times[(1, True)][0], bound_ms_b1=b1,
                ms_sampled=times[(64, False)][0],
                ms_draws=times[(64, True)][1], bound_ms_draws=bd,
                ms_b1_draws=times[(1, True)][1],
                ms_b1_sampled=times[(1, False)][0],
                ms_b1_sampled_draws=times[(1, False)][1],
                shape=[SERVE["n"], 64, SERVE["ns"]])


def first_b9c(torch, lib, y, q):
    """B9c's first version on the card (``scripts/older/serve_quantile.cu``,
    a bitonic sort of each column in shared memory, at most 32768 draws):
    (nq, ...) quantiles."""
    import ctypes

    n, cols = y.shape[0], y[0].numel()
    P = 1 << max(0, (n - 1).bit_length())
    cpb = 8
    while cpb > 1 and P * cpb * 4 > 48 * 1024:
        cpb //= 2
    fn = lib.hmsc_serve_quantile
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = torch.empty((q.numel(),) + tuple(y.shape[1:]), device=y.device)
    code = fn(y.data_ptr(), cols, n, P, cpb, q.data_ptr(), q.numel(),
              out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"B9c first version: cudaError {code}"
    return out


def b9c_specials(torch, dev, n, B, ns, seed):
    """(n, B, ns) draws on the card: a wide normal law, and where B ns
    allows a constant column, one of a few repeated values, one of 0 / 1
    (sampled probit draws), one with +-inf, one with -0.0 beside +0.0 and
    one with a NaN."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = 30.0 * torch.randn((n, B * ns), generator=g, device=dev)
    if B * ns >= 7:
        w[:, 0] = 1.0
        w[:, 1] = torch.randint(-3, 4, (n,), generator=g, device=dev) * 0.5
        w[:, 2] = torch.randint(0, 2, (n,), generator=g, device=dev).float()
        w[: max(1, n // 3), 3] = float("inf")
        w[n // 2:, 3] = float("-inf")
        zero = torch.rand(n, generator=g, device=dev) < 0.5
        sign = torch.rand(n, generator=g, device=dev) < 0.5
        w[:, 4] = torch.where(zero, torch.where(sign, -0.0, 0.0), w[:, 4])
        w[n // 2, 5] = float("nan")
    return w.reshape(n, B, ns).contiguous()


def _b9c_equal(a, b):
    """Equal values (-0.0 as +0.0, NaN where NaN)."""
    import torch

    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def check_b9c(torch, tserve, dev, card):
    """B9c against its plain version, exact (a sort, ``jnp.quantile``'s
    arithmetic), and torch.quantile (1e-6) on B9a's expected draws at B
    64; exact on wide laws with ties, +-inf, -0.0 beside +0.0 and a NaN
    column at 1, 2, 37, 1025 and 40000 draws, at B 1, and at 40
    quantiles (two launches); a rerun gives the same bits.  Timed beside
    its first version (``scripts/older/serve_quantile.cu``, built here) at
    the headline posterior's 800 draws and at 37 and 1025."""
    q = torch.tensor(SERVE_Q, device=dev)
    first = build_source("scripts/older/serve_quantile.cu",
                         "serve_quantile_first")
    args = serve_inputs(torch, dev, 64, seed=52)
    _, _, y = tserve.serve_predict(*args, expected=True, moments=False,
                                   draws=True)
    qk = tserve.draw_quantiles(y, q)
    qp = tserve._draw_quantiles_plain(y, q)
    ql = torch.quantile(y, q, dim=0)
    assert _b9c_equal(qk, qp), "B9c: kernel != plain"
    assert torch_equal_bits(qk, tserve.draw_quantiles(y, q)), \
        "B9c: a rerun gave other bits"
    assert _b9c_equal(first_b9c(torch, first, y, q), qp), \
        "B9c first version != plain"
    err = (qk - ql).abs().max().item()
    assert err <= 1e-6, f"B9c vs torch.quantile: {err} > 1e-6"
    y1 = y[:, :1].contiguous()
    assert _b9c_equal(tserve.draw_quantiles(y1, q),
                      tserve._draw_quantiles_plain(y1, q)), "B9c at B 1"
    q40 = torch.linspace(0.0, 1.0, 40, device=dev)
    cases = [(1, 3, 50), (2, 3, 50), (37, 3, 50), (1025, 3, 50),
             (40000, 3, 50), (800, 1, 1000), (37, 64, 1000)]
    for n, B, ns in cases:
        w = b9c_specials(torch, dev, n, B, ns, seed=n + B)
        for qq in (q, q40):
            a = tserve.draw_quantiles(w, qq)
            b = tserve._draw_quantiles_plain(w, qq)
            assert _b9c_equal(a, b), f"B9c at {n} x {B} x {ns}: kernel != " \
                                     f"plain ({qq.numel()} quantiles)"
            assert torch_equal_bits(a, tserve.draw_quantiles(w, qq)), \
                f"B9c at {n} draws: a rerun gave other bits"
            if B * ns >= 7:
                assert torch.isnan(a[:, 0, 5]).all(), "B9c: a NaN column"
    print(f"B9c check: {tuple(y.shape)} draws, q {SERVE_Q}: kernel == plain "
          f"exactly (and its first version), max |kernel - torch.quantile| "
          f"= {err:.3g} (tolerance 1e-6); at B 1; draws (n, B, ns) "
          f"{cases} with ties, +-inf, -0.0 beside +0.0 and a NaN column, "
          f"3 and 40 quantiles, exact; reruns give the same bits")

    def kern():
        tserve.draw_quantiles(y, q)

    def plain():
        tserve._draw_quantiles_plain(y, q)

    def library():
        torch.quantile(y, q, dim=0)

    ms = device_ms(torch, kern, "serve_quantile_kernel")
    first_ms = device_ms(torch, lambda: first_b9c(torch, first, y, q),
                         "serve_quantile_kernel")
    plain_ms = device_ms(torch, plain, calls=5)
    lib_ms = device_ms(torch, library, calls=5)
    ev, plain_ev = event_ms(torch, kern), event_ms(torch, plain, batch=3)
    held = held_event_ms(torch, kern)
    n, cols = y.shape[0], y[0].numel()
    # bytes: the draws read once, the quantiles written once (a selection
    # needs no comparison sort's n log2 n)
    b, by = bound_ms(4.0 * (n * cols + q.numel() * cols), 0.0)
    print(f"B9c serve_quantile device time: {ms:.5f} ms (first version "
          f"{first_ms:.5f} ms in this call; plain {plain_ms:.4f} ms, "
          f"torch.quantile {lib_ms:.4f} ms, bound {b:.4f} ms by {by}; held "
          f"stream {held:.5f} ms, with enqueue {ev:.4f} ms, plain "
          f"{plain_ev:.4f} ms) at {n} x 64 x {SERVE['ns']}, {q.numel()} "
          f"quantiles [{card}]")
    more = {}
    for n2, B2, ns2, old in ((800, 1, 1000, True), (37, 64, 1000, True),
                             (1025, 64, 1000, True), (40000, 3, 50, False)):
        w = 0.3 * torch.randn((n2, B2, ns2), device=dev)
        t = device_ms(torch, lambda: tserve.draw_quantiles(w, q),
                      "serve_quantile_kernel")
        t_old = (device_ms(torch, lambda: first_b9c(torch, first, w, q),
                           "serve_quantile_kernel") if old else None)
        bb, _ = bound_ms(4.0 * (n2 + q.numel()) * B2 * ns2, 0.0)
        more[f"{n2}x{B2}x{ns2}"] = dict(ms=t, first_ms=t_old, bound_ms=bb)
        was = ("not run: above its 32768 draws" if t_old is None
               else f"{t_old:.5f} ms")
        print(f"B9c serve_quantile device time at {n2} x {B2} x {ns2}: "
              f"{t:.5f} ms (first version {was}; bound {bb:.5f} ms by "
              f"bytes) [{card}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms, event_ms=ev,
                plain_event_ms=plain_ev, held_ms=held, first_ms=first_ms,
                shape=[n, 64, SERVE["ns"], q.numel()], shapes=more)


def b9b_ops(n, B, ns, observed, nc, nf, steps):
    """B9b's operations, multiply-adds as 2, over the species each pass
    needs: per (draw, row) LFix and the link's E over all ``ns`` species
    (2 nc + 2 nf a species); over the ``observed`` cells of all B rows
    (unobserved ones weigh 0 in the gram and F, and only F reads Z) the
    gram (3 a cell and entry of its lower triangle), E at the initial Z
    and after each step but the last (whose Z nothing reads; 2 nf a cell
    each), and per step F (2 nf + 3 a cell)."""
    per_species = 2 * nc + 2 * nf
    per_observed = (3 * nf * (nf + 1) / 2 + steps * 2 * nf
                    + steps * (2 * nf + 3))
    return n * (B * ns * per_species + observed * per_observed)


def b9b_bound(n, B, ns, nc, nf, observed, steps):
    """B9b's bound: the draws (Beta, sigma, Lambda, the rows' Eta), X,
    uidx, Yc and mask read once, mean and sd written once; the operations
    of :func:`b9b_ops`."""
    nbytes = 4.0 * (n * (nc * ns + ns + nf * ns + B * nf)
                    + B * (nc + 1 + 2 * ns) + 2 * B * ns)
    return bound_ms(nbytes, b9b_ops(n, B, ns, observed, nc, nf, steps))


def conditional_query(torch, dev, args, seed, observed=500):
    """Yc and mask for a query block: species < ``observed`` observed with
    Bernoulli(0.5) 0 / 1 values, drawn independently of the posterior; the
    rest unobserved."""
    X, uidx = args[0], args[1]
    B, ns = X.shape[0], SERVE["ns"]
    g = torch.Generator(device=dev).manual_seed(seed)
    Yc = (torch.rand((B, ns), generator=g, device=dev) < 0.5).float()
    mask = torch.zeros((B, ns), device=dev)
    mask[:, :observed] = 1.0
    return Yc * mask, mask


# C2: a sampled probit draw is Z > 0 with Z = E + sqrt(sigma) eps; kernel
# and plain version may disagree on a draw only where Z lies within this
# many float32 ulps of the magnitude of its terms (|X||Beta| + |rows||Lambda|
# + |sqrt(sigma) eps|) of 0.  The float32 plain version's Z is within 18.6
# such ulps of its float64 value over 6.4e6 draws of check_b9b's query (the
# CPU, 100 draws), so two float32 computations of it may differ by ~40.
B9B_FLIP_ULPS = 64


def b9b_flips_explained(torch, tserve, X, uidx, Yc, mask, rest, steps,
                        noise, mk, mp, sk):
    """B9b's sampled gate (all columns probit, ym 0, ys 1): each draw's
    pre-threshold Z recomputed in float64 from the injected draws
    (``_conditional_predictor``); in every cell where the kernel's and the
    plain version's means differ, the difference must be a whole number of
    draws, no more than the cell's draws whose float64 Z lies within
    ``B9B_FLIP_ULPS`` float32 ulps of its terms' magnitude of 0; the
    kernel's sd must be its mean's (sqrt(m (1 - m))) to 1e-5.  Returns the
    line's summary."""
    Beta, sigma, lams, etas, fam = rest[:5]
    E, _, rows = tserve._conditional_predictor(
        X, uidx, Yc, mask, Beta, sigma, lams, etas, fam, steps, noise, None,
        dtype=torch.float64)
    noise_term = sigma.double().sqrt()[:, None, :] * noise["eps_out"].double()
    Z = E + noise_term
    mag = (torch.einsum("yc,ncj->nyj", X.double().abs(), Beta.double().abs())
           + sum(torch.einsum("nyf,nfj->nyj", r.abs(), lam.double().abs())
                 for r, lam in zip(rows, lams)) + noise_term.abs())
    in_ulps = Z.abs() / (mag * 2.0 ** -23)
    del E, Z, mag, noise_term
    n = in_ulps.shape[0]
    dm = (mk - mp).double().abs() * n
    count = dm.round()
    assert ((dm - count).abs() <= 1e-3).all(), \
        f"B9b sampled: a mean differs by {(dm - count).abs().max().item()} " \
        f"draws from a whole number"
    near = (in_ulps <= B9B_FLIP_ULPS).sum(dim=0)
    bad = count > near
    assert not bad.any(), (
        f"B9b sampled: {int(bad.sum())} cells differ by more draws than lie "
        f"within {B9B_FLIP_ULPS} ulps of 0")
    worst = 0.0
    for b, j in (count > 0).nonzero().tolist():
        k = int(count[b, j])
        worst = max(worst, in_ulps[:, b, j].sort().values[k - 1].item())
    sd_err = (sk.double() - (mk.double() * (1 - mk.double())).sqrt()).abs()
    assert sd_err.max().item() <= 1e-5, f"B9b sampled sd: {sd_err.max()}"
    return (f"{int((count > 0).sum())} cells differ by {int(count.sum())} "
            f"draws in all, each explained by a draw whose float64 Z lies "
            f"within {B9B_FLIP_ULPS} float32 ulps of its terms' magnitude of "
            f"0, the largest at {worst:.3g} ulps")


# query rows at which B9b's checks run: one size for each launch geometry
# the serve shapes give it (ops/serve.py · conditional_geometry: 1 row and
# 8 draw slots reading the draws from L2, 2 rows x 4 slots, 4 x 2 with one
# stage, 8 rows with two stages, 8 row groups), at nf 4, 8 and 16, float32
# and bfloat16 draws
B9B_CHECK_ROWS = (1, 2, 3, 8, 64)
B9B_CHECK_NF = (4, 8, 16)


def _b9b_noise(torch, dev, n, steps, B, ns, nf, seed, sampled):
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = {"eps_z": torch.randn((n, steps + 1, B, ns), generator=g,
                                  device=dev),
             "u_z": torch.rand((n, steps + 1, B, ns), generator=g,
                               device=dev).clamp_min_(1e-38),
             "eps_rows": torch.randn((n, steps, B, nf), generator=g,
                                     device=dev)}
    if sampled:
        noise["eps_out"] = torch.randn((n, B, ns), generator=g, device=dev)
    return noise


def check_b9b(torch, tserve, dev, card, steps=3):
    """B9b against its plain version with every draw injected, at
    mcmc_step 3: expected mean and sd to 1e-5 at every launch geometry of
    ``B9B_CHECK_ROWS`` x ``B9B_CHECK_NF`` x (float32, bfloat16); sampled
    means at B 64 by :func:`b9b_flips_explained`; two Philox runs
    bit-identical at B 64 and B 1.  Times at B 64, 8 and 1."""
    worst = 0.0
    n, ns, nc = SERVE["n"], SERVE["ns"], SERVE["nc"]
    geos = set()
    for B in B9B_CHECK_ROWS:
        for nf in B9B_CHECK_NF:
            for dt in (torch.float32, torch.bfloat16):
                args = serve_inputs(torch, dev, B, seed=60 + B + nf, dtype=dt,
                                    nf=nf)
                Yc, mask = conditional_query(torch, dev, args, seed=61)
                noise = _b9b_noise(torch, dev, n, steps, B, ns, nf, 62,
                                   False)
                X, uidx, rest = args[0], args[1], args[2:]
                mk, sk = tserve.serve_conditional(
                    X, uidx, Yc, mask, *rest, mcmc_step=steps, expected=True,
                    noise=noise)
                mp, sp = tserve._serve_conditional_plain(
                    X, uidx, Yc, mask, *rest, steps, True, noise, None)
                err = max((mk - mp).abs().max().item(),
                          (sk - sp).abs().max().item())
                geo = tserve.conditional_geometry(
                    n, B, ns, nc, [nf], dt == torch.bfloat16)
                geos.add(geo[:3])
                assert err <= 1e-5, (f"B9b B {B} nf {nf} {dt} ({geo}): "
                                     f"{err} > 1e-5")
                worst = max(worst, err)
                del noise
    print(f"B9b check: injected draws, expected, mcmc_step {steps}, B "
          f"{B9B_CHECK_ROWS} x nf {B9B_CHECK_NF} x float32 / bfloat16 "
          f"(geometries rows x slots x stages {sorted(geos)}): max |kernel "
          f"- plain| over mean and sd = {worst:.3g} (tolerance 1e-5)")
    args = serve_inputs(torch, dev, 64, seed=124)
    Yc, mask = conditional_query(torch, dev, args, seed=61)
    noise = _b9b_noise(torch, dev, n, steps, 64, ns, SERVE["nf"], 62, True)
    X, uidx, rest = args[0], args[1], args[2:]
    mk, sk = tserve.serve_conditional(X, uidx, Yc, mask, *rest,
                                      mcmc_step=steps, expected=False,
                                      noise=noise)
    mp, sp = tserve._serve_conditional_plain(X, uidx, Yc, mask, *rest, steps,
                                             False, noise, None)
    err = max((mk - mp).abs().max().item(), (sk - sp).abs().max().item())
    tol = b9b_flips_explained(torch, tserve, X, uidx, Yc, mask, rest, steps,
                              noise, mk, mp, sk)
    del noise
    print(f"B9b check: injected draws, B 64, float32, mcmc_step {steps}, "
          f"sampled: max |kernel - plain| over mean and sd = {err:.3g} "
          f"({tol})")

    times = {}
    for B in (64, 8, 1):
        args = serve_inputs(torch, dev, B, seed=70 + B)
        Yc, mask = conditional_query(torch, dev, args, seed=71)
        X, uidx, rest = args[0], args[1], args[2:]

        def kern():
            return tserve.serve_conditional(X, uidx, Yc, mask, *rest,
                                            mcmc_step=steps, expected=True,
                                            seed=3, offset=4)

        a, b = kern(), kern()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), \
            f"B9b B {B}: two Philox runs differ"
        ms = _kernel_ms(torch, kern, ("serve_conditional_kernel",
                                      "combine_moments_kernel"))
        bd, by = b9b_bound(n, B, ns, nc, SERVE["nf"], mask.sum().item(),
                           steps)
        times[B] = dict(ms=ms, bound_ms=bd, bound_by=by, args=args, Yc=Yc,
                        mask=mask, kern=kern,
                        geo=tserve.conditional_geometry(n, B, ns, nc,
                                                        [SERVE["nf"]]))
    t64 = times[64]
    X, uidx, rest = t64["args"][0], t64["args"][1], t64["args"][2:]
    Yc, mask = t64["Yc"], t64["mask"]
    noise = _b9b_noise(torch, dev, n, steps, 64, ns, SERVE["nf"], 72, False)

    def plain():                      # its draws injected, not timed
        tserve._serve_conditional_plain(X, uidx, Yc, mask, *rest, steps,
                                        True, noise, None)

    plain_ms = device_ms(torch, plain, calls=3)
    ev = event_ms(torch, t64["kern"], batch=5)
    plain_ev = event_ms(torch, plain, batch=2)
    held = held_event_ms(torch, t64["kern"], calls=10)
    del noise
    for B in (64, 8, 1):
        t = times[B]
        print(f"B9b serve_conditional device time at B {B}: {t['ms']:.4f} "
              f"ms (bound {t['bound_ms']:.4f} ms by {t['bound_by']}; "
              f"{t['ms'] / t['bound_ms']:.1f}x; geometry {t['geo']}) "
              f"[{card}]")
    print(f"B9b serve_conditional at B 64: plain {plain_ms:.4f} ms; held "
          f"stream {held:.5f} ms, with enqueue {ev:.4f} ms, plain "
          f"{plain_ev:.4f} ms; mcmc_step {steps}, {n} draws x {ns} species, "
          f"500 observed [{card}]")
    return dict(max_abs_err=worst, ms=t64["ms"], plain_ms=plain_ms,
                bound_ms=t64["bound_ms"], bound_by=t64["bound_by"],
                library_ms=None, event_ms=ev, plain_event_ms=plain_ev,
                held_ms=held, b8_ms=times[8]["ms"],
                b8_bound_ms=times[8]["bound_ms"], b1_ms=times[1]["ms"],
                b1_bound_ms=times[1]["bound_ms"],
                shape=[n, 64, ns, steps])


# ---------------------------------------------------------------------------
# the precision phase: B10, the bf16 forms, the policy'd paths
# ---------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12          # H100 SXM bf16 on the tensor cores, dense


def b10_cases(torch, dev, exact, seed=10):
    """B10's products at the shapes the policy'd paths give it: label ->
    (a, b).  ``exact``: float32 operands holding bfloat16 values (the sum
    of exact products is then the only rounding), else general float32;
    the staged operands are bfloat16 shadows either way."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*s):
        x = torch.randn(s, generator=g, device=dev)
        return x.to(torch.bfloat16).float() if exact else x

    C, ny, ns, P, nf = (HEADLINE["n_chains"], HEADLINE["ny"], HEADLINE["ns"],
                        2 + HEADLINE["nf"], CONFIG3_NF)
    XE, Z = rn(C, ny, P), rn(C, ny, ns)
    E, lam = rn(C, 2, ns), rn(C, HEADLINE["nf"], ns)
    n3a = 2 * CONFIG3["config3a"]["np"]          # 3a: 200 units x 2 rows
    S3, lam3 = rn(C, n3a, CONFIG3_NS), rn(C, nf, CONFIG3_NS)
    isig = rn(C, CONFIG3_NS).abs() + 0.5
    eta = rn(C * nf, 1, CONFIG3["config3a"]["np"])
    iW16 = rn(C * nf, CONFIG3["config3a"]["np"], CONFIG3["config3a"]["np"]
              ).to(torch.bfloat16)
    X16 = rn(n3a, 2).to(torch.bfloat16)
    return {
        "XE'Z (headline)": (XE.transpose(1, 2), Z),
        "XE'XE (headline)": (XE.transpose(1, 2), XE),
        "E E' (GammaV, nc 2)": (E, E.transpose(1, 2)),
        "lam lam' (location, nf 8)": (lam, lam.transpose(1, 2)),
        "X Beta (3a, X staged)": (X16, rn(C, 2, CONFIG3_NS)),
        "(S iSigma) lam' (3a)": (S3 * isig[:, None, :], lam3.transpose(1, 2)),
        "(lam iSigma) lam' (3a)": (lam3 * isig[:, None, :],
                                   lam3.transpose(1, 2)),
        "eta' iW (3a, iW staged)": (eta, iW16),
        "odd shapes": (rn(3, 37, 61), rn(3, 61, 29)),
    }


def check_b10(torch, tmixed, dev, card):
    """B10 (``ops/mixed.py · mixed_gemm``, ``csrc/mixed_gemm.cu``) against
    its plain version (the operands rounded to bfloat16, widened, a float32
    product) at ``b10_cases``: |kernel - plain| within 1e-5 of the sum of
    the terms' magnitudes, on bf16-exact and general float32 operands;
    reruns to the same bits.  Timed at the headline's XE'Z beside the
    plain version and, where CUDA has it, ``torch.bmm(a_bf16, b_bf16,
    out_dtype=torch.float32)``, the one-call yardstick (else the bf16-output
    ``torch.bmm``, a different function, is timed and named so)."""
    worst = 0.0
    for exact in (True, False):
        for label, (a, b) in b10_cases(torch, dev, exact).items():
            k = tmixed.mixed_gemm(a, b)
            p = tmixed._mixed_gemm_plain(a, b)
            terms = (tmixed.round_bf16(a).double().abs()
                     @ tmixed.round_bf16(b).double().abs())
            err = ((k.double() - p.double()).abs() / terms.clamp_min(1e-30)
                   ).max().item()
            assert k.dtype == torch.float32 and torch.isfinite(k).all()
            assert err <= 1e-5, f"B10 {label}: {err} of the terms > 1e-5"
            assert torch.equal(k, tmixed.mixed_gemm(a, b)), \
                f"B10 {label}: a rerun gave other bits"
            worst = max(worst, (k - p).abs().max().item())
            S, _ = tmixed.gemm_splits(k.numel() // (k.shape[-1] *
                                                    k.shape[-2]),
                                      a.shape[-2], b.shape[-1], a.shape[-1])
            print(f"B10 check {label}, {'bf16-exact' if exact else 'float32'}"
                  f" operands, {tuple(a.shape)} x {tuple(b.shape)} "
                  f"({a.dtype} x {b.dtype}, {S} k splits): max |kernel - "
                  f"plain| / the terms' magnitudes {err:.3g} (1e-5); two "
                  f"runs bit-identical")
    a, b = b10_cases(torch, dev, False)["XE'Z (headline)"]
    nb, M, Kd = a.shape
    N = b.shape[-1]

    def kern():
        tmixed.mixed_gemm(a, b)

    def plain():
        tmixed._mixed_gemm_plain(a, b)

    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    lib_ms, lib_note = None, ""
    try:
        ref = torch.bmm(a16, b16, out_dtype=torch.float32)
        assert ref.dtype == torch.float32
        lib_ms = device_ms(torch, lambda: torch.bmm(a16, b16,
                                                    out_dtype=torch.float32))
        lib_note = (f"torch.bmm(bf16, bf16, out_dtype=float32) "
                    f"{lib_ms:.5f} ms")
    except (TypeError, RuntimeError, NotImplementedError, AssertionError) \
            as exc:
        bf16_out = device_ms(torch, lambda: torch.bmm(a16, b16))
        lib_note = (f"no torch call with bf16 operands and float32 output "
                    f"({type(exc).__name__}); torch.bmm on bf16 tensors, "
                    f"bf16 output (a different function) {bf16_out:.5f} ms")
    parts = [device_ms(torch, kern, m) for m in ("mixed_gemm_kernel",
                                                 "mixed_gemm_sum_kernel")]
    ms = sum(parts)
    plain_ms = device_ms(torch, plain)
    ev, held = event_ms(torch, kern), held_event_ms(torch, kern)
    # bytes: both float32 operands read once, the float32 product written
    # once; operations: a multiply-add a (batch, m, n, k) on the bf16 tensor
    # cores
    nbytes = 4.0 * nb * (M * Kd + Kd * N + M * N)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * nb * M * N * Kd / BF16_OPS_PER_S * 1e3
    b_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")
    S, _ = tmixed.gemm_splits(nb, M, N, Kd)
    print(f"B10 mixed_gemm device time at the headline's XE'Z ({nb} x {M} x "
          f"{Kd} by {Kd} x {N}, {S} k splits): {ms:.5f} ms ("
          f"{parts[0]:.5f} + {parts[1]:.5f}; plain {plain_ms:.5f} ms; "
          f"{lib_note}; bound {b_ms:.6f} ms by {by}; held stream "
          f"{held:.5f} ms, with enqueue {ev:.4f} ms) [{card}]")
    return dict(max_abs_err=worst, ms=ms, parts_ms=parts, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, library_ms=lib_ms, event_ms=ev,
                held_ms=held, shape=[nb, M, Kd, N])


def check_bf16_forms(torch, trand, tgram, tsp, dev, card):
    """The bf16 forms of B4, B6, B8b (at alpha) and B8c, each against its
    plain version on the same inputs: B4's (injected draws; the plain block
    on the CPU, its products through B10's plain version) 1e-4 relative on
    iV and Gamma; B6's species and row forms 1e-4 of max |plain|; B8c's
    and B8b's bf16-grid forms 1e-5; reruns to the same bits; each timed
    beside its float32 form.  Returns {kernel: {"bf16": numbers}}."""
    out = {}
    C = HEADLINE["n_chains"]
    res = {}
    for nc, nt, ns in B4_SHAPES[:2]:
        args, df, noise = b4_inputs(torch, trand, dev, C, nc, nt, ns,
                                    seed=nc * nt + 1)
        Tr16 = args["Tr"].to(torch.bfloat16)
        T = Tr16.float()
        a16 = dict(args, TtT=T.T @ T)
        iVk, Gk = trand.gamma_v(**a16, df=df, noise=noise, Tr16=Tr16)
        cpu = lambda x: ({k: cpu(v) for k, v in x.items()}
                         if isinstance(x, dict) else x.cpu())
        iVp, Gp = trand.gamma_v_plain(**cpu(a16), df=df, noise=cpu(noise),
                                      Tr16=Tr16.cpu())
        rel = max(_rel(iVk.cpu(), iVp), _rel(Gk.cpu(), Gp))
        assert rel <= 1e-4, f"B4 bf16 nc {nc}: rel diff {rel} > 1e-4"
        iV32, G32 = trand.gamma_v(**args, df=df, noise=noise)
        gap = _rel(Gk, G32)
        assert gap > 0, "B4 bf16: the bf16 form gave the float32 bits"
        again = trand.gamma_v(**a16, df=df, noise=noise, Tr16=Tr16)
        assert torch.equal(again[0], iVk) and torch.equal(again[1], Gk)
        rng = trand.Rng(33, dev)
        ms = device_ms(torch, lambda: trand.gamma_v(**a16, df=df, rng=rng,
                                                     Tr16=Tr16),
                       "gamma_v_kernel")
        ms32 = device_ms(torch, lambda: trand.gamma_v(**args, df=df,
                                                       rng=rng),
                         "gamma_v_kernel")
        plain_ms = device_ms(torch, lambda: trand.gamma_v_plain(
            **a16, df=df, rng=rng, Tr16=Tr16), calls=20)
        n = nc * nt
        nbytes = 4.0 * (C * nc * ns + ns * nt + 2 * C * nc * nt + nc * nc
                        + nt * nt + n * n + n + C * nc * nc) + 2.0 * ns * nt
        ops = C * (ns * (4 * nc * nt + nc * (nc + 1) + 2 * nc * nc)
                   + 5 * nc ** 3 + 2 * n * n + n ** 3 / 3 + 4 * n * n
                   + 180 * nc + 130 * (nc * (nc - 1) / 2 + n))
        b, by = bound_ms(nbytes, ops)
        print(f"B4 bf16 form, C {C}, nc {nc}, nt {nt}, ns {ns}: max relative "
              f"|kernel - plain| on iV and Gamma {rel:.3g} (1e-4; plain on "
              f"the CPU) with the same draws, {gap:.3g} from the float32 "
              f"form's Gamma; reruns give the same bits; device time "
              f"{ms:.5f} ms (float32 form {ms32:.5f}; the plain block on the "
              f"card, its products through B10, {plain_ms:.5f}; bound "
              f"{b:.6f} ms by {by}) [{card}]")
        res[nc, nt, ns] = dict(rel_err=rel, ms=ms, f32_ms=ms32,
                               plain_ms=plain_ms, bound_ms=b, bound_by=by,
                               shape=[C, nc, nt, ns])
    out["gamma_v"] = {"bf16": res[B4_SHAPES[0]], "bf16_by_shape": {
        f"nc {k[0]} nt {k[1]} ns {k[2]}": v for k, v in res.items()}}

    ny, ns, nf = HEADLINE["ny"], HEADLINE["ns"], HEADLINE["nf"]
    res = {}
    for form, P in (("species", 2 + nf), ("row", nf)):
        mask, XE, Z, lam, iSigma = gram_inputs(torch, dev, C, ny, ns, P,
                                               seed=P + 50)
        v, w, s_, a = ((XE, mask.T, Z.transpose(1, 2), None)
                       if form == "species" else
                       (lam.transpose(1, 2), mask, Z, iSigma))
        Gk, Rk = tgram.masked_gram(v, w, s_, a, bf16=True)
        sa = s_ if a is None else s_ * a[:, None, :]
        Gp, Rp = tgram._masked_gram_bf16_plain(v, w, sa, a)
        rels = (_rel(Gk, Gp), _rel(Rk, Rp))
        assert max(rels) <= 1e-4, f"B6 bf16 {form}: rel diff {rels} > 1e-4"
        G32, _ = tgram.masked_gram(v, w, s_, a)
        gap = _rel(Gk, G32)
        assert gap > 0, "B6 bf16: the bf16 form gave the float32 bits"
        again = tgram.masked_gram(v, w, s_, a, bf16=True)
        assert torch.equal(again[0], Gk) and torch.equal(again[1], Rk)
        parts = [device_ms(torch, lambda: tgram.masked_gram(
            v, w, s_, a, bf16=True), m) for m in (
            "masked_gram_columns_kernel", "masked_gram_kernel",
            "masked_gram_sum_kernel")]
        ms = sum(parts)
        ms32 = sum(device_ms(torch, lambda: tgram.masked_gram(v, w, s_, a),
                             m) for m in ("masked_gram_columns_kernel",
                                          "masked_gram_kernel",
                                          "masked_gram_sum_kernel"))
        plain_ms = device_ms(torch, lambda: tgram._masked_gram_bf16_plain(
            v, w, sa, a), calls=10)
        Cv, Kd, _ = v.shape
        O = w.shape[0]
        nbytes = 4.0 * (Cv * Kd * P + O * Kd + Cv * O * Kd + Cv * O * P * P
                        + Cv * O * P + (0 if a is None else Cv * Kd))
        b, by = bound_ms(nbytes, 2.0 * Cv * O * Kd * (P * (P + 1) / 2 + P))
        print(f"B6 bf16 form, {form} (C {Cv}, O {O}, K {Kd}, P {P}): max "
              f"|kernel - plain| / max |plain| {rels[0]:.3g} (G), "
              f"{rels[1]:.3g} (R) (1e-4), {gap:.3g} from the float32 form's "
              f"G; two runs bit-identical; device time {ms:.5f} ms "
              f"({' + '.join(f'{x:.5f}' for x in parts)}; float32 form "
              f"{ms32:.5f}; plain {plain_ms:.5f}; bound {b:.6f} ms by {by}) "
              f"[{card}]")
        res[form] = dict(rel_err=max(rels), ms=ms, f32_ms=ms32,
                         plain_ms=plain_ms, bound_ms=b, bound_by=by,
                         shape=[Cv, O, Kd, P])
    out["masked_gram"] = {"bf16": res["species"], "bf16_row": res["row"]}

    n, k = CONFIG3["dense_nngp"]["np"], 10
    lvd = nngp_level(torch, dev, n, k, 10.0, seed=n + 7)
    g = torch.Generator(device=dev).manual_seed(n + 8)
    alpha = torch.randint(0, B8_G, (B8_C, B8_NF), generator=g, device=dev,
                          dtype=torch.int32)
    c16, d16 = lvd.nn_coef.to(torch.bfloat16), lvd.nn_D.to(torch.bfloat16)
    Wk = tsp.nngp_riw_dense(lvd, alpha, c16, d16)
    Wp = tsp._nngp_riw_dense_plain(lvd, alpha, c16, d16)
    err = _rel(Wk, Wp)
    assert err <= 1e-5, f"B8c bf16: rel diff {err} > 1e-5"
    assert torch.equal(Wk, tsp.nngp_riw_dense(lvd, alpha, c16, d16))
    gap = _rel(Wk, tsp.nngp_riw_dense(lvd, alpha))
    ms = device_ms(torch, lambda: tsp.nngp_riw_dense(lvd, alpha, c16, d16),
                   "nngp_iw_kernel")
    ms32 = device_ms(torch, lambda: tsp.nngp_riw_dense(lvd, alpha),
                     "nngp_iw_kernel")
    plain_ms = device_ms(torch, lambda: tsp._nngp_riw_dense_plain(
        lvd, alpha, c16, d16), calls=10)
    used = int(alpha.unique().numel())
    nbytes = 2.0 * used * n * (k + 1) + 4.0 * (n * k + 2 * n + B8_C * B8_NF
                                               * n * n)
    b, by = bound_ms(nbytes, B8_C * B8_NF * n * (k + 1) ** 2 * 2.0)
    print(f"B8c bf16-grid form, C {B8_C}, nf {B8_NF}, np {n}: max |kernel - "
          f"plain| / max |plain| {err:.3g} (1e-5), {gap:.3g} from the "
          f"float32 grids' iW; rerun bit-identical; device time {ms:.5f} ms "
          f"(float32 grids {ms32:.5f}; plain {plain_ms:.5f}; bound {b:.6f} ms"
          f" by {by}) [{card}]")
    out["nngp_riw"] = {"bf16": dict(rel_err=err, ms=ms, f32_ms=ms32,
                                    plain_ms=plain_ms, bound_ms=b,
                                    bound_by=by, shape=[B8_C, B8_NF, n])}

    n, k, side = B8_SHAPES[0]
    lvd = nngp_level(torch, dev, n, k, side, seed=n + 9)
    g = torch.Generator(device=dev).manual_seed(n + 10)
    alpha = torch.randint(0, B8_G, (B8_C, B8_NF), generator=g, device=dev,
                          dtype=torch.int32)
    eta = torch.randn((B8_C, n, B8_NF), generator=g, device=dev)
    c16, d16 = lvd.nn_coef.to(torch.bfloat16), lvd.nn_D.to(torch.bfloat16)
    ak = tsp.nngp_quad_at(lvd, alpha, eta, c16, d16)
    ap = tsp._nngp_quad_at_bf16_plain(lvd, alpha, eta, c16, d16)
    e_q = ((ak[..., :2] - ap[..., :2]).abs() / ap[..., :2].abs()).max().item()
    e_s = ((ak[..., 2] - ap[..., 2]).abs()
           / (ap[..., 0] * ap[..., 1]).sqrt()).max().item()
    assert max(e_q, e_s) <= 1e-5, f"B8b bf16: rel diff {e_q}, {e_s}"
    assert torch.equal(ak, tsp.nngp_quad_at(lvd, alpha, eta, c16, d16))
    gap = _rel(ak, tsp.nngp_quad_at(lvd, alpha, eta))
    ms = device_ms(torch, lambda: tsp.nngp_quad_at(lvd, alpha, eta, c16,
                                                   d16),
                   "nngp_quad_at_kernel")
    ms32 = device_ms(torch, lambda: tsp.nngp_quad_at(lvd, alpha, eta),
                     "nngp_quad_at_kernel")
    plain_ms = device_ms(torch, lambda: tsp._nngp_quad_at_bf16_plain(
        lvd, alpha, eta, c16, d16), calls=10)
    used = int(alpha.unique().numel())
    nbytes = 2.0 * used * n * (k + 1) + 4.0 * (n * k + B8_C * n * B8_NF
                                               + 3 * B8_C * B8_NF)
    b, by = bound_ms(nbytes, B8_C * B8_NF * n * (2 * k + 12))
    print(f"B8b at-alpha bf16-grid form, C {B8_C}, nf {B8_NF}, np {n}, k "
          f"{k}: rel |kernel - plain| {e_q:.3g} (quadratics), {e_s:.3g} "
          f"(1' iW eta) (1e-5), {gap:.3g} from the float32 grids'; rerun "
          f"bit-identical; device time {ms:.5f} ms (float32 grids "
          f"{ms32:.5f}; plain {plain_ms:.5f}; bound {b:.6f} ms by {by}) "
          f"[{card}]")
    out["nngp_quad"] = {"bf16_at": dict(rel_err=max(e_q, e_s), ms=ms,
                                        f32_ms=ms32, plain_ms=plain_ms,
                                        bound_ms=b, bound_by=by,
                                        shape=[B8_C, B8_NF, n, k])}
    return out


def clone_rng(torch, trand, rng):
    """An independent copy of a run's random streams at their state."""
    new = trand.Rng.__new__(trand.Rng)
    new.device = rng.device
    new.gen = torch.Generator(device=rng.device)
    new.gen.set_state(rng.gen.get_state())
    new.host = torch.Generator()
    new.host.set_state(rng.host.get_state())
    return new


def state_dev(torch, ref, other):
    """Max over the state's float tensors of max |other - ref| / max |ref|
    (the JAX package's ``_carry_dev``)."""
    devs = []
    for a, b in zip(ref.float_tensors(), other.float_tensors()):
        if a.numel():
            scale = max(a.abs().max().item(), 1e-6)
            devs.append((b - a).abs().max().item() / scale)
    return max(devs) if devs else 0.0


PRECISION_WARM = 20              # float32 sweeps before the one-sweep check


def policy_one_sweep(torch, ht, trand, K, card, label, hM, nf, n_chains,
                     dev, seed=5):
    """One sweep under ``precision_policy="auto"`` against the float32
    sweep from one mid-chain state (``PRECISION_WARM`` float32 sweeps from
    the initial state), both on copies of one set of random streams: the
    normalised deviation (``state_dev``) must be finite, above 0 and at
    most ``PRECISION_AGREEMENT_TOL``; each policy'd block's, measured on
    the float32 chain's carry as the JAX package's
    ``measure_policy_tolerance`` does, is printed beside the port's
    ``precision_tolerance.json``.  The policy'd sweep's launches are
    counted: B10's must be the schedule's (``expected_launches``); the
    caller checks the path's bf16 forms."""
    from hmsc_tpu_torch.mcmc import precision as tprec
    from hmsc_tpu_torch.mcmc import sampler as tsampler
    from hmsc_tpu_torch.mcmc import structs as tstructs
    from hmsc_tpu_torch.mcmc import sweep as tsweep
    from hmsc_tpu_torch.mcmc.updaters import update_z
    from hmsc_tpu_torch.ops import mixed
    from hmsc_tpu_torch.precompute import compute_data_parameters

    spec = tstructs.build_spec(hM, nf)
    tstructs.check_supported(hM, spec)
    data = tstructs.build_model_data(hM, compute_data_parameters(hM), spec,
                                     dev)
    state, _ = tsampler.initial_states(hM, spec, seed, n_chains, dev)
    rng = trand.Rng(seed, dev)
    zeros = tuple(0 for _ in range(spec.nr))
    f32 = tsweep.make_sweep(spec, adapt_nf=zeros)
    state = update_z(spec, data, state, rng)
    for it in range(PRECISION_WARM):
        state = f32(data, state, rng, it=it + 1)
    policy = tprec.resolve_policy("auto", spec)
    staged = tprec.stage_data(data, policy)
    tol = tprec.load_tolerance()["models"][tprec.classify_spec(spec)]
    # each policy'd block on the float32 chain's carry
    steps_f = tsweep.make_sweep_schedule(spec, None, zeros)
    steps_m = dict(tsweep.make_sweep_schedule(spec, None, zeros,
                                              precision=policy))
    carry = (tsweep.sweep_prologue(state), None)
    blocks = {}
    for name, blk in steps_f:
        r = clone_rng(torch, trand, rng)
        nxt = blk(data, carry, r, None)
        if policy.dtype_for(name) is not None:
            with mixed.staged_scope(staged):
                mp = steps_m[name](data, carry, clone_rng(torch, trand, rng),
                                   None)
            blocks[name] = state_dev(torch, nxt[0], mp[0])
        rng, carry = r, nxt
    # the whole sweep, from the same state on copies of the same streams
    ref = f32(data, state, clone_rng(torch, trand, rng),
              it=PRECISION_WARM + 1)
    mp_sweep = tsweep.make_sweep(spec, adapt_nf=zeros, precision=policy,
                                 staged=staged)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    K.reset_launches()
    out = mp_sweep(data, state, clone_rng(torch, trand, rng),
                   it=PRECISION_WARM + 1)
    sync()
    launches = {k: v for k, v in K.launches.items() if v}
    dev_sweep = state_dev(torch, ref, out)
    block_txt = ", ".join(
        f"{n} {d:.3g} (JAX record {tol['blocks'][n]['max_rel']})"
        for n, d in blocks.items())
    print(f"precision one-sweep {label}: policy {policy.blocks}, staged "
          f"{sorted(staged)}; per block {block_txt}; whole sweep "
          f"{dev_sweep:.4g} (0 < it <= {tprec.PRECISION_AGREEMENT_TOL}; "
          f"JAX record {tol['sweep_max_rel']}); the policy'd sweep's "
          f"launches {launches} [{card}]")
    assert math.isfinite(dev_sweep) and all(math.isfinite(d)
                                            for d in blocks.values()), \
        f"{label}: a non-finite deviation {dev_sweep}, {blocks}"
    assert 0 < dev_sweep <= tprec.PRECISION_AGREEMENT_TOL, \
        f"{label}: one-sweep deviation {dev_sweep}"
    want = expected_launches(spec, 1, 0, 1, zeros, hM,
                             policy=policy)["mixed_gemm"]
    assert launches.get("mixed_gemm", 0) == want, \
        f"{label}: B10 launched {launches.get('mixed_gemm', 0)} times in " \
        f"the policy'd sweep, the schedule implies {want}"
    return dict(policy=policy.blocks, blocks=blocks, sweep=dev_sweep,
                launches=launches)


def expected_launches(spec, transient, samples, thin, adapt_nf, hM,
                      cg_loop=(), updater=None, policy=None, site=False):
    """Kernel launches the sweep schedule implies: Z once at start and once
    a sweep: on a model with Poisson columns the whole Z update is B5's
    mixed form (``updaters.mixed_z``: no B1 launch), else for probit
    columns B1 (its fused form where Z's probit branch is the linear
    predictor's only reader, ``updaters.fused_z``, else its E-reading
    form);
    BetaLambda and each level's Eta systems (B2, where P <= 16) each sweep;
    the GammaV block each sweep (B4, where ``ops.rand.gamma_v_route``
    allows; else its Wishart diagonal through B3's element form); where a
    dispersion is estimated, the residual precisions each sweep, plus the
    Nf move's psi and delta draws while it <= adapt_nf (B3's element
    form); each level's shrinkage update each sweep (B3's shrinkage form);
    with missing values the
    BetaLambda and each level's masked grams each sweep (B6).
    On an NNGP level, each sweep: the alpha grid quadratics and the
    scale interweave's quadratic, plus the location interweave's
    ones-forms where the design has an intercept (B8b); the dense factor
    below the dense/CG crossover (B8c, iW in one launch); above it one
    launch for every CG
    draw (B8a: ``cg_loop``, the iterations of each, as the port reports
    them, one entry a draw).  On a GPP level, each sweep:
    the per-unit blocks (B8d-1) and the knot correction (B8d-2) of the Eta
    draw, and the three quadratics as on NNGP (B8d-3).  With
    ``updater={"InterweaveDA": True}`` on a probit model with an intercept,
    the DA intercept draw each sweep (B7).

    Under a bf16 ``policy`` (``precision.resolve_policy``): B10 each sweep
    for each routed product of a policy'd block (BetaLambda's XE'XE and
    XE'Z without missing values, B6's bf16 form with them; GammaV's E E',
    iV Beta and (iV Beta) Tr where B4 does not take the block; the Eta
    block's X Beta, each level's two grams without missing values and its
    loadings; the location interweave's lam lam' and lam u a level, and a
    Full level's scale quadratic); a bf16 Eta block forms E, so Z's
    sweeps take B1's E-reading form (the start's Z update keeps the fused
    one).

    On a site mesh (``site``) an NNGP CG draw is B8e instead of B8a: the
    prior perturbation's riw_t form once, then the pmv form for the
    initial residual, each iteration and the final residual (the host
    loop, ``cg_frozen``): iterations + 3 launches a draw."""
    from hmsc_tpu_torch.mcmc import spatial as tspatial
    from hmsc_tpu_torch.mcmc import updaters as tupd
    from hmsc_tpu_torch.mcmc.structs import _find_ones_column

    from hmsc_tpu_torch.ops.rand import gamma_v_route

    sweeps = transient + samples * thin
    nf_sweeps = sum(min(a, sweeps) for a in adapt_nf)
    gv = gamma_v_route(spec.nc, spec.nt)
    per_sweep_gamma = int(not gv) + int(spec.any_estimated_sigma)
    systems = int(spec.nc + spec.nf_total <= 16) + sum(
        int(ls.nf_max <= 16) for ls in spec.levels if ls.spatial is None)
    nngp = [ls for ls in spec.levels if ls.spatial == "NNGP"]
    dense = sum(ls.n_units * ls.nf_max <= tspatial._NNGP_DENSE_MAX
                for ls in nngp)
    ones = _find_ones_column(hM) is not None
    quads = 2 + int(ones)
    gpp = sum(ls.spatial == "GPP" for ls in spec.levels)
    da = bool((updater or {}).get("InterweaveDA")) and spec.any_probit \
        and ones
    fused, mixed = tupd.fused_z(spec), tupd.mixed_z(spec)
    bf = (lambda b: policy is not None and policy.dtype_for(b)
          == "bfloat16")
    eta_block = "EtaSpatial" if any(ls.spatial for ls in spec.levels) \
        else "Eta"
    fused_sweep = fused and not bf(eta_block)
    b10 = 0
    if bf("BetaLambda"):
        b10 += 2 * (not spec.has_na)
    if bf("GammaV"):
        b10 += 3 * (not gv)
    if bf(eta_block) and spec.nr:
        b10 += 1 + 2 * spec.nr * (not spec.has_na) + spec.nr * (
            1 + (spec.nr > 1))
    if bf("Interweave") and spec.nr:
        b10 += 2 * spec.nr * ones + sum(ls.spatial == "Full"
                                        for ls in spec.levels)
    return {"probit_z": (int(not fused) + sweeps * (not fused_sweep))
            * spec.any_probit * (not mixed),
            "probit_z_fused": int(fused) + sweeps * fused_sweep,
            "mixed_gemm": sweeps * b10,
            "mvn_prec_small": sweeps * systems,
            "standard_gamma": sweeps * per_sweep_gamma + 2 * nf_sweeps,
            "shrinkage_gamma": sweeps * spec.nr,
            "gamma_v": sweeps * gv,
            "poisson_z": (1 + sweeps) * spec.any_poisson,
            "masked_gram": sweeps * (1 + spec.nr) * spec.has_na,
            "vecchia_apply": 0 if site else len(cg_loop),
            "vecchia_site": sum(cg_loop) + 3 * len(cg_loop) if site else 0,
            "nngp_quad": sweeps * quads * len(nngp),
            "nngp_riw": sweeps * dense,
            "gpp_unit": sweeps * gpp,
            "gpp_knot": sweeps * gpp,
            "gpp_quad": sweeps * quads * gpp,
            "truncnorm_da": sweeps * da,
            "serve_predict": 0, "serve_quantile": 0,
            "serve_conditional": 0}


def profile_sweeps(torch, ht, hM, card, label, n_chains, nf, sweeps=10,
                   updater=None, precision_policy=None):
    """Where a path's sweep time goes: device time by kernel name over a
    short profiled run (torch.profiler), against the run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(samples=sweeps, transient=0, n_chains=n_chains, seed=2,
              nf_cap=nf, align_post=False, updater=updater,
              precision_policy=precision_policy)
    ht.sample_mcmc(hM, **kw)                      # warm the same shapes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        post = ht.sample_mcmc(hM, **kw)
    wall_ms = post.timing["run_s"] * 1e3          # profiler overhead included
    rows = [(us / 1e3, e.count, e.key) for e, us in _device_rows(torch, prof)]
    busy_ms = sum(r[0] for r in rows)
    print(f"profile {label}: {sweeps} sweeps + record: run {wall_ms:.1f} ms"
          f", device kernel time {busy_ms:.1f} ms (busy share "
          f"{busy_ms / wall_ms:.3f}), {sum(r[1] for r in rows)} kernel "
          f"launches [{card}]")
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        print(f"profile {label}:   {ms:9.3f} ms  {n:6d} x  {key[:80]}")


def run_path(torch, ht, K, card, label, hM, n_chains, nf, transient,
             samples, seed, updater=None, precision_policy=None):
    """One main path through ``sample_mcmc`` with every launch counter set
    to 0 just before and read just after; each count must equal the one
    the schedule implies.  Returns the posterior and the counts."""
    from hmsc_tpu_torch.mcmc.precision import resolve_policy
    from hmsc_tpu_torch.mcmc.structs import build_spec

    torch.cuda.synchronize()
    K.reset_launches()
    post = ht.sample_mcmc(hM, samples=samples, transient=transient,
                          n_chains=n_chains, seed=seed, nf_cap=nf,
                          updater=updater, precision_policy=precision_policy)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    spec = build_spec(hM, nf)
    want = expected_launches(spec, transient, samples, 1,
                             (transient,) * spec.nr, hM,
                             post.cg_iterations["loop"], updater,
                             resolve_policy(precision_policy, spec))
    beta = post["Beta"]
    assert beta.shape == (n_chains, samples, spec.nc, spec.ns), label
    assert np.isfinite(beta).all(), f"{label}: non-finite Beta"
    assert post.chain_health["good_chains"].all(), f"{label}: divergence"
    assert launches == want, (f"{label}: launches {launches}, the schedule "
                              f"implies {want}")
    run_s = post.timing["run_s"]
    print(f"{label}: {spec.ny} x {spec.ns}, nf_max {nf}, {n_chains} chains, "
          f"transient {transient}, samples {samples}: run {run_s:.3f} s "
          f"(setup {post.timing['setup_s']:.3f} s), "
          f"{n_chains * samples / run_s:.2f} samples/s, "
          f"{n_chains * (transient + samples) / run_s:.2f} chain-sweeps/s; "
          f"launches {launches} [{card}]")
    return post, launches


def spatial_paths(torch, ht, K, card, by_path):
    """(d)-(f): config 3a (Full), 3b (NNGP, CG) and the 3b generator below
    the dense/CG crossover (NNGP, dense), each through ``run_path`` with
    its launches recorded in ``by_path``, slope recovery above 0.9 and each
    factor's posterior-mean alpha within ``ALPHA_MARGIN`` of the grid's
    range of the JAX package's.  Returns the models by path."""
    spatial = {}
    for name, c in CONFIG3.items():
        m = config3_model(ht, name)
        post, by_path[name] = run_path(
            torch, ht, K, card, name, m, c["n_chains"], CONFIG3_NF,
            c["transient"], c["samples"], CONFIG3_SEED)
        spatial[name] = m
        corr = slope_corr(post, config3_data(name)[4])
        assert corr > 0.9, f"{name}: slope correlation {corr} <= 0.9"
        grid_max = float(m.ranLevels[0].alphapw[-1, 0])
        got, ref = alpha_mean(post, m), CONFIG3_JAX_ALPHA[name]
        for f, (a, r) in enumerate(zip(got, ref)):
            assert abs(a - r) <= ALPHA_MARGIN * grid_max, (
                f"{name}: posterior-mean alpha of factor {f} {a} is more "
                f"than {ALPHA_MARGIN} x {grid_max:.3f} from the JAX "
                f"package's {r}")
        cg = post.cg_iterations
        cg_txt = ("no CG draws" if not cg["loop"] else
                  f"CG iterations per sweep: loop mean "
                  f"{np.mean(cg['loop']):.2f}, max {max(cg['loop'])}; "
                  f"per chain mean {cg['chains'].mean():.2f}, max "
                  f"{int(cg['chains'].max())}")
        print(f"{name} recovery: corr(posterior-mean slopes, simulated) = "
              f"{corr:.4f} (> 0.9); posterior-mean alpha per factor "
              f"{[round(a, 4) for a in got]} (the JAX package on the CPU: "
              f"{ref}; margin {ALPHA_MARGIN} x the grid's {grid_max:.4f}); "
              f"{cg_txt}")
    return spatial


# the sites phase: SITE_RANKS gloo ranks on the one card, spawned once;
# each path's sample_mcmc at a depth cut from its single-card path's
SITE_RANKS = 2
SITE_SWEEPS = 3                 # sweeps of each agreement case
SITE_PATHS = {"config3b_sites": dict(transient=50, samples=100),
              "headline_sites": dict(transient=10, samples=50)}


def sites_phase(torch, ht, K, card, by_path, hM_h, Beta_h, hM_3b):
    """The site-sharded sweep on SITE_RANKS ranks of one card (gloo,
    ``spawn_ranks``; the kernels were built before the spawn): on config
    3b at its published widths and on the headline, the state after
    SITE_SWEEPS sweeps within SHARD_AGREEMENT_TOL of the single-rank
    sweep's from the same seed, the ranks bit-identical; then
    ``sample_mcmc(mesh=...)`` on each at a cut depth, finite draws, the
    ranks' Posteriors identical, 3b's slope and alpha gates and the
    headline's slope gate, the launches the schedule implies (on 3b B8e
    and no B8a).  Also times one all_reduce of 3b's CG iterate."""
    from hmsc_tpu_torch.mcmc.partition import SHARD_AGREEMENT_TOL
    from hmsc_tpu_torch.mcmc.site_check import run_site_cases
    from hmsc_tpu_torch.mcmc.structs import build_spec

    h, c3 = HEADLINE, CONFIG3["config3b"]
    models = {"config3b_sites": (hM_3b, c3["n_chains"], CONFIG3_NF,
                                 CONFIG3_SEED),
              "headline_sites": (hM_h, h["n_chains"], h["nf"],
                                 HEADLINE_SEED)}
    cases = []
    for label, (m, chains, nf, seed) in models.items():
        cases.append(dict(kind="sweeps", hM=m, n_sweeps=SITE_SWEEPS,
                          seed=seed, n_chains=chains, nf_cap=nf))
        d = SITE_PATHS[label]
        cases.append(dict(kind="sample", hM=m, kw=dict(
            samples=d["samples"], transient=d["transient"],
            n_chains=chains, seed=seed, nf_cap=nf)))
    cases.append(dict(kind="all_reduce", shape=(c3["n_chains"], c3["np"],
                                                 CONFIG3_NF), calls=200))
    t0 = time.perf_counter()
    out = ht.spawn_ranks(run_site_cases, SITE_RANKS, "gloo", "cuda",
                         (SITE_RANKS, "gloo", "cuda", cases), timeout_s=600)
    print(f"sites: {SITE_RANKS} gloo ranks on cuda:0 through spawn_ranks, "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start; a "
          f"correctness run: gloo stages every collective through host "
          f"memory, so its times say nothing about scaling across cards "
          f"[{card}]")
    for i, (label, (m, chains, nf, seed)) in enumerate(models.items()):
        sw, sm = [r[2 * i] for r in out], [r[2 * i + 1] for r in out]
        errs = {}
        for key, want in sw[0]["replicated"].items():
            got = sw[0]["sharded"][key]
            assert np.isfinite(got.astype(float)).all(), f"{label}: {key}"
            a, b = want.astype(float), got.astype(float)
            errs[key] = float(np.abs(a - b).max()
                              / max(np.abs(a).max(), 1e-6))
        worst = max(errs, key=errs.get)
        assert errs[worst] <= SHARD_AGREEMENT_TOL, (
            f"{label}: {worst} off the single-rank sweep by {errs[worst]}")
        for r in range(1, SITE_RANKS):
            for key in sw[0]["sharded"]:
                assert np.array_equal(sw[0]["sharded"][key],
                                      sw[r]["sharded"][key]), (
                    f"{label}: rank {r}'s {key} differs from rank 0's")
        print(f"{label} agreement: {SITE_SWEEPS} sweeps on {SITE_RANKS} "
              f"ranks against the single-rank sweep from one seed: largest "
              f"normalised deviation {errs[worst]:.3g} ({worst}; tolerance "
              f"{SHARD_AGREEMENT_TOL}); the ranks' states bit-identical; "
              f"sharded sweeps' launches {sw[0]['launches']}")
        d = SITE_PATHS[label]
        post = sm[0]
        for r in range(1, SITE_RANKS):
            for key in post["arrays"]:
                assert np.array_equal(post["arrays"][key],
                                      sm[r]["arrays"][key]), (
                    f"{label}: rank {r}'s posterior {key} differs")
        beta = post["arrays"]["Beta"]
        assert np.isfinite(beta).all(), f"{label}: non-finite Beta"
        assert (post["first_bad_it"] < 0).all(), f"{label}: divergence"
        assert post["site_shards"] == SITE_RANKS
        spec = build_spec(m, nf)
        loop = post["cg_iterations"]["loop"]
        want = expected_launches(spec, d["transient"], d["samples"], 1,
                                 (d["transient"],) * spec.nr, m, loop,
                                 site=True)
        assert post["launches"] == want, (
            f"{label}: launches {post['launches']}, the schedule implies "
            f"{want}")
        by_path[label] = post["launches"]
        slope = beta[:, :, 1, :].mean(axis=(0, 1))
        truth = Beta_h if label == "headline_sites" else \
            config3_data("config3b")[4]
        corr = float(np.corrcoef(slope, truth[1])[0, 1])
        assert corr > 0.9, f"{label}: slope correlation {corr} <= 0.9"
        gate = f"corr(posterior-mean slopes, simulated) {corr:.4f} (> 0.9)"
        if label == "config3b_sites":
            assert post["launches"]["vecchia_site"] > 0
            assert post["launches"]["vecchia_apply"] == 0
            grid = m.ranLevels[0].alphapw[:, 0]
            got = grid[post["arrays"]["Alpha_0"]].mean(axis=(0, 1))
            ref = CONFIG3_JAX_ALPHA["config3b"]
            for f, (a, rr) in enumerate(zip(got, ref)):
                assert abs(a - rr) <= ALPHA_MARGIN * float(grid[-1]), (
                    f"{label}: posterior-mean alpha of factor {f} {a} is "
                    f"more than {ALPHA_MARGIN} x the grid's range from the "
                    f"JAX package's {rr}")
            gate += (f"; posterior-mean alpha {np.round(got, 4).tolist()} "
                     f"(the JAX package: {ref}, margin {ALPHA_MARGIN} x "
                     f"{float(grid[-1]):.4f}); CG iterations a draw: mean "
                     f"{np.mean(loop):.2f}, max {max(loop)}")
            ar = out[0][-1]
            n_it = sum(loop)
            run_s = post["timing"]["run_s"]
            print(f"{label} all_reduce: one of the CG iterate "
                  f"({c3['n_chains']} x {c3['np']} x {CONFIG3_NF} float32, "
                  f"{ar['bytes']} bytes) {ar['ms']:.4f} ms a call "
                  f"(gloo through host memory, 200 calls), one a CG "
                  f"iteration: {n_it} iterations x {ar['ms']:.4f} ms = "
                  f"{n_it * ar['ms'] / 1e3:.3f} s of the run's "
                  f"{run_s:.3f} s [{card}]")
        run_s = post["timing"]["run_s"]
        sweeps = d["transient"] + d["samples"]
        print(f"{label}: {spec.ny} x {spec.ns}, nf_max {nf}, {chains} "
              f"chains on {SITE_RANKS} ranks, transient {d['transient']}, "
              f"samples {d['samples']} (depth cut from the single-card "
              f"path's): run {run_s:.3f} s, "
              f"{chains * d['samples'] / run_s:.2f} samples/s, "
              f"{chains * sweeps / run_s:.2f} chain-sweeps/s "
              f"(gloo through host: not a scaling figure); {gate}; "
              f"launches on rank 0 {post['launches']} [{card}]")


def serve_path(torch, ht, K, card, post, hM):
    """(i) the serve path on the headline posterior (800 draws): every
    launch counter set to 0, then the engine's phases through the user's
    entry points (``ServingEngine``, ``warmup``, ``predict`` / ``submit``,
    ``reload``, ``make_server``) and offline ``predict``; the counters are
    read, then the answers are held against their references.  Returns
    the launches, the numbers printed, and the checks' worst errors."""
    import threading
    import urllib.request

    from hmsc_tpu_torch.ops import serve as tserve
    from hmsc_tpu_torch.predict.predict import OFFLINE_CHUNK
    from hmsc_tpu_torch.serve.http import make_server

    Xall = np.asarray(hM.X, dtype=np.float32)
    ny, ns = Xall.shape[0], hM.ns
    lvl = hM.rl_names[0]
    labels = [str(v) for v in hM.df_pi[0]]
    rows64 = np.arange(64)
    X64, units64 = Xall[rows64], {lvl: [labels[i] for i in rows64]}
    held = slice(ns // 2, ns)
    Yc = hM.Y[rows64].astype(np.float32)
    Yc[:, held] = np.nan
    new_unit = np.array([["__new__"]])
    rng = np.random.default_rng(17)
    stats_at = {}
    offline_chunks = 0

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    engine = ht.ServingEngine(post, coalesce_ms=2.0)
    stage_s = time.perf_counter() - t0
    built = engine.warmup()
    # 2. fidelity: the 1000 training rows at their units, served and offline
    served = engine.predict(Xall, units={lvl: labels})
    stats_at["fidelity"] = engine.stats()["device_calls"]
    offline = ht.predict(post, expected=True)
    offline_chunks += -(-ny // OFFLINE_CHUNK)
    off_mean, off_sd = offline.mean(axis=0), offline.std(axis=0)
    del offline
    # 3. sampled against expected on a 64-row query
    sampled = engine.predict(X64, units=units64, expected=False)
    expect = engine.predict(X64, units=units64)
    # 4. quantiles through B9c
    quant = engine.predict(X64, units=units64, quantiles=SERVE_Q)
    # 5. conditional recovery: 64 training rows served as new units
    marg = engine.predict(X64)
    cond = engine.predict(X64, Yc=Yc, mcmc_step=3)
    cond_calls = 1
    # 6. micro-batching: 64 concurrent single-row submits
    serial = [engine.predict(Xall[i:i + 1], units={lvl: [labels[i]]})
              for i in rows64]
    before = engine.stats()
    futs = [engine.submit(Xall[i:i + 1], units={lvl: [labels[i]]})
            for i in rows64]
    coalesced = [f.result(timeout=120) for f in futs]
    after = engine.stats()
    # 7. random query sizes after warmup, then a same-shape flip
    for q in rng.integers(1, 201, size=25):
        idx = rng.integers(0, ny, size=int(q))
        engine.predict(Xall[idx], units={lvl: [labels[i] for i in idx]})
    flip = engine.reload()
    engine.predict(X64, units=units64)
    swept = engine.stats()
    # 8. one HTTP POST /predict
    server = make_server(engine, "127.0.0.1", 0)
    host, port = server.server_address[:2]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    body = json.dumps({"X": Xall[:3].tolist(),
                       "units": {lvl: labels[:3]}}).encode()
    req = urllib.request.Request(f"http://{host}:{port}/predict", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        http_out = json.loads(r.read())
    server.shutdown()
    server.server_close()
    th.join(timeout=10)
    http_ref = engine.predict(Xall[:3], units={lvl: labels[:3]})
    # 10. latencies (printed, not gated)
    lat = []
    for i in range(200):
        t1 = time.perf_counter()
        engine.predict(Xall[i % ny][None], units={lvl: [labels[i % ny]]})
        lat.append((time.perf_counter() - t1) * 1e3)
    xs = [Xall[i:i + 1] for i in range(64)]
    coal_s = serial_s = np.inf
    for _ in range(3):
        t1 = time.perf_counter()
        for f in [engine.submit(x) for x in xs]:
            f.result(timeout=120)
        coal_s = min(coal_s, time.perf_counter() - t1)
    ht.predict(post, X=xs[0], study_design=new_unit, predict_eta_mean=True,
               expected=True)
    offline_chunks += 1
    for _ in range(3):
        t1 = time.perf_counter()
        for x in xs:
            ht.predict(post, X=x, study_design=new_unit,
                       predict_eta_mean=True, expected=True)
        serial_s = min(serial_s, time.perf_counter() - t1)
    offline_chunks += 3 * len(xs)
    cond_lat = []
    for _ in range(5):
        t1 = time.perf_counter()
        engine.predict(X64, Yc=Yc, mcmc_step=3)
        cond_lat.append((time.perf_counter() - t1) * 1e3)
    cond_calls += 5
    quant_lat = []
    for _ in range(QUANTILE_QUERIES):
        t1 = time.perf_counter()
        engine.predict(X64, units=units64, quantiles=SERVE_Q)
        quant_lat.append((time.perf_counter() - t1) * 1e3)
    final = engine.stats()
    torch.cuda.synchronize()
    launches = dict(K.launches)
    engine.close()

    # the references (after the counters were read: their launches are
    # not the path's)
    # 9. launches: B9a = the predict-config device calls (the warmup's
    # launches included) plus offline predict's chunks; B9b and B9c their
    # own calls; every sampler kernel 0
    want = {name: 0 for name in K.KERNELS}
    want["serve_predict"] = (built + final["device_calls"] - cond_calls
                             + offline_chunks)
    want["serve_conditional"] = cond_calls
    want["serve_quantile"] = 1 + QUANTILE_QUERIES
    # 2. fidelity against a float64 recomputation on the card, no kernel
    dev = engine.device
    d64 = dict(device=dev, dtype=torch.float64)
    Beta = torch.as_tensor(post.pooled("Beta"), **d64)
    lam = torch.as_tensor(post.pooled("Lambda_0")[..., 0], **d64)
    eta = torch.as_tensor(post.pooled("Eta_0"), **d64)
    pi = torch.as_tensor(np.asarray(hM.Pi[:, 0]), device=dev).long()
    Xd = torch.as_tensor(Xall, **d64)
    ref_mean = np.empty((ny, ns))
    ref_sd = np.empty((ny, ns))
    for c0 in range(0, ny, 100):
        sl = slice(c0, c0 + 100)
        L = (torch.einsum("yc,ncj->nyj", Xd[sl], Beta)
             + torch.einsum("nyf,nfj->nyj", eta[:, pi[sl]], lam))
        p = torch.special.ndtr(L)
        ref_mean[sl] = p.mean(dim=0).cpu().numpy()
        ref_sd[sl] = p.std(dim=0, correction=0).cpu().numpy()
    fid = {}
    for name, (m, s) in {"served": (served["mean"], served["sd"]),
                         "offline": (off_mean, off_sd)}.items():
        fid[name] = max(np.abs(m - ref_mean).max(), np.abs(s - ref_sd).max())
    fid["served_vs_offline"] = max(np.abs(served["mean"] - off_mean).max(),
                                   np.abs(served["sd"] - off_sd).max())
    # 3. each sampled mean, as a count of 1s over the draws, within the
    # 1e-9 tails of Binomial(n, expected mean) (the draws' probabilities
    # differ: the binomial is the widest law with that mean)
    sampled_ok = binomial_inside(sampled["mean"], expect["mean"],
                                 engine.n_draws)
    # 4. quantiles against torch.quantile of the same draws
    st = engine._staged
    uidx = torch.as_tensor(np.array([[st.unit_lut[0][labels[i]]
                                      for i in rows64]], dtype=np.int32),
                           device=dev)
    _, _, y = tserve.serve_predict(
        torch.as_tensor(X64, device=dev), uidx, st.Beta, st.sigma,
        list(st.lams), list(st.etas), st.fam_d, st.ym, st.ys, expected=True,
        moments=False, draws=True)
    q_ref = torch.quantile(y, torch.tensor(SERVE_Q, device=dev), dim=0)
    q_err = np.abs(quant["quantiles"] - q_ref.cpu().numpy()).max()
    # 5. conditional recovery on the held-out species
    y_held = hM.Y[rows64][:, held]
    brier_c = float(((cond["mean"][:, held] - y_held) ** 2).mean())
    brier_m = float(((marg["mean"][:, held] - y_held) ** 2).mean())
    # 6. coalescing
    calls = after["device_calls"] - before["device_calls"]
    mb_err = max(np.abs(c["mean"] - s["mean"]).max()
                 for c, s in zip(coalesced, serial))
    # 8. HTTP
    http_err = np.abs(np.asarray(http_out["mean"]) - http_ref["mean"]).max()

    lat = np.asarray(lat)
    nums = dict(stage_s=stage_s, p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)),
                coalesced_s=coal_s, serial_s=serial_s,
                ratio=serial_s / coal_s,
                cond_ms=float(np.median(cond_lat)),
                quant_p50_ms=float(np.percentile(quant_lat, 50)),
                quant_p99_ms=float(np.percentile(quant_lat, 99)),
                brier_cond=brier_c, brier_marg=brier_m,
                coalesced_calls=calls, plans_built=built)
    print(f"serve: headline posterior, {engine.n_draws} draws x {ns} "
          f"species, staged in {stage_s:.3f} s, {built} plans at warmup; "
          f"fidelity max |served - float64| {fid['served']:.3g}, |offline "
          f"- float64| {fid['offline']:.3g}, |served - offline| "
          f"{fid['served_vs_offline']:.3g} (2e-5); {ny} rows in "
          f"{stats_at['fidelity']} calls; sampled means inside the "
          f"binomial 1e-9 tails: {sampled_ok}; quantiles vs torch.quantile "
          f"{q_err:.3g} (1e-6); conditional Brier {brier_c:.5f} vs "
          f"marginal {brier_m:.5f} on 64 x {ns - ns // 2} held-out cells; "
          f"64 concurrent queries in {calls} calls (max diff to serial "
          f"{mb_err:.3g}); plan builds {swept['cache']['misses']} (warmup "
          f"{built} + 3); HTTP max diff {http_err:.3g}; launches "
          f"{ {k: v for k, v in launches.items() if v} } [{card}]")
    print(f"serve latency: single-row expected p50 {nums['p50_ms']:.3f} ms,"
          f" p99 {nums['p99_ms']:.3f} ms over 200 sync queries; 64 "
          f"concurrent coalesced {coal_s * 1e3:.2f} ms vs 64 serial offline "
          f"predict() {serial_s * 1e3:.2f} ms ({nums['ratio']:.2f}x); "
          f"conditional B 64, mcmc_step 3: {nums['cond_ms']:.3f} ms; "
          f"quantile query B 64, q {SERVE_Q}: p50 {nums['quant_p50_ms']:.3f} "
          f"ms, p99 {nums['quant_p99_ms']:.3f} ms over {QUANTILE_QUERIES} "
          f"[{card}]")

    assert launches == want, (f"serve: launches {launches}, the path "
                              f"implies {want}")
    for k, v in fid.items():
        assert v <= 2e-5, f"serve fidelity {k}: {v} > 2e-5"
    assert stats_at["fidelity"] == -(-ny // 64), \
        f"serve: {ny} rows in {stats_at['fidelity']} device calls"
    assert sampled_ok, "serve sampled: a mean beyond the binomial 1e-9 tails"
    assert q_err <= 1e-6, f"serve quantiles vs torch.quantile: {q_err}"
    assert np.isfinite(cond["mean"]).all() and np.isfinite(cond["sd"]).all()
    assert cond["mean"].min() >= 0 and cond["mean"].max() <= 1
    assert brier_c < brier_m, (f"serve conditional: Brier {brier_c} not "
                               f"below the marginal {brier_m}")
    assert calls < 64, f"serve: 64 concurrent queries took {calls} calls"
    assert mb_err <= 1e-6, f"serve coalesced vs serial: {mb_err}"
    # 7. no plan built by the size sweep and the same-shape flip (the
    # warmed expected config; phases 3-5 built the sampled, quantile and
    # conditional plans)
    assert swept["cache"]["misses"] == after["cache"]["misses"] \
        == built + 3, f"serve: plan builds {swept['cache']}"
    assert not flip["shapes_changed"] and flip["generation"] == 1
    assert http_err <= 1e-6, f"serve HTTP vs engine: {http_err}"
    for out in (served, sampled, expect, marg):
        assert np.isfinite(out["mean"]).all() and np.isfinite(out["sd"]).all()
    return launches, nums


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import hmsc_tpu_torch as ht
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import gram as tgram
    from hmsc_tpu_torch.ops import linalg as tlinalg
    from hmsc_tpu_torch.ops import mixed as tmixed
    from hmsc_tpu_torch.ops import rand as trand
    from hmsc_tpu_torch.ops import serve as tserve
    from hmsc_tpu_torch.ops import spatial as tsp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    K.library()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(K.KERNELS)} kernels (nvcc, sm_90a)")

    results = {**check_b1(torch, trand, dev, card),
               "mvn_prec_small": check_b2(torch, tlinalg, trand, dev, card),
               "standard_gamma": check_b3(torch, trand, dev, card),
               "shrinkage_gamma": check_b3_shrinkage(torch, trand, dev, card),
               "gamma_v": check_b4(torch, trand, dev, card),
               "poisson_z": check_b5(torch, trand, dev, card),
               "masked_gram": check_b6(torch, tgram, dev, card),
               "vecchia_apply": check_b8a(torch, tsp, dev, card),
               "vecchia_site": check_b8e(torch, tsp, dev, card),
               "nngp_quad": check_b8b(torch, tsp, dev, card),
               "nngp_riw": check_b8c(torch, tsp, dev, card),
               **check_b8d(torch, tsp, dev, card),
               "truncnorm_da": check_b7(torch, trand, dev, card),
               "serve_predict": check_b9a(torch, tserve, K, dev, card),
               "serve_quantile": check_b9c(torch, tserve, dev, card),
               "serve_conditional": check_b9b(torch, tserve, dev, card),
               "mixed_gemm": check_b10(torch, tmixed, dev, card)}
    for name, extra in check_bf16_forms(torch, trand, tgram, tsp, dev,
                                        card).items():
        results[name].update(extra)

    # recovery: posterior-mean slopes against the simulated ones
    X, Y, Beta = simulate_probit(200, 30, seed=3)
    post = ht.sample_mcmc(probit_model(ht, X, Y, nf=4), samples=200,
                          transient=200, n_chains=2, seed=1)
    slope = post["Beta"][:, :, 1, :].mean(axis=(0, 1))
    corr = float(np.corrcoef(slope, Beta[1])[0, 1])
    assert np.isfinite(post["Beta"]).all(), "recovery: non-finite Beta"
    assert corr > 0.9, f"recovery: slope correlation {corr} <= 0.9"
    print(f"recovery: 200 x 30 probit, 2 chains, 200 + 200 sweeps: "
          f"corr(posterior-mean slopes, simulated) = {corr:.4f} (> 0.9)")

    # (a) the headline: the probit path through the user's entry point
    h = HEADLINE
    X, Y, Beta_h = simulate_probit(h["ny"], h["ns"],
                                   seed=HEADLINE_DATA_SEED)
    hM = probit_model(ht, X, Y, nf=h["nf"])
    post_h, launches = run_path(torch, ht, K, card, "headline", hM,
                                h["n_chains"], h["nf"], h["transient"],
                                h["samples"], seed=HEADLINE_SEED)
    by_path = {"headline": launches}
    check_headline_parity(post_h, card)

    # (b) config 5: normal / probit / lognormal-Poisson columns
    c5 = CONFIG5
    hM5 = config5_model(ht)
    post5, by_path["config5"] = run_path(
        torch, ht, K, card, "config5", hM5, c5["n_chains"], c5["nf"],
        c5["transient"], c5["samples"], c5["seed"])
    corr5 = block_slope_corr(post5, config5_data()[3])
    for name, corr, ref in zip(("normal", "probit", "lognormal poisson"),
                               corr5, CONFIG5_JAX_SLOPE_CORR):
        floor = min(0.9, ref - 0.05)
        assert corr > floor, f"config5 {name}: slope corr {corr} <= {floor}"
        print(f"config5 recovery, {name} columns: corr(posterior-mean "
              f"slopes, simulated) = {corr:.4f} (> {floor:.4f}; the JAX "
              f"package on the CPU: {ref:.4f})")

    # (c) the headline with missing values
    na = NA_HEADLINE
    Y_na = Y.copy()
    Y_na[np.random.default_rng(7).uniform(size=Y.shape) < na["na_share"]] \
        = np.nan
    hM_na = probit_model(ht, X, Y_na, nf=na["nf"])
    post_na, by_path["na_headline"] = run_path(
        torch, ht, K, card, "na_headline", hM_na, na["n_chains"], na["nf"],
        na["transient"], na["samples"], seed=1)
    slope = post_na["Beta"][:, :, 1, :].mean(axis=(0, 1))
    corr = float(np.corrcoef(slope, Beta_h[1])[0, 1])
    assert corr > 0.9, f"na_headline: slope correlation {corr} <= 0.9"
    print(f"na_headline recovery: {np.isnan(Y_na).mean():.4f} of Y missing;"
          f" corr(posterior-mean slopes, simulated) = {corr:.4f} (> 0.9)")

    # (d) the headline with the probit-DA intercept interweave
    da = DA_HEADLINE
    da_upd = {"InterweaveDA": True}
    post_da, by_path["da_headline"] = run_path(
        torch, ht, K, card, "da_headline", hM, da["n_chains"], da["nf"],
        da["transient"], da["samples"], seed=1, updater=da_upd)
    corr = slope_corr(post_da, Beta_h)
    assert corr > 0.9, f"da_headline: slope correlation {corr} <= 0.9"
    print(f"da_headline recovery: corr(posterior-mean slopes, simulated) = "
          f"{corr:.4f} (> 0.9)")

    spatial = spatial_paths(torch, ht, K, card, by_path)
    check_alpha_planted(torch, ht, card)

    # (k) the sites phase: 3b and the headline on 2 gloo ranks of the card
    sites_phase(torch, ht, K, card, by_path, hM, Beta_h,
                spatial["config3b"])

    # (j) the precision phase: the headline fitted under the default
    # mixed-precision policy (B10, B4's bf16 form), then one policy'd sweep
    # against the float32 sweep on six paths
    post_p, by_path["headline_auto"] = run_path(
        torch, ht, K, card, "headline_auto", hM, h["n_chains"], h["nf"],
        h["transient"], h["samples"], seed=HEADLINE_SEED,
        precision_policy="auto")
    assert post_p.precision_policy["blocks"] == ["BetaLambda", "GammaV"]
    corr = slope_corr(post_p, Beta_h)
    assert corr > 0.9, f"headline_auto: slope correlation {corr} <= 0.9"
    print(f"headline_auto recovery: corr(posterior-mean slopes, simulated) "
          f"= {corr:.4f} (> 0.9); policy {post_p.precision_policy}")
    check_headline_parity(post_p, card)
    del post_p
    one_sweep = {}
    for label, m, n_chains, nf in (
            ("headline", hM, h["n_chains"], h["nf"]),
            ("na_headline", hM_na, na["n_chains"], na["nf"]),
            *((name, spatial[name], CONFIG3[name]["n_chains"], CONFIG3_NF)
              for name in ("config3a", "config3b", "dense_nngp",
                           "config3c"))):
        one_sweep[label] = policy_one_sweep(torch, ht, trand, K, card, label,
                                            m, nf, n_chains, dev)
    for label, kern in (("na_headline", "masked_gram"),
                        ("dense_nngp", "nngp_riw"), ("config3b", "nngp_quad"),
                        ("headline", "gamma_v")):
        n = one_sweep[label]["launches"].get(kern, 0)
        assert n > 0, f"{label}: the policy'd sweep never launched {kern}"
        results[kern]["bf16_launches_one_sweep"] = {label: n}

    # (i) serving the headline posterior
    by_path["serve"], _ = serve_path(torch, ht, K, card, post_h, hM)
    del post_h

    for label, m, n_chains, nf in (("headline", hM, h["n_chains"], h["nf"]),
                                   ("config5", hM5, c5["n_chains"], c5["nf"]),
                                   ("na_headline", hM_na, na["n_chains"],
                                    na["nf"]),
                                   ("config3a", spatial["config3a"],
                                    CONFIG3["config3a"]["n_chains"],
                                    CONFIG3_NF),
                                   ("config3b", spatial["config3b"],
                                    CONFIG3["config3b"]["n_chains"],
                                    CONFIG3_NF),
                                   ("config3c", spatial["config3c"],
                                    CONFIG3["config3c"]["n_chains"],
                                    CONFIG3_NF)):
        profile_sweeps(torch, ht, m, card, label, n_chains, nf)
    profile_sweeps(torch, ht, hM, card, "da_headline", da["n_chains"],
                   da["nf"], updater=da_upd)
    profile_sweeps(torch, ht, hM, card, "headline_auto", h["n_chains"],
                   h["nf"], precision_policy="auto")

    # kernel -> (label, source, the TPU op it replaces, the path whose
    # launches the line reports: the first that runs it)
    meta = {
        "probit_z": ("B1 probit_z", "hmsc_tpu_torch/csrc/probit_z.cu",
                     "hmsc_tpu/ops/rand.py:84", "na_headline"),
        "probit_z_fused": ("B1 probit_z_fused",
                           "hmsc_tpu_torch/csrc/probit_z.cu",
                           "hmsc_tpu/ops/rand.py:84", "headline"),
        "mvn_prec_small": ("B2 mvn_prec_small",
                           "hmsc_tpu_torch/csrc/mvn_prec_small.cu",
                           "hmsc_tpu/ops/linalg.py:63", "headline"),
        "standard_gamma": ("B3 standard_gamma",
                           "hmsc_tpu_torch/csrc/standard_gamma.cu",
                           "hmsc_tpu/ops/rand.py:124", "headline"),
        "shrinkage_gamma": ("B3 shrinkage_gamma",
                            "hmsc_tpu_torch/csrc/shrinkage_gamma.cu",
                            "hmsc_tpu/mcmc/updaters.py:539", "headline"),
        "gamma_v": ("B4 gamma_v", "hmsc_tpu_torch/csrc/gamma_v.cu",
                    "hmsc_tpu/ops/rand.py:217", "headline"),
        "poisson_z": ("B5 poisson_z", "hmsc_tpu_torch/csrc/poisson_z.cu",
                      "hmsc_tpu/ops/rand.py:172", "config5"),
        "masked_gram": ("B6 masked_gram",
                        "hmsc_tpu_torch/csrc/masked_gram.cu",
                        "hmsc_tpu/mcmc/updaters.py:246", "na_headline"),
        "vecchia_apply": ("B8a vecchia_apply",
                          "hmsc_tpu_torch/csrc/vecchia_apply.cu",
                          "hmsc_tpu/mcmc/spatial.py:61", "config3b"),
        "vecchia_site": ("B8e vecchia_site",
                         "hmsc_tpu_torch/csrc/vecchia_site.cu",
                         "hmsc_tpu/mcmc/spatial.py:88", "config3b_sites"),
        "nngp_quad": ("B8b nngp_quad", "hmsc_tpu_torch/csrc/nngp_quad.cu",
                      "hmsc_tpu/mcmc/spatial.py:415", "config3b"),
        "nngp_riw": ("B8c nngp_riw", "hmsc_tpu_torch/csrc/nngp_riw.cu",
                     "hmsc_tpu/mcmc/spatial.py:213", "dense_nngp"),
        "gpp_unit": ("B8d-1 gpp_unit", "hmsc_tpu_torch/csrc/gpp_unit.cu",
                     "hmsc_tpu/mcmc/spatial.py:151", "config3c"),
        "gpp_knot": ("B8d-2 gpp_knot", "hmsc_tpu_torch/csrc/gpp_knot.cu",
                     "hmsc_tpu/mcmc/spatial.py:178", "config3c"),
        "gpp_quad": ("B8d-3 gpp_quad", "hmsc_tpu_torch/csrc/gpp_quad.cu",
                     "hmsc_tpu/mcmc/spatial.py:426", "config3c"),
        "truncnorm_da": ("B7 truncnorm_da",
                         "hmsc_tpu_torch/csrc/truncnorm_da.cu",
                         "hmsc_tpu/ops/rand.py:25", "da_headline"),
        "serve_predict": ("B9a serve_predict",
                          "hmsc_tpu_torch/csrc/serve_predict.cu",
                          "hmsc_tpu/serve/kernels.py:140", "serve"),
        "serve_quantile": ("B9c serve_quantile",
                           "hmsc_tpu_torch/csrc/serve_quantile.cu",
                           "hmsc_tpu/serve/kernels.py:181", "serve"),
        "serve_conditional": ("B9b serve_conditional",
                              "hmsc_tpu_torch/csrc/serve_conditional.cu",
                              "hmsc_tpu/serve/kernels.py:255", "serve"),
        "mixed_gemm": ("B10 mixed_gemm", "hmsc_tpu_torch/csrc/mixed_gemm.cu",
                       "hmsc_tpu/ops/mixed.py:121", "headline_auto"),
    }
    assert set(meta) == set(K.KERNELS) == set(results)
    kernels = []
    for name, (label, src, replaces, path) in meta.items():
        r = results[name]
        assert by_path[path][name] > 0, f"{path}: {name} never launched"
        kernels.append({"name": label, "ok": True, "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": by_path[path][name], "path": path,
                        "launches_by_path": {p: n[name]
                                             for p, n in by_path.items()},
                        **r})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
