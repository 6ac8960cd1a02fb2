#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hmsc_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Device: the card's name and power limit (nvidia-smi), then the build of
   every hand-written kernel from ``hmsc_tpu_torch/csrc`` with nvcc.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the headline model gives it (tolerances stated at each check).
3. Times: each kernel's device time per launch (torch.profiler, after
   warm-up) beside its plain version's device time per call, the one-call
   PyTorch yardstick where there is one, and the least time the card could
   take for the same work (bytes over 3.35 TB/s or float32 operations over
   67 TFLOP/s, the larger).  Beside them, the CUDA-event time of a batch of
   calls per call, which includes the host's enqueue where that is slower.
4. Recovery: a 200 x 30 probit model; posterior-mean slopes must correlate
   > 0.9 with the simulated ones.
5. Headline: ``sample_mcmc`` on the 1000-site x 1000-species probit JSDM,
   nf_max = 8, 4 chains, with every kernel's launch counter set to 0 just
   before and read just after; each count must equal the one the sweep
   schedule implies.  Then a short torch.profiler window over ten
   headline sweeps: device time by kernel against the run's wall time.
6. One JSON line with every kernel's numbers, then the result line.

It needs the repository (it imports ``hmsc_tpu_torch`` from beside itself)
and a CUDA card, and exits non-zero without either.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores

HEADLINE = dict(ny=1000, ns=1000, nf=8, n_chains=4, transient=10,
                samples=200)


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


def device_ms(torch, fn, match=None, calls=50, warm=3):
    """Device time per call of ``fn`` from torch.profiler: the time of the
    kernels whose name contains ``match`` (all of the call's device work
    when None), summed over ``calls`` calls and divided by ``calls``.  The
    host's enqueue cost is not in it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
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
    assert us > 0, f"profiler saw no device time for {match or 'the call'}"
    if match is not None:
        assert n == calls, f"{match}: {n} kernels profiled for {calls} calls"
    return us / 1e3 / calls


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


def check_b1(torch, trand, dev, card):
    C, ny, ns = HEADLINE["n_chains"], HEADLINE["ny"], HEADLINE["ns"]
    g = torch.Generator(device=dev).manual_seed(0)
    E = torch.randn((C, ny, ns), generator=g, device=dev) * 3.0
    k = min(200, ns)
    E[:, 0, :k] = torch.linspace(-40.0, 40.0, k, device=dev)      # |t| > 9
    std = torch.rand((C, ns), generator=g, device=dev) * 1.5 + 0.5
    Y = (torch.rand((ny, ns), generator=g, device=dev) < 0.5).float()
    u = torch.rand((C, ny, ns), generator=g, device=dev).clamp_min_(1e-38)
    u[:, 1, :] = 1.0 - 2.0 ** -24                  # within one ulp of 1
    t = torch.where(Y > 0.5, -E / std[:, None, :], E / std[:, None, :])
    assert (t > 9).any() and (t < -9).any()
    zk = trand.truncated_normal_onesided(E, std, Y, u=u)
    zp = trand._truncated_normal_onesided_plain(E, std, Y, u)
    err = ((zk - zp).abs() / std[:, None, :]).max().item()
    assert torch.isfinite(zk).all(), "B1: non-finite draws"
    assert err <= 1e-4, f"B1 injected uniforms: max |diff|/std {err} > 1e-4"
    print(f"B1 check: injected uniforms, max |kernel - plain| / std = "
          f"{err:.3g} (tolerance 1e-4)")

    rng = trand.Rng(7, dev)
    wk = (trand.truncated_normal_onesided(E, std, Y, rng) - E) / std[:, None]
    wp = (trand._truncated_normal_onesided_plain(
        E, std, Y, rng.uniform(E.shape)) - E) / std[:, None]
    for cls in (1.0, 0.0):
        m = (Y == cls).expand_as(E)
        a, b = wk[m].double(), wp[m].double()
        n = a.numel()
        se_m = math.sqrt((a.var() + b.var()).item() / n)
        dm = abs((a.mean() - b.mean()).item())
        va, vb = a.var().item(), b.var().item()
        se_v = math.sqrt((((a - a.mean()) ** 4).mean().item() - va * va
                          + ((b - b.mean()) ** 4).mean().item() - vb * vb)
                         / n)
        assert dm < 4 * se_m, f"B1 Philox class {cls}: mean {dm} > 4 SE"
        assert abs(va - vb) < 4 * se_v, f"B1 Philox class {cls}: variance"
        print(f"B1 check: in-kernel Philox, Y={int(cls)}: |mean diff| "
              f"{dm:.3g} (4 SE {4 * se_m:.3g}), |var diff| "
              f"{abs(va - vb):.3g} (4 SE {4 * se_v:.3g})")

    def kern():
        trand.truncated_normal_onesided(E, std, Y, rng)

    def plain():
        trand._truncated_normal_onesided_plain(E, std, Y,
                                               rng.uniform(E.shape))

    ms = device_ms(torch, kern, "probit_z_kernel")
    plain_ms = device_ms(torch, plain, calls=10)
    ev, plain_ev = event_ms(torch, kern), event_ms(torch, plain, batch=5)
    cells = C * ny * ns
    # bytes: E and Z per cell, Y per site x species, std per chain x species;
    # operations: ~120 per cell (a quarter Philox call, the uniform, the
    # standardisation, normcdff, normcdfinvf, log1pf, clamps and selects)
    b, by = bound_ms(4.0 * (2 * cells + ny * ns + C * ns), 120.0 * cells)
    print(f"B1 probit_z device time: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
          f"bound {b:.4f} ms by {by}; with enqueue {ev:.4f} ms, plain "
          f"{plain_ev:.4f} ms) at E {C}x{ny}x{ns} [{card}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, event_ms=ev,
                plain_event_ms=plain_ev)


def check_b2(torch, tlinalg, dev, card):
    C, ns, nf = HEADLINE["n_chains"], HEADLINE["ns"], HEADLINE["nf"]
    g = torch.Generator(device=dev).manual_seed(1)
    res = {}
    for P in (nf, 2 + nf):                       # Eta and BetaLambda systems
        B = C * ns
        M = torch.randn((B, P, P), generator=g, device=dev)
        prec = M @ M.transpose(1, 2) / P + torch.eye(P, device=dev)
        bad = torch.tensor([3, B // 2 + 1, B - 1], device=dev)
        prec[bad] -= 10.0 * torch.eye(P, device=dev)   # indefinite systems
        rhs = torch.randn((B, P), generator=g, device=dev)
        eps = torch.randn((B, P), generator=g, device=dev)
        xk = tlinalg.sample_mvn_prec_batched(prec, rhs, eps)
        xp = tlinalg._sample_mvn_prec_small_plain(prec, rhs, eps)
        nan_k = torch.isnan(xk).all(1)
        nan_p = torch.isnan(xp).all(1)
        assert torch.equal(nan_k, nan_p), "B2: NaN rows differ"
        assert torch.equal(torch.nonzero(nan_k)[:, 0], bad), "B2: NaN rows"
        ok = ~nan_k
        assert torch.isfinite(xk[ok]).all(), "B2: non-finite draws"
        abs_err = (xk[ok] - xp[ok]).abs().max().item()
        rel = abs_err / xp[ok].abs().max().item()
        assert rel <= 1e-4, f"B2 P={P}: max rel diff {rel} > 1e-4"

        def kern():
            tlinalg.sample_mvn_prec_batched(prec, rhs, eps)

        def plain():
            tlinalg._sample_mvn_prec_small_plain(prec, rhs, eps)

        ms = device_ms(torch, kern, "mvn_prec_small_kernel")
        plain_ms = device_ms(torch, plain, calls=10)
        ev, plain_ev = event_ms(torch, kern), event_ms(torch, plain, batch=5)
        # bytes: prec, rhs, eps in and the draw out; operations: P^3/3
        # (factor) + 2 P^2 (two solves) + 2 P (sqrt, reciprocal) per system
        b, by = bound_ms(4.0 * B * (P * P + 3 * P),
                         B * (P ** 3 / 3 + 2 * P * P + 2 * P))
        print(f"B2 check: P={P}, {B} systems, shared eps: max |diff| "
              f"{abs_err:.3g}, max rel diff {rel:.3g} (tolerance 1e-4); "
              f"planted indefinite rows NaN on both sides")
        print(f"B2 mvn_prec_small device time P={P}: {ms:.5f} ms (plain "
              f"{plain_ms:.4f} ms, bound {b:.5f} ms by {by}; with enqueue "
              f"{ev:.4f} ms, plain {plain_ev:.4f} ms) at {B} systems "
              f"[{card}]")
        res[P] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                      bound_ms=b, bound_by=by, library_ms=None, event_ms=ev,
                      plain_event_ms=plain_ev)
    # the line reports the BetaLambda shape, the larger of the two per sweep
    return res[2 + nf]


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
    # bytes: shape in, draw out; operations: ~180 per element for the one
    # Marsaglia-Tsang round a shape of 2 needs in ~98% of draws (a Philox
    # call, Box-Muller, the cube and two logs)
    b, by = bound_ms(8.0 * m, 180.0 * m)
    print(f"B3 standard_gamma device time: {ms:.5f} ms (plain "
          f"{plain_ms:.4f} ms, torch._standard_gamma {lib_ms:.5f} ms, bound "
          f"{b:.5f} ms by {by}; with enqueue {ev:.4f} ms, plain "
          f"{plain_ev:.4f} ms) at {m} shapes [{card}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms, event_ms=ev,
                plain_event_ms=plain_ev)


def expected_launches(spec, transient, samples, thin, adapt_nf):
    """Kernel launches the sweep schedule implies for a probit model with
    fixed sigma: Z once at start and once a sweep (B1); BetaLambda and Eta
    systems (B2) each sweep; psi, nf_max deltas and the Wishart diagonal
    each sweep, plus the Nf move's psi and delta draws while it <=
    adapt_nf (B3)."""
    sweeps = transient + samples * thin
    nf_sweeps = sum(min(a, sweeps) for a in adapt_nf)
    per_sweep_gamma = 1 + sum(1 + ls.nf_max for ls in spec.levels)
    return {"probit_z": 1 + sweeps,
            "mvn_prec_small": sweeps * (1 + spec.nr),
            "standard_gamma": sweeps * per_sweep_gamma + 2 * nf_sweeps}


def profile_sweeps(torch, ht, hM, card, sweeps=10):
    """Where a headline sweep's time goes: device time by kernel name over a
    short profiled run (torch.profiler), against the run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    h = HEADLINE
    kw = dict(samples=sweeps, transient=0, n_chains=h["n_chains"], seed=2,
              nf_cap=h["nf"], align_post=False)
    ht.sample_mcmc(hM, **kw)                      # warm the same shapes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        post = ht.sample_mcmc(hM, **kw)
    wall_ms = post.timing["run_s"] * 1e3          # profiler overhead included
    rows = [(us / 1e3, e.count, e.key) for e, us in _device_rows(torch, prof)]
    busy_ms = sum(r[0] for r in rows)
    print(f"profile: {sweeps} headline sweeps + record: run {wall_ms:.1f} ms"
          f", device kernel time {busy_ms:.1f} ms (busy share "
          f"{busy_ms / wall_ms:.3f}), {sum(r[1] for r in rows)} kernel "
          f"launches [{card}]")
    for ms, n, key in sorted(rows, reverse=True)[:12]:
        print(f"profile:   {ms:9.3f} ms  {n:6d} x  {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import hmsc_tpu_torch as ht
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.mcmc.structs import build_spec
    from hmsc_tpu_torch.ops import linalg as tlinalg
    from hmsc_tpu_torch.ops import rand as trand

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    K.library()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(K.KERNELS)} kernels (nvcc, sm_90a)")

    results = {"probit_z": check_b1(torch, trand, dev, card),
               "mvn_prec_small": check_b2(torch, tlinalg, dev, card),
               "standard_gamma": check_b3(torch, trand, dev, card)}

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

    # headline: the main path through the user's entry point
    h = HEADLINE
    X, Y, _ = simulate_probit(h["ny"], h["ns"], seed=66)
    hM = probit_model(ht, X, Y, nf=h["nf"])
    torch.cuda.synchronize()
    K.reset_launches()
    post = ht.sample_mcmc(hM, samples=h["samples"], transient=h["transient"],
                          n_chains=h["n_chains"], seed=1, nf_cap=h["nf"])
    torch.cuda.synchronize()
    launches = dict(K.launches)
    spec = build_spec(hM, h["nf"])
    want = expected_launches(spec, h["transient"], h["samples"], 1,
                             (h["transient"],) * spec.nr)
    beta = post["Beta"]
    assert beta.shape == (h["n_chains"], h["samples"], 2, h["ns"])
    assert np.isfinite(beta).all(), "headline: non-finite Beta"
    assert post.chain_health["good_chains"].all(), "headline: divergence"
    for name in K.KERNELS:
        assert launches[name] > 0, f"headline: {name} never launched"
        assert launches[name] == want[name], (
            f"headline: {name} launched {launches[name]} times, the "
            f"schedule implies {want[name]}")
    run_s = post.timing["run_s"]
    sweeps = h["transient"] + h["samples"]
    print(f"headline: {h['ny']} x {h['ns']} probit, nf_max {h['nf']}, "
          f"{h['n_chains']} chains, transient {h['transient']}, samples "
          f"{h['samples']}: run {run_s:.3f} s (setup "
          f"{post.timing['setup_s']:.3f} s), "
          f"{h['n_chains'] * h['samples'] / run_s:.2f} samples/s, "
          f"{h['n_chains'] * sweeps / run_s:.2f} chain-sweeps/s; "
          f"launches {launches} [{card}]")

    profile_sweeps(torch, ht, hM, card)

    meta = {
        "probit_z": ("B1 probit_z", "hmsc_tpu_torch/csrc/probit_z.cu",
                     "hmsc_tpu/ops/rand.py:84"),
        "mvn_prec_small": ("B2 mvn_prec_small",
                           "hmsc_tpu_torch/csrc/mvn_prec_small.cu",
                           "hmsc_tpu/ops/linalg.py:63"),
        "standard_gamma": ("B3 standard_gamma",
                           "hmsc_tpu_torch/csrc/standard_gamma.cu",
                           "hmsc_tpu/ops/rand.py:124"),
    }
    kernels = []
    for name, (label, src, replaces) in meta.items():
        r = results[name]
        kernels.append({"name": label, "ok": True, "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "event_ms": r["event_ms"],
                        "plain_event_ms": r["plain_event_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
