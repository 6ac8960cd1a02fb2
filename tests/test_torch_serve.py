"""The port's serving layer against the JAX package's on the CPU: the plain
versions of the serving kernels B9a (fused predict), B9b (conditional
refinement) and B9c (draw quantiles) against ``hmsc_tpu.serve.kernels`` on
the same numpy inputs (B9b with the JAX draws rebuilt from the request key
and injected), the serving artifact in both directions, and the engine's
behaviours (buckets, coalescing, the launch-plan cache, flips, HTTP)."""

import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from scipy import stats

import hmsc_tpu
from hmsc_tpu.mcmc import structs as jstructs
from hmsc_tpu.serve import (ServingEngine as JaxEngine,
                            compact_posterior as jax_compact,
                            load_artifact as jax_load_artifact)
from hmsc_tpu.serve.kernels import (make_conditional_kernel as
                                    jax_conditional_kernel,
                                    make_predict_kernel as jax_predict_kernel)

import hmsc_tpu_torch as ht
from hmsc_tpu_torch.ops import serve as tserve
from hmsc_tpu_torch.post import posterior_from_numpy
from hmsc_tpu_torch.serve import ServingEngine, make_server

from test_torch_model import make_models

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

_TINY = 1e-38
F32 = np.float32


# ---------------------------------------------------------------------------
# inputs: one synthetic posterior and query block, made with numpy
# ---------------------------------------------------------------------------

def serve_inputs(seed, nfs=(2,), units=(5,), n=12, nc=2, ns=6, B=5,
                 fam=(1, 2, 3, 2, 1, 3)):
    """(Beta, sigma, lams, etas, fam, ym, ys, X, uidx) as numpy; each Eta
    ends with the mean-field zero row, uidx reaches it."""
    rng = np.random.default_rng(seed)
    Beta = (0.7 * rng.standard_normal((n, nc, ns))).astype(F32)
    sigma = rng.uniform(0.3, 1.2, (n, ns)).astype(F32)
    lams = [(0.5 * rng.standard_normal((n, nf, ns))).astype(F32)
            for nf in nfs]
    etas = [np.concatenate([rng.standard_normal((n, u, nf)),
                            np.zeros((n, 1, nf))], axis=1).astype(F32)
            for nf, u in zip(nfs, units)]
    X = np.column_stack([np.ones(B), rng.standard_normal((B, nc - 1))]
                        ).astype(F32)
    uidx = np.stack([rng.integers(0, u + 1, B) for u in units]
                    ).astype(np.int32)
    uidx[:, 0] = units                       # the mean-field row
    ym = (0.2 * rng.standard_normal(ns)).astype(F32)
    ys = rng.uniform(0.5, 2.0, ns).astype(F32)
    return (Beta, sigma, lams, etas, np.asarray(fam, np.int32), ym, ys, X,
            uidx)


def to_jax(args, dtype=jnp.float32):
    Beta, sigma, lams, etas, fam, ym, ys, X, uidx = args
    d = lambda a: jnp.asarray(a, dtype)     # noqa: E731
    return (d(Beta), d(sigma), tuple(d(l) for l in lams),
            tuple(d(e) for e in etas), jnp.asarray(fam), jnp.asarray(ym),
            jnp.asarray(ys), jnp.asarray(X), jnp.asarray(uidx))


def to_torch(args, dtype=torch.float32):
    Beta, sigma, lams, etas, fam, ym, ys, X, uidx = args
    d = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa
    return (d(Beta), d(sigma), [d(l) for l in lams], [d(e) for e in etas],
            torch.from_numpy(fam), torch.from_numpy(ym),
            torch.from_numpy(ys), torch.from_numpy(X),
            torch.from_numpy(uidx))


def close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# B9a, B9c
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nr", [1, 2])
@pytest.mark.parametrize("quantiles", [(), (0.1, 0.5, 0.9)],
                         ids=["moments", "quantiles"])
@pytest.mark.parametrize("staged", ["float32", "bfloat16"])
def test_b9a_plain_matches_jax_predict_kernel(nr, quantiles, staged):
    """Expected predictions on a normal / probit / Poisson mix: mean, sd
    and the quantiles over B9a's draws (B9c) against the JAX kernel."""
    args = serve_inputs(3 + nr, nfs=(2, 3)[:nr], units=(5, 4)[:nr])
    jdt, tdt = ((jnp.float32, torch.float32) if staged == "float32" else
                (jnp.bfloat16, torch.bfloat16))
    fn = jax.jit(jax_predict_kernel(nr=nr, expected=True, any_probit=True,
                                    any_poisson=True, quantiles=quantiles))
    want = fn(*to_jax(args, jdt), jax.random.key(0))
    Beta, sigma, lams, etas, fam, ym, ys, X, uidx = to_torch(args, tdt)
    kern = ht.serve.make_predict_kernel(nr=nr, expected=True,
                                        quantiles=quantiles)
    got = kern(Beta, sigma, lams, etas, fam, ym, ys, X, uidx, 0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g.numpy(), w, rtol=1e-5, atol=1e-6)


def test_b9a_draws_and_linear_predictor_match_jax():
    """B9a's draws mode is the JAX kernel's per-draw block before the
    reduction, and the port's linear_predictor the JAX one."""
    from hmsc_tpu.serve.kernels import linear_predictor as jax_linpred

    args = serve_inputs(11, nfs=(2, 3), units=(5, 4))
    Beta, sigma, lams, etas, fam, ym, ys, X, uidx = args
    L = np.asarray(jax_linpred(jnp.asarray(X), False, jnp.asarray(Beta),
                               etas=[jnp.asarray(e) for e in etas],
                               pis=[jnp.asarray(u) for u in uidx],
                               xrows=[None, None],
                               lams=[jnp.asarray(l) for l in lams]))
    t = to_torch(args)
    got = ht.serve.linear_predictor(t[7], False, t[0], etas=t[3],
                                    pis=list(t[8]), lams=t[2])
    close(got.numpy(), L, rtol=1e-5, atol=1e-6)
    _, _, y = tserve.serve_predict(t[7], t[8], t[0], t[1], t[2], t[3], t[4],
                                   t[5], t[6], expected=True, moments=False,
                                   draws=True)
    pro = fam == 2
    close(y.numpy()[..., pro],
          (jax.scipy.special.ndtr(L) * ys + ym)[..., pro], 1e-5, 1e-6)
    with pytest.raises(NotImplementedError, match="A5"):
        ht.serve.linear_predictor(t[7], True, t[0])
    with pytest.raises(NotImplementedError, match="A7"):
        ht.serve.linear_predictor(t[7], False, t[0], XRRR=t[7])


# the headline's serving shapes (chip_smoke.py · SERVE), small ones, a
# ragged species tile, the covariate / factor limits, bfloat16 draws
GEOMETRY_SHAPES = [
    (800, 1, 1000, 2, 8, False), (800, 64, 1000, 2, 8, False),
    (800, 64, 1000, 2, 8, True), (800, 200, 1000, 2, 8, False),
    (800, 16, 1000, 2, 8, False), (12, 5, 6, 2, 2, False),
    (37, 3, 130, 3, 5, True), (5, 1, 1, 1, 1, False),
    (800, 64, 1000, 64, 64, False), (800, 1, 1000, 64, 64, True)]


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_b9a_geometry_covers_every_cell_once(shape):
    """csrc/serve_predict.cu's launch, from predict_geometry: every query
    row, species and draw falls in exactly one (block, warp, lane, stage)
    place, each chunk non-empty; the result depends on the shape alone;
    the block fits 256 threads and the shared memory of an H100 SM; at the
    headline's B 1 and B 64 the grid fills the 132 SMs, within two blocks
    an SM."""
    n, B, ns, nc, nft, bf16 = shape
    g = tserve.predict_geometry(n, B, ns, nc, nft, bf16)
    assert g == tserve.predict_geometry(n, B, ns, nc, nft, bf16)
    assert g.rb in (1, 2, 4, 8) and g.rt <= 64 and 32 * g.wr * g.wd <= 256
    assert g.smem == tserve._predict_smem(nc, nft, g.rt, g.wd, bf16)
    assert g.smem <= tserve._PREDICT_SMEM_MAX
    rows = [y * g.rt + w * g.rb + t for y in range(-(-B // g.rt))
            for w in range(g.wr) for t in range(g.rb)]
    assert sorted(r for r in rows if r < B) == list(range(B))
    tiles = -(-ns // tserve._PREDICT_TJ)
    species = [x * 64 + lane + 32 * h for x in range(tiles)
               for lane in range(32) for h in range(2)]
    assert sorted(j for j in species if j < ns) == list(range(ns))
    draws = []
    for z in range(g.S):
        d0, d1 = z * g.D, min(n, (z + 1) * g.D)
        assert d1 > d0
        for st in range(-(-(d1 - d0) // g.wd)):
            draws += [d for d in range(d0 + st * g.wd, d0 + (st + 1) * g.wd)
                      if d < d1]
    assert sorted(draws) == list(range(n))
    blocks = tiles * -(-B // g.rt) * g.S
    if (n, ns, nc, nft) == (800, 1000, 2, 8) and B in (1, 64):
        assert 132 <= blocks <= 2 * 132
        assert g.smem <= tserve._PREDICT_SMEM_BUDGET


@pytest.mark.parametrize("nfs", [(3,), (2, 4), (1, 5, 2)])
def test_b9a_factor_map_matches_level_args(nfs):
    """B9a's flat factor map gives factor f of a query row's concatenated
    factors the level and column that _level_args' offsets place it at."""
    lams = [torch.zeros((2, nf, 3)) for nf in nfs]
    etas = [torch.zeros((2, 4, nf)) for nf in nfs]
    (_, _, nf_c, _), nr = tserve._level_args(lams, etas)
    fl, fc = tserve._factor_map(lams)
    offs = np.cumsum([0] + list(nf_c[:nr]))
    assert len(fl) == offs[-1] == sum(nfs)
    for f in range(int(offs[-1])):
        r = int(np.searchsorted(offs, f, side="right")) - 1
        assert (fl[f], fc[f]) == (r, f - offs[r])


def _welford_as_kernel(y, geo):
    """csrc/serve_predict.cu's moments in float32 from the per-draw
    responses y (n, B, ns): in each chunk of D draws each draw slot's
    Welford steps over its draws (d0 + slot, d0 + slot + wd, ...), the
    slots combined by a fixed tree (slot s takes slot s + step, step 1, 2,
    4, ...; one reciprocal a step), then the chunks in chunk order
    (serve_common.cuh), both by Chan et al.'s formula."""
    n = y.shape[0]
    one = np.float32(1.0)
    parts = []
    for z in range(geo.S):
        d0, d1 = z * geo.D, min(n, (z + 1) * geo.D)
        slots = []
        for w in range(geo.wd):
            mean = torch.zeros(y.shape[1:])
            m2 = torch.zeros(y.shape[1:])
            ds = list(range(d0 + w, d1, geo.wd))
            for k, d in enumerate(ds):
                inv = torch.tensor(one / np.float32(k + 1))
                delta = y[d] - mean
                mean = mean + delta * inv
                m2 = m2 + delta * (y[d] - mean)
            slots.append([mean, m2, np.float32(len(ds))])
        counts = [c for _, _, c in slots]
        step = 1
        while step < geo.wd:
            for w in range(0, geo.wd, 2 * step):
                mean, m2, cnt = slots[w]
                nb = np.float32(sum(counts[w + step:w + 2 * step]))
                if nb > 0:
                    mb, qb = slots[w + step][:2]
                    tot = cnt + nb
                    r = one / tot
                    delta = mb - mean
                    slots[w] = [mean + delta * (nb * r),
                                m2 + (qb + delta * delta * (cnt * nb * r)),
                                tot]
            step *= 2
        parts.append(slots[0])
    mean, m2, cnt = parts[0]
    for mb, qb, nb in parts[1:]:
        tot = cnt + nb
        delta = mb - mean
        mean = mean + delta * (nb / tot)
        m2 = m2 + (qb + delta * delta * (cnt * nb / tot))
        cnt = tot
    return mean, torch.sqrt(torch.clamp(m2, min=0.0) / np.float32(n))


def test_b9a_kernel_summation_order_matches_plain():
    """The kernel's order of the moments (Welford per draw slot, slots by a
    fixed tree, chunks in order) gives the plain version's mean and population
    sd to 1e-6, at a shape of 12 chunks of 17 draws with 8 draw slots a
    block, the last chunk and some slots short."""
    n, B = 200, 3
    args = serve_inputs(17, n=n, B=B)
    Beta, sigma, lams, etas, fam, ym, ys, X, uidx = to_torch(args)
    geo = tserve.predict_geometry(n, B, Beta.shape[2], Beta.shape[1],
                                  sum(l.shape[1] for l in lams))
    assert geo.S == 12 and geo.D == 17 and geo.wd == 8 and n % geo.D
    mean, sd, y = tserve.serve_predict(X, uidx, Beta, sigma, lams, etas,
                                       fam, ym, ys, expected=True,
                                       draws=True)
    km, ks = _welford_as_kernel(y, geo)
    assert (km - mean).abs().max() <= 1e-6
    assert (ks - sd).abs().max() <= 1e-6


@pytest.mark.parametrize("rate", [0.5, 5.0, 50.0])
def test_poisson_plain_sampler_ks_against_scipy(rate):
    gen = torch.Generator().manual_seed(int(rate * 10))
    d = tserve.poisson_plain(torch.full((20000,), rate), gen).numpy()
    assert np.all(d == np.round(d)) and d.min() >= 0
    # the KS distance of the empirical to scipy's cdf over the support
    # (scipy's kstest assumes a continuous law), below its 1% critical
    # value 1.63 / sqrt(n), conservative for a discrete law
    k = np.arange(int(d.max()) + 1)
    ks = np.abs((d[:, None] <= k).mean(axis=0)
                - stats.poisson(rate).cdf(k)).max()
    assert ks < 1.63 / np.sqrt(d.size)
    se = np.sqrt(rate / d.size)
    assert abs(d.mean() - rate) < 5 * se
    assert abs(d.var() / rate - 1.0) < 0.05
    nan0 = tserve.poisson_plain(torch.tensor([float("nan"), 0.0]), gen)
    assert torch.isnan(nan0[0]) and nan0[1] == 0


def test_b9a_sampled_plain_matches_its_law():
    """Sampled mode: probit draws are 0 / 1 at the expected rate, Poisson
    means at exp(L + sigma / 2) (lognormal-Poisson), normal columns
    N(L, sigma), all within 6 standard errors over 4000 draws."""
    args = serve_inputs(21, n=4000, B=2, ns=3, fam=(1, 2, 3))
    Beta, sigma, lams, etas, fam, ym, ys, X, uidx = args
    Beta[:] = Beta[:1]
    sigma[:] = np.array([0.5, 1.0, 0.04], F32)
    lams[0][:] = 0.0
    ym[:], ys[:] = 0.0, 1.0
    t = to_torch(args)
    em, _, _ = tserve.serve_predict(t[7], t[8], *t[:7], expected=True)
    sm, ssd, y = tserve.serve_predict(t[7], t[8], *t[:7], expected=False,
                                      draws=True, seed=5)
    y, em = y.numpy(), em.numpy()
    assert set(np.unique(y[..., 1])) <= {0.0, 1.0}
    assert np.all(y[..., 2] == np.round(y[..., 2]))
    # every cell's draws are iid (Beta equal over draws, Lambda 0)
    var = np.stack([np.full(em.shape[0], sigma[0, 0]),
                    em[:, 1] * (1 - em[:, 1]),
                    em[:, 2] + em[:, 2] ** 2 * (np.exp(sigma[0, 2]) - 1)],
                   axis=-1)
    se = np.sqrt(var / y.shape[0])
    assert np.all(np.abs(sm.numpy() - em) < 6 * se)


def test_b9c_plain_matches_jnp_quantile():
    rng = np.random.default_rng(8)
    y = rng.standard_normal((37, 3, 4)).astype(F32) * 5
    y[:, 0, 0] = 1.0                          # ties
    y[3, 2, 1] = np.nan
    q = (0.0, 0.05, 0.5, 0.95, 1.0)
    want = np.asarray(jnp.quantile(jnp.asarray(y), jnp.asarray(q, F32),
                                   axis=0))
    got = tserve.draw_quantiles(torch.from_numpy(y), q).numpy()
    assert np.isnan(got[:, 2, 1]).all() and np.isnan(want[:, 2, 1]).all()
    close(np.nan_to_num(got), np.nan_to_num(want), rtol=1e-6, atol=1e-6)
    # B9c stages 800 draws (8 columns of [draw][9] words beside the warps'
    # 840 words each) and reads 40000 from global memory: no draw limit
    assert tserve.quantile_layout(800) == (True, 4 * (8 * 840 + 800 * 9))
    assert tserve.quantile_layout(40000) == (False, 4 * 8 * 840)
    with pytest.raises(ValueError, match="draws"):
        tserve.quantile_layout(0)


# ---------------------------------------------------------------------------
# B9b
# ---------------------------------------------------------------------------

def jax_conditional_draws(key, n, steps, B, ns, nfs, sampled):
    """The draws ``make_conditional_kernel`` makes from ``key``, in B9b's
    noise layout: eps_z / u_z (n, steps + 1, B, ns), eps_rows (n, steps,
    B, sum nf), eps_out (n, B, ns)."""
    def one(k):
        k0, k_scan, k_out = jax.random.split(k, 3)

        def z(kz):
            return (jax.random.normal(kz, (B, ns), jnp.float32),
                    jax.random.uniform(jax.random.fold_in(kz, 1), (B, ns),
                                       jnp.float32, minval=_TINY,
                                       maxval=1.0))
        eps, u = [z(k0)[0]], [z(k0)[1]]
        rows = []
        for kk in jax.random.split(k_scan, steps):
            rows.append(jnp.concatenate(
                [jax.random.normal(jax.random.fold_in(kk, 1 + r), (B, nf),
                                   jnp.float32)
                 for r, nf in enumerate(nfs)], axis=-1))
            e, v = z(jax.random.fold_in(kk, 0))
            eps.append(e)
            u.append(v)
        out = jax.random.normal(jax.random.split(k_out)[0], (1, B, ns),
                                jnp.float32)[0]
        return (jnp.stack(eps), jnp.stack(u),
                jnp.stack(rows) if rows else jnp.zeros((0, B, sum(nfs))),
                out)
    ez, uz, er, eo = jax.vmap(one)(jax.random.split(key, n))
    noise = {"eps_z": ez, "u_z": uz, "eps_rows": er}
    if sampled:
        noise["eps_out"] = eo
    return {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}


@pytest.mark.parametrize("nr,steps,expected", [
    (1, 1, True), (1, 3, True), (2, 1, True), (2, 3, True), (1, 2, False)])
def test_b9b_plain_matches_jax_conditional_kernel(nr, steps, expected):
    """Normal and probit columns, each query row with observed and
    unobserved cells, one row all unobserved: the plain version with the
    JAX draws injected against the JAX kernel."""
    nfs = (2, 3)[:nr]
    args = serve_inputs(30 + nr + steps, nfs=nfs, units=(5, 4)[:nr],
                        fam=(1, 2, 2, 1, 2, 2))
    Beta, sigma, lams, etas, fam, ym, ys, X, uidx = args
    B, ns = X.shape[0], Beta.shape[2]
    rng = np.random.default_rng(9)
    Yc = np.where(fam == 2, rng.uniform(size=(B, ns)) < 0.5,
                  rng.standard_normal((B, ns))).astype(F32)
    mask = (rng.uniform(size=(B, ns)) < 0.6).astype(F32)
    mask[1] = 0.0                              # an all-NaN Yc row
    Yc = Yc * mask
    key = jax.random.key(7)
    fn = jax.jit(jax_conditional_kernel(nr=nr, mcmc_step=steps,
                                        expected=expected, any_probit=True,
                                        any_normal=True))
    want = fn(*to_jax(args), jnp.asarray(Yc), jnp.asarray(mask), key)
    noise = jax_conditional_draws(key, Beta.shape[0], steps, B, ns, nfs,
                                  not expected)
    t = to_torch(args)
    got = tserve.serve_conditional(
        t[7], t[8], torch.from_numpy(Yc), torch.from_numpy(mask), *t[:7],
        mcmc_step=steps, expected=expected, noise=noise)
    for g, w in zip(got, want):
        close(g.numpy(), w, rtol=1e-4, atol=1e-5)


def _b9b_noise(seed, n, steps, B, ns, nft, sampled):
    rng = np.random.default_rng(seed)
    noise = {"eps_z": rng.standard_normal((n, steps + 1, B, ns)),
             "u_z": rng.uniform(_TINY, 1.0, (n, steps + 1, B, ns)),
             "eps_rows": rng.standard_normal((n, steps, B, nft))}
    if sampled:
        noise["eps_out"] = rng.standard_normal((n, B, ns))
    return {k: torch.from_numpy(v.astype(F32)) for k, v in noise.items()}


def _cached_e_predictor(X, uidx, Yc, mask, Beta, sigma, lams, etas, fam,
                        steps, noise):
    """E after the refinement in csrc/serve_conditional.cu's order: E formed
    once a draw; an observed species' E takes each level's change at the
    next pass over the observed species, an unobserved one each level's
    whole change at the end; S = z - (E - rows_r . Lambda_r); no refresh
    after the last step; std = 1 / sqrt(1 / sigma)."""
    LFix = torch.einsum("yc,ncj->nyj", X, Beta)
    isig = 1.0 / sigma
    std = 1.0 / torch.sqrt(isig)
    rows = [eta[:, uidx[r].long(), :] for r, eta in enumerate(etas)]
    rows0 = [r.clone() for r in rows]
    offs = np.cumsum([0] + [lam.shape[1] for lam in lams])
    E = LFix + sum(torch.einsum("nyf,nfj->nyj", r, lam)
                   for r, lam in zip(rows, lams))
    chol = []
    for lam in lams:
        U = torch.einsum("nfj,ngj,nj,yj->nyfg", lam, lam, isig, mask)
        chol.append(torch.linalg.cholesky(
            U + torch.eye(lam.shape[1], dtype=U.dtype)))
    obs = mask > 0
    pend = None
    for s in range(steps):
        for r, lam in enumerate(lams):
            if pend is not None:
                q, dq = pend
                E = torch.where(obs, E + torch.einsum("nyf,nfj->nyj", dq,
                                                      lams[q]), E)
            if r == 0:
                eps, u = noise["eps_z"][:, s], noise["u_z"][:, s]
                z = E + std[:, None, :] * eps
                z = torch.where((fam == tserve.FAM_NORMAL) & obs, Yc, z)
                ztn = tserve._truncated_normal_onesided_plain(E, std, Yc, u)
                z = torch.where((fam == tserve.FAM_PROBIT) & obs, ztn, z)
            own = torch.einsum("nyf,nfj->nyj", rows[r], lam)
            S = z - (E - own)
            F = torch.einsum("nyj,nfj->nyf", S * isig[:, None, :] * mask,
                             lam)
            mean = torch.cholesky_solve(F[..., None], chol[r])[..., 0]
            e = noise["eps_rows"][:, s, :, offs[r]:offs[r + 1]]
            nz = torch.linalg.solve_triangular(chol[r].mT, e[..., None],
                                               upper=True)[..., 0]
            new = mean + nz
            pend = (r, new - rows[r])
            rows[r] = new
    owed = sum(torch.einsum("nyf,nfj->nyj", r1 - r0, lam)
               for r1, r0, lam in zip(rows, rows0, lams))
    last = (torch.einsum("nyf,nfj->nyj", pend[1], lams[pend[0]])
            if pend is not None else 0.0)
    return torch.where(obs, E + last, E + owed)


@pytest.mark.parametrize("nr,steps", [(1, 0), (1, 3), (2, 2)])
def test_b9b_kernel_order_matches_plain(nr, steps):
    """The kernel's restructured refinement (a running E per row, changes
    applied a pass late or at the end, no refresh after the last step)
    gives the plain version's expected moments to 1e-5 with the same
    injected draws, normal and probit columns, a row all unobserved."""
    nfs = (2, 3)[:nr]
    args = serve_inputs(50 + nr + steps, nfs=nfs, units=(5, 4)[:nr], n=40,
                        fam=(1, 2, 2, 1, 2, 2))
    Beta, sigma, lams, etas, fam, ym, ys, X, uidx = to_torch(args)
    n, B, ns = Beta.shape[0], X.shape[0], Beta.shape[2]
    rng = np.random.default_rng(3)
    mask = torch.from_numpy((rng.uniform(size=(B, ns)) < 0.6).astype(F32))
    mask[1] = 0.0
    Yc = torch.from_numpy(np.where(fam.numpy() == 2,
                                   rng.uniform(size=(B, ns)) < 0.5,
                                   rng.standard_normal((B, ns))).astype(F32))
    Yc = Yc * mask
    noise = _b9b_noise(5, n, steps, B, ns, sum(nfs), False)
    mp, sp = tserve.serve_conditional(X, uidx, Yc, mask, Beta, sigma, lams,
                                      etas, fam, ym, ys, mcmc_step=steps,
                                      expected=True, noise=noise)
    E = _cached_e_predictor(X, uidx, Yc, mask, Beta, sigma, lams, etas, fam,
                            steps, noise)
    y = torch.where(fam == tserve.FAM_PROBIT, tserve._ndtr(E), E) * ys + ym
    assert (y.mean(dim=0) - mp).abs().max() <= 1e-5
    assert (y.std(dim=0, correction=0) - sp).abs().max() <= 1e-5


def test_b9b_last_refresh_is_never_read():
    """The Z drawn after the last step reaches no output: the kernel skips
    that refresh, and changing its injected draws changes nothing here."""
    args = to_torch(serve_inputs(44, fam=(1, 2, 2, 1, 2, 2)))
    X, uidx = args[7], args[8]
    B, ns, n = X.shape[0], args[0].shape[2], args[0].shape[0]
    Yc = torch.zeros(B, ns)
    mask = torch.ones(B, ns)
    for expected in (True, False):
        noise = _b9b_noise(6, n, 2, B, ns, 2, not expected)
        a = tserve.serve_conditional(X, uidx, Yc, mask, *args[:7],
                                     mcmc_step=2, expected=expected,
                                     noise=noise)
        noise["eps_z"][:, 2] = 7.0
        noise["u_z"][:, 2] = 0.5
        b = tserve.serve_conditional(X, uidx, Yc, mask, *args[:7],
                                     mcmc_step=2, expected=expected,
                                     noise=noise)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("nf", [4, 8, 16])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("ns", [1, 37, 1000, 4000, 10240])
def test_b9b_geometry_covers_every_cell_once(nf, bf16, ns):
    """csrc/serve_conditional.cu's launch, from conditional_geometry, for
    every B in 1..100 and several draw counts: every (query row, draw)
    falls to exactly one warp (block x, slot and row warp, its chunk's
    draw); at most 16 warps a block (8 at nf 16); no staging with one row
    a block; the
    chunks' last one non-empty; the block's shared memory (the kernel's
    make_layout) within the 227 KB an H100 block may use."""
    for n in (800, 13, 1):
        for B in range(1, 101):
            g = tserve.conditional_geometry(n, B, ns, 2, [nf], bf16)
            assert g == tserve.conditional_geometry(n, B, ns, 2, [nf], bf16)
            assert 1 <= g.warps <= (16 if nf < 16 else 8)
            assert g.stages in (0, 1, 2)
            assert g.rows == 1 or g.rows >= min(B, g.warps)
            assert not (g.rows == 1 and g.stages)
            assert g.smem == tserve._conditional_smem(
                ns, 2, [nf], nf, bf16, g.warps, g.slots, g.stages)
            assert g.smem <= 227 * 1024
            assert (g.S - 1) * g.D < n <= g.S * g.D
            gx, gy = -(-B // g.rows), -(-g.S // g.slots)
            x, y, w = np.meshgrid(np.arange(gx), np.arange(gy),
                                  np.arange(g.warps), indexing="ij")
            b = (x * g.rows + w % g.rows).ravel()
            d0 = ((y * g.slots + w // g.rows) * g.D).ravel()
            keep = (b < B) & (d0 < n)
            b, d0 = b[keep], d0[keep]
            d = d0[:, None] + np.arange(g.D)[None, :]
            bb = np.broadcast_to(b[:, None], d.shape)
            inside = d < n
            count = np.zeros((B, n), np.int64)
            np.add.at(count, (bb[inside], d[inside]), 1)
            assert (count == 1).all(), (n, B, g)


def test_b9b_checks_its_noise_and_runs_without_it():
    args = to_torch(serve_inputs(40, fam=(1, 2, 2, 1, 2, 2)))
    B, ns = args[7].shape[0], args[0].shape[2]
    Yc, mask = torch.zeros(B, ns), torch.ones(B, ns)
    with pytest.raises(ValueError, match="eps_rows"):
        tserve.serve_conditional(args[7], args[8], Yc, mask, *args[:7],
                                 mcmc_step=2, expected=True,
                                 noise={"eps_z": torch.zeros(12, 3, B, ns),
                                        "u_z": torch.zeros(12, 3, B, ns)})
    m1, s1 = tserve.serve_conditional(args[7], args[8], Yc, mask, *args[:7],
                                      mcmc_step=2, expected=True, seed=4)
    m2, _ = tserve.serve_conditional(args[7], args[8], Yc, mask, *args[:7],
                                     mcmc_step=2, expected=True, seed=4)
    assert torch.equal(m1, m2) and torch.isfinite(s1).all()


# ---------------------------------------------------------------------------
# a fitted posterior shared by both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fitted():
    """A small probit model fitted by the port on the CPU, its draws
    carried into a JAX ``Posterior`` and back through
    ``posterior_from_numpy``: (jax model, jax posterior, port posterior)."""
    mj, mt = make_models("probit", ny=30, ns=4, nf=2, n_units=6, seed=3)
    fit = ht.sample_mcmc(mt, samples=8, transient=4, n_chains=2, seed=1,
                         nf_cap=2, align_post=False, device="cpu")
    pj = hmsc_tpu.post.Posterior(mj, jstructs.build_spec(mj, 2), fit.arrays,
                                 samples=8, transient=4, thin=1)
    pt = posterior_from_numpy(mt, pj.arrays, samples=8, transient=4, thin=1)
    return mj, pj, pt


@pytest.fixture(scope="module")
def engine(fitted):
    with ServingEngine(fitted[2], coalesce_ms=1.0, device="cpu") as eng:
        yield eng


def _query(q=5):
    return np.column_stack([np.ones(q), np.linspace(-1.0, 1.0, q)]
                           ).astype(F32)


def _jax_engine(source):
    return JaxEngine(source, coalesce_ms=1.0, buckets=(8,))


def test_posterior_from_numpy_keeps_the_draws(fitted):
    _, pj, pt = fitted
    for k in ("Beta", "Eta_0", "Lambda_0", "sigma"):
        np.testing.assert_array_equal(pt.pooled(k), pj.pooled(k))
    assert pt.spec.levels[0].nf_max == 2 and pt.n_chains == 2


def test_engine_matches_jax_engine(fitted, engine):
    _, pj, _ = fitted
    X = _query(5)
    units = {"unit": ["u000", "nope", "u003", "u005", "u001"]}
    with _jax_engine(pj) as je:
        for kw in ({}, {"units": units},
                   {"units": units, "quantiles": [0.1, 0.5, 0.9]}):
            want, got = je.predict(X, **kw), engine.predict(X, **kw)
            for k in ("mean", "sd") + (("quantiles",) if kw.get(
                    "quantiles") else ()):
                close(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_jax_f32_artifact_served_by_port(fitted, engine, tmp_path):
    _, pj, _ = fitted
    man = jax_compact(pj, os.fspath(tmp_path))
    assert man["dtype"] == "float32"
    art = ht.load_artifact(os.fspath(tmp_path))
    X = _query(6)
    with ServingEngine(art, coalesce_ms=1.0, device="cpu") as e2, \
            _jax_engine(pj) as je:
        assert e2.n_draws == je.n_draws == 16
        got, want = e2.predict(X), je.predict(X)
        np.testing.assert_array_equal(got["mean"], engine.predict(X)["mean"])
    close(got["mean"], want["mean"], rtol=1e-5, atol=1e-5)
    close(got["sd"], want["sd"], rtol=1e-5, atol=1e-5)


def test_bf16_artifact_within_recorded_cast_tolerance(fitted, engine,
                                                      tmp_path):
    _, pj, pt = fitted
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    man = jax_compact(pj, os.fspath(jdir), dtype="bfloat16")
    mant = ht.compact_posterior(pt, os.fspath(tdir), dtype="bfloat16")
    tols = {k: e["cast"]["max_abs_err"] for k, e in man["params"].items()}
    for k, e in man["params"].items():
        # round-to-nearest-even in both packages: the same bits
        np.testing.assert_array_equal(np.load(jdir / e["file"]),
                                      np.load(tdir / e["file"]))
        assert mant["params"][k]["cast"] == e["cast"]
    art = ht.load_artifact(os.fspath(jdir))
    for k, t in tols.items():
        assert np.abs(art.pooled(k) - pt.pooled(k)).max() <= t + 1e-12
        assert art.stored(k).dtype == torch.bfloat16
    X = _query(5)
    with ServingEngine(art, coalesce_ms=1.0, device="cpu") as e2:
        assert e2._staged.Beta.dtype == torch.bfloat16
        assert all(e.dtype == torch.bfloat16 for e in e2._staged.etas)
        a, b = engine.predict(X), e2.predict(X)
    assert np.abs(a["mean"] - b["mean"]).max() <= 10 * max(tols.values()) \
        + 1e-6


def test_port_artifact_read_by_jax(fitted, engine, tmp_path):
    _, pj, pt = fitted
    man = ht.compact_posterior(pt, os.fspath(tmp_path), thin=2)
    art = jax_load_artifact(os.fspath(tmp_path))
    assert art.n_draws == man["n_draws"] == 8
    full = pt["Beta"]
    np.testing.assert_array_equal(
        art.pooled("Beta"), full[:, ::2].reshape((-1,) + full.shape[2:]))
    X = _query(4)
    with _jax_engine(art) as je, \
            ServingEngine(os.fspath(tmp_path), coalesce_ms=1.0,
                          device="cpu") as e2:
        close(e2.predict(X)["mean"], je.predict(X)["mean"], 1e-5, 1e-5)
    assert isinstance(art.stored("Beta"), np.ndarray)
    assert np.dtype(ml_dtypes.bfloat16).itemsize == 2


def test_artifact_corruption_and_run_directories(fitted, tmp_path):
    from hmsc_tpu_torch.utils.checkpoint import CheckpointCorruptError

    _, _, pt = fitted
    man = ht.compact_posterior(pt, os.fspath(tmp_path))
    path = tmp_path / man["params"]["Beta"]["file"]
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    for mmap in (True, False):
        with pytest.raises(CheckpointCorruptError, match="checksum"):
            ht.load_artifact(os.fspath(tmp_path), mmap=mmap).pooled("Beta")
    with pytest.raises(NotImplementedError, match="A9"):
        ServingEngine(os.fspath(tmp_path / "no-such-run"), device="cpu")


# ---------------------------------------------------------------------------
# engine behaviours (tests/test_serve.py's, on the port)
# ---------------------------------------------------------------------------

def test_unknown_units_serve_mean_field(engine):
    X = _query(3)
    base = engine.predict(X)
    nofx = engine.predict(X, units={"unit": ["nope1", "nope2", "nope3"]})
    known = engine.predict(X, units={"unit": ["u000", "u001", "u002"]})
    np.testing.assert_array_equal(base["mean"], nofx["mean"])
    assert np.abs(known["mean"] - base["mean"]).max() > 0


def test_conditional_and_sampled_queries(engine):
    X = _query(4)
    marg = engine.predict(X)
    Yc = np.full((4, engine.ns), np.nan, dtype=F32)
    Yc[:, 0] = 1.0
    cond = engine.predict(X, Yc=Yc, mcmc_step=2)
    assert np.isfinite(cond["mean"]).all() and np.isfinite(cond["sd"]).all()
    assert np.abs(cond["mean"] - marg["mean"]).max() > 0
    assert (cond["mean"] >= 0).all() and (cond["mean"] <= 1).all()
    out = engine.predict(_query(3), expected=False)
    assert (out["mean"] >= 0).all() and (out["mean"] <= 1).all()


def test_micro_batching_coalesces(fitted):
    with ServingEngine(fitted[2], coalesce_ms=50.0, device="cpu") as eng:
        eng.warmup()
        X = _query(1)
        serial = eng.predict(X)
        base = eng.stats()
        futs = [eng.submit(X) for _ in range(64)]
        outs = [f.result(timeout=60) for f in futs]
        stats_ = eng.stats()
    for o in outs:
        np.testing.assert_allclose(o["mean"], serial["mean"], atol=1e-6)
    assert stats_["batches"] - base["batches"] < 64
    assert stats_["device_calls"] - base["device_calls"] < 64
    assert stats_["rows_served"] - base["rows_served"] == 64


def test_zero_plan_builds_after_warmup_and_flip(fitted):
    rng = np.random.default_rng(0)
    with ServingEngine(fitted[2], coalesce_ms=0.5, buckets=(1, 2, 4, 8),
                       device="cpu") as eng:
        assert eng.warmup() == 4
        base = eng.stats()["cache"]
        for q in rng.integers(1, 20, size=25):
            eng.predict(_query(int(q)))
        flip = eng.reload()
        eng.predict(_query(3))
        cache = eng.stats()["cache"]
        assert eng.generation == 1 and not flip["shapes_changed"]
    assert cache["misses"] == base["misses"]
    assert cache["hits"] >= base["hits"] + 25


def test_flip_to_a_new_posterior(fitted):
    _, _, pt = fitted
    with ServingEngine(pt, coalesce_ms=0.5, device="cpu") as eng:
        before = eng.predict(_query(2))
        half = pt.subset(start=4)
        res = eng.reload(half)
        after = eng.predict(_query(2))
        assert res["shapes_changed"] and res["n_draws"] == 8
        assert eng.n_draws == 8 and after["generation"] == 1
    assert np.abs(after["mean"] - before["mean"]).max() > 0


def test_plan_cache_lru_bounded(fitted):
    with ServingEngine(fitted[2], coalesce_ms=0.5, buckets=(1, 2, 4),
                       cache_size=2, device="cpu") as eng:
        for q in (1, 2, 4, 1):
            eng.predict(_query(q))
        cache = eng.stats()["cache"]
    assert cache["size"] <= 2
    assert cache["misses"] == 4          # bucket 1 was evicted, rebuilt


def test_oversized_query_chunks(fitted):
    with ServingEngine(fitted[2], coalesce_ms=0.5, buckets=(1, 2, 4),
                       device="cpu") as eng:
        out = eng.predict(_query(11))
        stats_ = eng.stats()
    assert out["mean"].shape == (11, eng.ns)
    assert stats_["device_calls"] == 3    # 4 + 4 + 4 (padded)
    assert np.isfinite(out["mean"]).all()


def test_telemetry_spans_and_sink(fitted, tmp_path):
    tel = os.fspath(tmp_path / "tel")
    with ServingEngine(fitted[2], coalesce_ms=0.5, telemetry=tel,
                       device="cpu") as eng:
        eng.predict(_query(2))
        stats_ = eng.stats()
    for span in ("queue_wait", "pad", "dispatch", "fetch", "stage"):
        assert span in stats_["spans"], span
    events = [json.loads(ln) for ln in
              open(os.path.join(tel, "events-p0.jsonl"))]
    assert any(e["kind"] == "span" and e["name"] == "dispatch"
               for e in events)
    assert all("trace" in e for e in events)


def test_http_server_roundtrip(fitted):
    with ServingEngine(fitted[2], coalesce_ms=1.0, device="cpu") as eng:
        server = make_server(eng, "127.0.0.1", 0)
        host, port = server.server_address[:2]
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        base = f"http://{host}:{port}"
        try:
            with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
                health = json.loads(r.read())
            assert health["ok"] and health["n_draws"] == eng.n_draws
            X = _query(2)
            req = urllib.request.Request(
                f"{base}/predict", data=json.dumps({"X": X.tolist()}).encode(),
                headers={"Content-Type": "application/json",
                         "X-Hmsc-Trace": "ab" * 16 + ":" + "cd" * 8})
            with urllib.request.urlopen(req, timeout=30) as r:
                out = json.loads(r.read())
            np.testing.assert_allclose(np.asarray(out["mean"]),
                                       eng.predict(X)["mean"], atol=1e-6)
            assert out["trace"] == "ab" * 16
            req = urllib.request.Request(f"{base}/flip", data=b"{}")
            with urllib.request.urlopen(req, timeout=30) as r:
                assert json.loads(r.read())["generation"] == 1
            for path, body, code in (("/predict", b"{not json", 400),
                                     ("/metrics", None, 501),
                                     ("/nope", None, 404)):
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(urllib.request.Request(
                        base + path, data=body), timeout=10)
                assert e.value.code == code
            with urllib.request.urlopen(f"{base}/statz", timeout=10) as r:
                assert json.loads(r.read())["requests"] >= 2
        finally:
            server.shutdown()
            server.server_close()


def test_engine_rejects_unsupported_structures(fitted, tmp_path):
    _, _, pt = fitted
    with pytest.raises(NotImplementedError, match="A9"):
        ServingEngine(pt, draw_shards=2, device="cpu")
    with ServingEngine(pt, coalesce_ms=0.5, device="cpu") as eng:
        with pytest.raises(ValueError, match="columns"):
            eng.predict(np.ones((2, 5), dtype=F32))
        with pytest.raises(ValueError, match="labels"):
            eng.predict(_query(2), units={"unit": ["u000"]})
        with pytest.raises(ValueError, match="quantiles"):
            eng.predict(_query(2), quantiles=[1.5])
        with pytest.raises(ValueError, match="XData"):
            eng.gradient("x")           # a model built from a matrix X
        eng.close()
        with pytest.raises(RuntimeError):
            eng.predict(_query(1))
    from hmsc_tpu_torch.serve.http import serve_main
    with pytest.raises(NotImplementedError, match="A9"):
        serve_main([os.fspath(tmp_path), "--fleet", "f.json"])


# the worker re-raises its error after failing the futures: pytest sees it
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_failed_worker_fails_queued_futures(fitted, monkeypatch):
    def boom(self):
        raise RuntimeError("no card for the worker")

    monkeypatch.setattr(ServingEngine, "_serve", boom)
    eng = ServingEngine(fitted[2], coalesce_ms=0.5, device="cpu")
    fut = eng.submit(_query(1))
    with pytest.raises(RuntimeError, match="worker failed"):
        fut.result(timeout=30)
    eng.close()


def test_engine_without_a_device_raises_on_a_box_without_a_card(fitted,
                                                                 tmp_path):
    from hmsc_tpu_torch.mcmc.sampler import resolve_device
    from hmsc_tpu_torch.serve.http import serve_main

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(fitted[2])
    ht.compact_posterior(fitted[2], os.fspath(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main([os.fspath(tmp_path), "--port", "0"])
