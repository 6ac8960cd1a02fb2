"""The port's kernels' plain PyTorch versions held against the JAX ops they
replace (B1 truncated_normal_onesided, B2 sample_mvn_prec_batched, B3
standard_gamma) and the Wishart draw on B3.  The CUDA kernels themselves
run only on the card; ``chip_smoke.py`` holds each against these plain
versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from hmsc_tpu.ops import linalg as jlinalg
from hmsc_tpu.ops import rand as jrand

from hmsc_tpu_torch.ops import linalg as tlinalg
from hmsc_tpu_torch.ops import rand as trand

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


def _probit_inputs(seed=0, C=2, ny=40, ns=30):
    """Linear predictors spanning both far tails (|t| > 9 sigma), plus
    uniforms that include values within one ulp of 1."""
    rng = np.random.default_rng(seed)
    E = rng.normal(0.0, 4.0, (C, ny, ns)).astype(np.float32)
    E[:, 0, :10] = np.linspace(-40, 40, 10)
    std = rng.uniform(0.5, 2.0, (C, ns)).astype(np.float32)
    Y = (rng.uniform(size=(ny, ns)) < 0.5).astype(np.float32)
    u = rng.uniform(1e-38, 1.0, (C, ny, ns)).astype(np.float32)
    u[:, 1, :] = np.nextafter(np.float32(1.0), np.float32(0.0))
    u[:, 2, :5] = np.float32(1e-38)
    return E, std, Y, u


def test_b1_plain_matches_jax_with_injected_uniforms():
    E, std, Y, u = _probit_inputs()
    jz = np.asarray(jrand.truncated_normal_onesided(
        jax.random.key(0), 0.0, jnp.asarray(Y > 0.5), jnp.asarray(E),
        jnp.asarray(std[:, None, :]), _u=jnp.asarray(u)))
    tz = trand.truncated_normal_onesided(
        torch.from_numpy(E), torch.from_numpy(std), torch.from_numpy(Y),
        u=torch.from_numpy(u)).numpy()
    assert np.isfinite(tz).all()
    # f32 ndtr/ndtri differ between the two libraries by a few ulps
    np.testing.assert_allclose(tz, jz, rtol=1e-5, atol=1e-5)
    # the truncation holds in every cell, far tails included, up to the
    # rounding of E + std * x at the clipped edge x = -E / std
    assert (np.where(Y > 0.5, tz, -tz) >= -1e-6 * (1 + np.abs(E))).all()


def test_b1_plain_draws_its_own_uniforms():
    E, std, Y, _ = _probit_inputs(seed=1)
    z = trand.truncated_normal_onesided(
        torch.from_numpy(E), torch.from_numpy(std), torch.from_numpy(Y),
        trand.Rng(3, "cpu")).numpy()
    assert np.isfinite(z).all()
    assert (np.where(Y > 0.5, z, -z) >= -1e-6 * (1 + np.abs(E))).all()


def _spd_batch(P, B=64, seed=0, n_bad=3):
    rng = np.random.default_rng(seed + P)
    M = rng.standard_normal((B, P, P))
    prec = M @ M.transpose(0, 2, 1) / P + np.eye(P)
    bad = rng.choice(B, n_bad, replace=False)
    prec[bad] = prec[bad] - 10.0 * np.eye(P)        # indefinite systems
    rhs = rng.standard_normal((B, P))
    eps = rng.standard_normal((B, P))
    return [a.astype(np.float32) for a in (prec, rhs, eps)], bad


@pytest.mark.parametrize("P", [1, 3, 8, 10, 16, 18])
def test_b2_plain_matches_jax_with_shared_eps(P):
    (prec, rhs, eps), bad = _spd_batch(P)
    jx = np.asarray(jlinalg.sample_mvn_prec_batched(
        jnp.asarray(prec), jnp.asarray(rhs), jnp.asarray(eps)))
    tx = tlinalg.sample_mvn_prec_batched(
        torch.from_numpy(prec), torch.from_numpy(rhs),
        torch.from_numpy(eps)).numpy()
    good = np.setdiff1d(np.arange(len(prec)), bad)
    # identical op order for P <= 16; LAPACK-style factorisations above
    np.testing.assert_allclose(tx[good], jx[good], rtol=1e-5, atol=1e-6)
    # indefinite input gives NaN rows on both sides, never an exception
    assert np.isnan(jx[bad]).all() and np.isnan(tx[bad]).all()
    assert np.isfinite(tx[good]).all()


@pytest.mark.parametrize("P", [3, 18])
def test_b2_draw_is_mvn_of_the_precision(P):
    (prec, rhs, _), _ = _spd_batch(P, B=1, n_bad=0)
    n = 20000
    g = torch.Generator().manual_seed(P)
    eps = torch.randn((n, P), generator=g)
    x = tlinalg.sample_mvn_prec_batched(
        torch.from_numpy(prec).expand(n, P, P),
        torch.from_numpy(rhs).expand(n, P), eps).double().numpy()
    cov = np.linalg.inv(prec[0].astype(float))
    mean = cov @ rhs[0]
    se = np.sqrt(np.diag(cov) / n)
    assert (np.abs(x.mean(0) - mean) < 4 * se).all()
    np.testing.assert_allclose(np.cov(x.T), cov, atol=0.05 * cov.max())


@pytest.mark.parametrize("a", [0.3, 1.0, 4.5, 1500.0])
def test_b3_plain_matches_jax_in_distribution(a):
    n = 20000
    jg = np.asarray(jrand.standard_gamma(
        jax.random.key(int(a * 10)), jnp.full((n,), a, jnp.float32)),
        dtype=float)
    tg = trand.standard_gamma(torch.full((n,), a),
                              trand.Rng(int(a * 10), "cpu")).double().numpy()
    assert np.isfinite(tg).all() and (tg > 0).all()
    assert stats.ks_2samp(jg, tg).pvalue > 1e-3
    # moments within 4 standard errors of each other (Gamma(a): mean a,
    # variance a, Var(s^2) ~ (2a^2 + 6a)/n)
    assert abs(jg.mean() - tg.mean()) < 4 * np.sqrt(2 * a / n)
    assert abs(jg.var() - tg.var()) < 4 * np.sqrt(2 * (2 * a * a + 6 * a) / n)


def test_b3_plain_keeps_nan_shape_nan():
    g = trand.standard_gamma(torch.tensor([float("nan"), 2.0]),
                             trand.Rng(0, "cpu"))
    assert torch.isnan(g[0]) and torch.isfinite(g[1])


def test_wishart_mean():
    n, p, df = 20000, 3, 7.0
    rng = np.random.default_rng(5)
    M = rng.standard_normal((p, p))
    S = M @ M.T + np.eye(p)
    T = torch.from_numpy(np.linalg.cholesky(S).astype(np.float32))
    W = trand.wishart(df, T.expand(n, p, p), trand.Rng(1, "cpu"))
    W = W.double().numpy()
    se = W.std(0) / np.sqrt(n)
    assert (np.abs(W.mean(0) - df * S) < 4 * se + 1e-6).all()
    np.testing.assert_allclose(W, W.transpose(0, 2, 1), rtol=1e-5, atol=1e-4)


def test_wishart_injected_noise_matches_jax():
    p, df = 2, 5.0
    key = jax.random.key(11)
    T = jnp.asarray(np.array([[1.0, 0.0], [0.3, 0.8]], np.float32))
    jw = np.asarray(jrand.wishart(key, df, T))
    kn, kc = jax.random.split(key)
    noise = {"normal": torch.tensor(np.asarray(
                 jax.random.normal(kn, (p, p)))[None]),
             "gamma": torch.tensor(np.asarray(jrand.standard_gamma(
                 kc, (df - jnp.arange(p, dtype=jnp.float32)) / 2.0))[None])}
    tw = trand.wishart(df, torch.tensor(np.asarray(T))[None],
                       noise=noise).numpy()[0]
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)
