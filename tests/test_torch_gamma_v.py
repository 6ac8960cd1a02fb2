"""Kernels B4 (the GammaV block in one launch, ``csrc/gamma_v.cu``) and B2
(a group of P lanes a system, with the BetaLambda and Eta precision
assembly in the kernel, ``csrc/mvn_prec_small.cu``), replayed in float32
numpy in the kernels' own order of arithmetic, against the JAX package on
the same inputs and draws.  A fused multiply-add is replayed as the
float64 product and sum rounded once to float32.  The kernels' own runs
on the card are ``chip_smoke.py``'s (``check_b4``, ``check_b2``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hmsc_tpu
import hmsc_tpu_torch
from hmsc_tpu.mcmc import updaters as JU
from hmsc_tpu.ops import linalg as jlinalg

from hmsc_tpu_torch.mcmc import updaters as TU
from hmsc_tpu_torch.mcmc.structs import build_spec
from hmsc_tpu_torch.ops import linalg as tlinalg
from hmsc_tpu_torch.ops import rand as trand

from test_torch_model import jax_triple, to_torch
from test_torch_updaters import (_compare, _setup, _stack,
                                 beta_lambda_noise, eta_noise, gamma_v_noise)

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

f32 = np.float32
LANE = np.arange(32)


def fma(a, b, c):
    """fmaf: the exact product and sum, rounded once to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def rsqrt_rn(p):
    """1 / sqrt(p) rounded once to float32 (``__frsqrt_rn``)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return (1.0 / np.sqrt(np.asarray(p, np.float64))).astype(f32)


def warp_sum(x, y):
    """B4's sum of x_j y_j over the species: lane l takes j = l (mod 32) in
    ascending order with fmaf, then the xor-shuffle tree."""
    acc = np.zeros(32, f32)
    for j in range(len(x)):
        acc[j % 32] = fma(x[j], y[j], acc[j % 32])
    for o in (16, 8, 4, 2, 1):
        acc = (acc + acc[LANE ^ o]).astype(f32)
    return acc[0]


def chol_rows(S):
    """B4's Cholesky a thread a row (``chol_rows``), in place on a float32
    copy: chol_spd's jitter, right-looking, each entry's updates in column
    order; NaN in full where not positive definite.  Returns (L with the
    last pivots on its diagonal, 1 / L_jj)."""
    S = S.astype(f32).copy()
    n = S.shape[0]
    tr = S[0, 0]
    for k in range(1, n):
        tr = f32(tr + S[k, k])
    bump = f32(f32(1e-6) * f32(tr / f32(n)))
    for i in range(n):
        S[i, i] = f32(S[i, i] + bump)
    inv = np.zeros(n, f32)
    bad = False
    for j in range(n):
        p = S[j, j]
        with np.errstate(invalid="ignore", divide="ignore"):
            r = f32(f32(1.0) / np.sqrt(p))
        bad = bad or not p > 0
        inv[j] = r
        S[j + 1:, j] = (S[j + 1:, j] * r).astype(f32)
        for i in range(j + 1, n):
            for k in range(j + 1, i + 1):
                S[i, k] = fma(-S[i, j], S[k, j], S[i, k])
    if bad:
        S[:], inv[:] = np.nan, np.nan
    return S, inv


def gamma_v_replay(Beta, Gamma, Tr, V0, TtT, iUG, iUGmG, df, normal, gamma,
                   eps):
    """One chain of B4 in the kernel's order: (iV, Gamma)."""
    nc, ns = Beta.shape
    nt = Tr.shape[1]
    n = nc * nt
    E = np.empty((nc, ns), f32)
    for r in range(nc):
        g = (Gamma[r, 0] * Tr[:, 0]).astype(f32)
        for u in range(1, nt):
            g = fma(Gamma[r, u], Tr[:, u], g)
        E[r] = (Beta[r] - g).astype(f32)
    A = np.empty((nc, nc), f32)
    for r in range(nc):
        for e in range(r + 1):
            A[r, e] = A[e, r] = warp_sum(E[r], E[e])
    BT = np.array([[warp_sum(Beta[r], Tr[:, u]) for u in range(nt)]
                   for r in range(nc)], f32)
    Lw, invw = chol_rows((A + V0).astype(f32))
    T = np.zeros((nc, nc), f32)
    for b in range(nc):
        T[b, b] = invw[b]
        for r in range(b + 1, nc):
            s = f32(0)
            for k in range(b, r):
                s = fma(-Lw[r, k], T[b, k], s)
            T[b, r] = f32(s * invw[r])
    Bb = np.tril(normal, -1).astype(f32)
    Bb[np.diag_indices(nc)] = np.sqrt((f32(2) * gamma).astype(f32))

    def dots(X, Y):                        # X[r] . Y[:, k], fmaf in order
        out = (X[:, :1] * Y[:1, :]).astype(f32)
        for m in range(1, X.shape[1]):
            out = fma(X[:, m:m + 1], Y[m:m + 1, :], out)
        return out

    TA = dots(T, Bb)
    iV = dots(TA, TA.T)
    P = np.empty((n, n), f32)
    for p in range(n):
        for q in range(n):
            P[p, q] = fma(TtT[p // nc, q // nc], iV[p % nc, q % nc],
                          iUG[p, q])
    rhs = np.array([iUGmG[p] + dots(iV[p % nc:p % nc + 1], BT)[0, p // nc]
                    for p in range(n)], f32)
    L, inv = chol_rows(P)
    y = rhs.copy()
    for k in range(n):
        y[k] = f32(y[k] * inv[k])
        y[k + 1:] = fma(-L[k + 1:, k], y[k], y[k + 1:])
    z = (y + eps).astype(f32)
    for k in range(n - 1, -1, -1):
        z[k] = f32(z[k] * inv[k])
        z[:k] = fma(-L[k, :k], z[k], z[:k])
    return iV, z.reshape(nt, nc).T


def _gamma_v_model(nc, nt, ns=30, ny=20, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(ny), rng.standard_normal((ny, nc - 1))])
    Tr = np.column_stack([np.ones(ns), rng.standard_normal((ns, nt - 1))])
    Y = (rng.standard_normal((ny, ns)) > 0).astype(float)
    m = hmsc_tpu.Hmsc(Y=Y, X=X, Tr=Tr, distr="probit")
    spec, data, states = jax_triple(m, seeds=(3, 4))
    states = [s.replace(
        Gamma=jnp.asarray(0.3 * rng.standard_normal((nc, nt)), jnp.float32),
        Beta=jnp.asarray(rng.standard_normal((nc, ns)), jnp.float32))
        for s in states]
    spec_t = build_spec(hmsc_tpu_torch.Hmsc(Y=Y, X=X, Tr=Tr, distr="probit"))
    return spec, data, states, spec_t


@pytest.mark.parametrize("nc,nt", [(2, 1), (4, 3), (16, 4)])
def test_gamma_v_replay_matches_jax(nc, nt):
    """B4 replayed (species sums a lane a residue class then the xor tree,
    the jittered factorisations a thread a row, T a lane a column, the
    Bartlett product, the precision and both solves a column at a time)
    with the JAX draws injected, against JAX ``update_gamma_v``; and the
    port's update (on the CPU the plain block, with the model data's
    Tr'Tr and iUGamma mGamma) against JAX too.  rtol 1e-4."""
    spec, data, states, spec_t = _gamma_v_model(nc, nt)
    keys = [jax.random.key(40 + c) for c in range(len(states))]
    ref = [JU.update_gamma_v(spec, data, s, k) for s, k in zip(states, keys)]
    noise = [gamma_v_noise(spec, k) for k in keys]
    data_t, state_t = to_torch(spec, data, states)
    c32 = lambda t: t.numpy().astype(f32)
    for c, (s, nz, r) in enumerate(zip(states, noise, ref)):
        iV, G = gamma_v_replay(
            np.asarray(s.Beta), np.asarray(s.Gamma), c32(data_t.Tr),
            c32(data_t.V0), c32(data_t.TtT), c32(data_t.iUGamma),
            c32(data_t.iUGmG), f32(spec.f0 + spec.ns),
            np.asarray(nz["wishart"]["normal"]),
            np.asarray(nz["wishart"]["gamma"], f32),
            np.asarray(nz["gamma"]["eps"]))
        np.testing.assert_allclose(iV, np.asarray(r.iV), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(G, np.asarray(r.Gamma), rtol=1e-4,
                                   atol=1e-5)
    out = TU.update_gamma_v(spec_t, data_t, state_t, noise=_stack(noise))
    _compare(out, ref, fields={"iV", "Gamma"})


def test_gamma_v_size_route():
    """Kernel B4 takes nc <= 16 and nc nt <= 64; a larger model's block is
    the plain one on the card too (a route by size, not a fallback), and
    on the CPU it matches JAX ``update_gamma_v``."""
    route = trand.gamma_v_route
    assert route(2, 1) and route(16, 4) and route(1, 64) and route(8, 8)
    assert not route(17, 1) and not route(9, 8) and not route(2, 33)
    spec, data, states, spec_t = _gamma_v_model(9, 8, ns=12)
    assert not route(spec.nc, spec.nt)
    keys = [jax.random.key(60 + c) for c in range(len(states))]
    ref = [JU.update_gamma_v(spec, data, s, k) for s, k in zip(states, keys)]
    data_t, state_t = to_torch(spec, data, states)
    out = TU.update_gamma_v(spec_t, data_t, state_t,
                            noise=_stack([gamma_v_noise(spec, k)
                                          for k in keys]))
    _compare(out, ref, fields={"iV", "Gamma"})


# --- B2 -------------------------------------------------------------------

def b2_replay(prec, rhs, eps):
    """B2 replayed for a batch (B, P): lane i a row; the jitter (1e-6 / P)
    x the trace summed in index order, added first; a right-looking
    Cholesky with the reciprocal of each pivot one correctly rounded
    rsqrt, each entry's updates in k order; the forward solve folded into
    the columns; the back solve x_m = (y_m + eps_m - sum_{k>m} L_km x_k)
    / L_mm, k ascending."""
    B, P = rhs.shape
    A = prec.astype(f32).copy()
    tr = A[:, 0, 0].copy()
    for k in range(1, P):
        tr = (tr + A[:, k, k]).astype(f32)
    bump = (f32(1e-6 / P) * tr).astype(f32)
    for k in range(P):
        A[:, k, k] = (A[:, k, k] + bump).astype(f32)
    inv = np.zeros((B, P), f32)
    y = np.zeros((B, P), f32)
    r = rhs.astype(f32).copy()
    piv = A[:, 0, 0].copy()
    for j in range(P):
        inv[:, j] = rsqrt_rn(piv)
        A[:, j:, j] = (A[:, j:, j] * inv[:, j:j + 1]).astype(f32)
        if j + 1 < P:
            piv = fma(-A[:, j + 1, j], A[:, j + 1, j], A[:, j + 1, j + 1])
            A[:, j + 1, j + 1] = piv
        y[:, j] = (r[:, j] * inv[:, j]).astype(f32)
        r[:, j + 1:] = fma(-A[:, j + 1:, j], y[:, j:j + 1], r[:, j + 1:])
        for k in range(j + 1, P):
            rows = np.arange(k + (k == j + 1), P)
            A[:, rows, k] = fma(-A[:, rows, j], A[:, k:k + 1, j],
                                A[:, rows, k])
    z = (y + eps).astype(f32)
    x = np.zeros((B, P), f32)
    for m in range(P - 1, -1, -1):
        t = z[:, m].copy()
        for k in range(m + 1, P):
            t = fma(-A[:, k, m], x[:, k], t)
        x[:, m] = (t * inv[:, m]).astype(f32)
    return x


@pytest.mark.parametrize("P", [1, 3, 8, 10, 16])
def test_b2_replay_matches_jax(P):
    """B2's lane-per-row factorisation and solves, replayed, against JAX
    ``sample_mvn_prec_batched`` on the same eps (rtol 1e-5); planted
    indefinite systems give NaN rows on both sides."""
    rng = np.random.default_rng(P)
    B = 48
    M = rng.standard_normal((B, P, P))
    prec = M @ M.transpose(0, 2, 1) / P + np.eye(P)
    bad = np.array([2, 17, B - 1])
    prec[bad] -= 10.0 * np.eye(P)
    prec, rhs, eps = (a.astype(f32) for a in (
        prec, rng.standard_normal((B, P)), rng.standard_normal((B, P))))
    jx = np.asarray(jlinalg.sample_mvn_prec_batched(
        jnp.asarray(prec), jnp.asarray(rhs), jnp.asarray(eps)))
    with np.errstate(invalid="ignore"):
        x = b2_replay(prec, rhs, eps)
    good = np.setdiff1d(np.arange(B), bad)
    np.testing.assert_allclose(x[good], jx[good], rtol=1e-5, atol=1e-6)
    assert np.isnan(x[bad]).all() and np.isnan(jx[bad]).all()
    assert np.isfinite(x[good]).all()


def beta_lambda_replay(G, rhs_lik, iSigma, iV, prior, Gamma, Tr, eps):
    """B2's BetaLambda form for one chain: each species' precision
    ``fmaf(iSigma_j, G, D)`` and right-hand side ``fmaf(iSigma_j,
    rhs_lik, (iV Gamma Tr'_j)_i)`` in registers, then the draw."""
    ns, P = rhs_lik.shape
    nc = iV.shape[0]
    Gs = np.broadcast_to(G, (ns, P, P))
    D = np.zeros((ns, P, P), f32)
    D[:, :nc, :nc] = iV
    D[:, np.arange(nc, P), np.arange(nc, P)] = prior.T
    prec = fma(iSigma[:, None, None], Gs, D)
    mu = (Gamma[:, :1] * Tr[:, :1].T).astype(f32)       # (nc, ns)
    for t in range(1, Tr.shape[1]):
        mu = fma(Gamma[:, t:t + 1], Tr[:, t:t + 1].T, mu)
    dot = np.zeros((ns, P), f32)
    for q in range(nc):
        dot[:, :nc] = fma(iV[None, :, q], mu[q][:, None], dot[:, :nc])
    rhs = fma(iSigma[:, None], rhs_lik, dot)
    return b2_replay(prec, rhs, eps)


@pytest.mark.parametrize("kind", ["probit", "na"])
def test_beta_lambda_form_matches_jax(kind):
    """B2's BetaLambda form (the chains' shared gram, or a masked gram a
    species with missing values), replayed from the sampler's own inputs
    (``updaters.beta_lambda_inputs``), and its plain version through
    ``sample_beta_lambda`` on the CPU, against JAX ``update_beta_lambda``
    with the same eps: Beta and Lambda to rtol 1e-4."""
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup(kind)
    ref = [JU.update_beta_lambda(spec_j, data_j, s, k)
           for s, k in zip(states_j, keys)]
    eps = _stack([beta_lambda_noise(spec_j, k) for k in keys])["eps"]
    G, rhs_lik, prior = TU.beta_lambda_inputs(spec_t, data_t, state_t)
    assert G.shape[1] == (spec_t.ns if kind == "na" else 1)
    with np.errstate(invalid="ignore"):
        BL = np.stack([beta_lambda_replay(
            G[c].numpy(), rhs_lik[c].numpy(), state_t.iSigma[c].numpy(),
            state_t.iV[c].numpy(), prior[c].numpy(),
            state_t.Gamma[c].numpy(), data_t.Tr.numpy(), eps[c].numpy())
            for c in range(state_t.n_chains)])
    plain = tlinalg.sample_beta_lambda(G, rhs_lik, state_t.iSigma,
                                       state_t.iV, prior, state_t.Gamma,
                                       data_t.Tr, eps)
    for got in (torch.from_numpy(BL), plain):
        Beta, levels = TU._unstack_lambda(spec_t, got.transpose(1, 2),
                                          state_t)
        _compare(state_t.replace(Beta=Beta, levels=levels), ref,
                 fields={"Beta", "Lambda"})


@pytest.mark.parametrize("kind", ["probit", "na"])
def test_eta_form_matches_jax(kind):
    """B2's identity form for the unstructured Eta draw (the shared gram
    scaled by each unit's row count in the kernel, or a gram a unit with
    missing values), replayed and through ``sample_mvn_prec_shifted``'s
    plain version on the CPU, against JAX ``update_eta_nonspatial`` with
    the same eps: rtol 1e-4."""
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup(
        kind, n_units=10)
    ref = []
    for s, k in zip(states_j, keys):
        S = s.Z - JU.linear_fixed(spec_j, data_j, s.Beta)
        ref.append(s.replace(levels=(JU.update_eta_nonspatial(
            spec_j, data_j, s, 0, k, S),)))
    eps = _stack([eta_noise(spec_j, k, 0) for k in keys])["eps"]
    S = state_t.Z - TU.linear_fixed(spec_t, data_t, state_t.Beta)
    G, scale, F = TU._level_gram_parts(
        spec_t, data_t, data_t.levels[0], spec_t.levels[0],
        state_t.levels[0], state_t.iSigma, S)
    assert (scale is None) == (kind == "na")
    nf = F.shape[-1]
    eye = np.eye(nf, dtype=f32)
    out = []
    for c in range(state_t.n_chains):
        s_ = np.ones(F.shape[1], f32) if scale is None else scale.numpy()
        prec = fma(s_[:, None, None], np.broadcast_to(
            G[c].numpy(), (F.shape[1], nf, nf)), eye)
        out.append(b2_replay(prec, F[c].numpy(), eps[c].numpy()))
    plain = tlinalg.sample_mvn_prec_shifted(G, F, scale, eps)
    lv = state_t.levels[0]
    for got in (torch.from_numpy(np.stack(out)), plain):
        _compare(state_t.replace(levels=(lv.replace(Eta=got),)), ref,
                 fields={"Eta"})
