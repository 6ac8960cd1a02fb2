"""Poisson responses and missing values in Y: the plain versions of kernels
B5 (``ops.rand.poisson_z``) and B6 (``ops.gram.masked_gram``) against the
JAX package's ops and einsums, and the port's ``sample_mcmc`` against the
JAX package's on a small mixed model with missing cells (z-scores of
posterior means).  The CUDA kernels themselves run only on the card;
``chip_smoke.py`` holds each against these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import hmsc_tpu
from hmsc_tpu.mcmc import updaters as JU
from hmsc_tpu.mcmc.updaters import _NB_R
from hmsc_tpu.ops import rand as jrand

import hmsc_tpu_torch
from hmsc_tpu_torch.mcmc import updaters as TU
from hmsc_tpu_torch.mcmc.structs import build_spec
from hmsc_tpu_torch.ops import gram as tgram
from hmsc_tpu_torch.ops import rand as trand

from test_torch_model import jax_triple, model_inputs, to_torch
from test_torch_sampler import _assert_parity, _z_scores
from test_torch_updaters import _compare, _stack, z_noise

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

# float32 transcendental and summation order differ between XLA and
# PyTorch on the CPU by a few ulps
RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- B5: the Polya-Gamma Poisson Z draw ------------------------------------

def _poisson_inputs(seed=0, C=2, ny=24, ns=7):
    """Counts from 0 to ~1e3 and previous Z that put |Z - log r| / 2 below
    1e-3 (the series branch), exactly at 0, just above 1e-3 and far out;
    one column is not Poisson."""
    rng = np.random.default_rng(seed)
    Y = rng.poisson(np.exp(rng.uniform(-2.0, 5.0, (ny, ns)))).astype(
        np.float32)
    Y[0] = 0.0
    Y[1] = 1000.0
    Y[2] = rng.integers(900, 1100, ns)
    logr = np.float32(np.log(np.float32(_NB_R)))
    Zprev = (np.log(Y + 0.5)[None] + rng.normal(0, 0.5, (C, ny, ns))).astype(
        np.float32)
    Zprev[:, 1] = logr                                  # z = 0
    Zprev[:, 3] = logr + rng.uniform(-1.9e-3, 1.9e-3, (C, ns))  # |z|/2 < 1e-3
    Zprev[:, 4] = logr + 2.5e-3                         # just past the series
    Zprev[:, 5] = logr - 30.0                           # far out
    E = (Zprev + rng.normal(0, 0.3, Zprev.shape)).astype(np.float32)
    iSigma = rng.uniform(0.5, 100.0, (C, ns)).astype(np.float32)
    fam = np.full(ns, 3, dtype=np.int32)
    fam[-1] = 2
    eps_pg, eps_z = rng.standard_normal((2, C, ny, ns)).astype(np.float32)
    return Y, Zprev, E, iSigma, fam, eps_pg, eps_z


def _jax_poisson_z(Y, Zprev, E, iSigma, fam, eps_pg, eps_z):
    """The JAX package's Poisson branch (``updaters.py:175-197``), chain by
    chain, with its normals injected."""
    logr = jnp.log(_NB_R)
    out = []
    for c in range(Zprev.shape[0]):
        zp, prec = jnp.asarray(Zprev[c]), jnp.asarray(iSigma[c])[None, :]
        w = jrand.polya_gamma(jax.random.key(0), jnp.asarray(Y) + _NB_R,
                              zp - logr, _eps=jnp.asarray(eps_pg[c]))
        s2 = 1.0 / (prec + w)
        mu = s2 * ((jnp.asarray(Y) - _NB_R) / 2.0
                   + prec * (jnp.asarray(E[c]) - logr)) + logr
        z = mu + jnp.sqrt(s2) * jnp.asarray(eps_z[c])
        z = jnp.where(jnp.isfinite(z), z, zp)
        out.append(np.asarray(jnp.where(jnp.asarray(fam)[None] == 3, z, zp)))
    return np.stack(out)


def _exact_poisson_z(Y, Zprev, E, iSigma, fam, eps_pg, eps_z):
    """The same formulas in float64 (numpy), for the band where the JAX
    op's float32 PG variance cancels."""
    Y, Zprev, E, iSigma, eps_pg, eps_z = (
        np.asarray(a, np.float64) for a in (Y, Zprev, E, iSigma, eps_pg,
                                            eps_z))
    logr = np.log(_NB_R)
    h, u = Y + _NB_R, 0.5 * np.abs(Zprev - logr)
    us = np.where(u < 1e-3, 1.0, u)
    t = np.tanh(us)
    mean = np.where(u < 1e-3, h / 4.0 * (1.0 - u * u / 3.0), h * t / (4 * us))
    var = np.where(u < 1e-3, h / 24.0,
                   h * (t - us * (1 - t * t)) / (16.0 * us ** 3))
    w = np.maximum(mean + np.sqrt(var) * eps_pg, 1e-38)
    prec = iSigma[:, None, :]
    s2 = 1.0 / (prec + w)
    z = s2 * ((Y - _NB_R) / 2.0 + prec * (E - logr)) + logr \
        + np.sqrt(s2) * eps_z
    return np.where(fam == 3, z, Zprev), u


def test_b5_plain_matches_jax_with_injected_normals():
    args = _poisson_inputs()
    got = trand.poisson_z(*map(_t, args[:5]), eps_pg=_t(args[5]),
                          eps_z=_t(args[6])).numpy()
    assert np.isfinite(got).all()
    # the non-Poisson column comes back untouched
    np.testing.assert_array_equal(got[..., -1], args[1][..., -1])
    # against the JAX op where its float32 variance holds 1e-5 relative
    # (ROADMAP Queue C: 1e-3 <= |z|/2 < 0.05 loses up to ~10%), and against
    # the same formulas in float64 everywhere
    exact, u = _exact_poisson_z(*args)
    ref = _jax_poisson_z(*args)
    sound = (u < 1e-3) | (u >= 0.05)
    assert sound.mean() > 0.5 and (~sound).any()
    np.testing.assert_allclose(got[sound], ref[sound], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, exact, rtol=RTOL, atol=ATOL)
    # the PG moments themselves, the series branches and z = 0 included
    h = _t(args[0][None] + _NB_R)
    z = _t(args[1]) - float(np.log(np.float32(_NB_R)))
    t_mean, t_var = trand._pg_moments(h, z)
    j_mean, j_var = jrand._pg_moments(jnp.asarray(h.numpy()),
                                      jnp.asarray(z.numpy()))
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(j_mean), rtol=RTOL)
    np.testing.assert_allclose(t_var.numpy()[sound], np.asarray(j_var)[sound],
                               rtol=RTOL)


def test_b5_keeps_previous_z_where_the_draw_is_not_finite():
    Y, Zprev, E, iSigma, fam, eps_pg, eps_z = _poisson_inputs(seed=1)
    E[0, 0, 0] = np.inf
    E[1, 2, 3] = np.nan
    got = trand.poisson_z(*map(_t, (Y, Zprev, E, iSigma, fam)),
                          eps_pg=_t(eps_pg), eps_z=_t(eps_z)).numpy()
    assert got[0, 0, 0] == Zprev[0, 0, 0] and got[1, 2, 3] == Zprev[1, 2, 3]
    assert np.isfinite(got).all()


def test_b5_plain_draws_its_own_normals():
    Y, Zprev, E, iSigma, fam, _, _ = _poisson_inputs(seed=2, C=3)
    z = trand.poisson_z(*map(_t, (Y, Zprev, E, iSigma, fam)),
                        trand.Rng(5, "cpu")).numpy()
    assert np.isfinite(z).all()
    np.testing.assert_array_equal(z[..., -1], Zprev[..., -1])


def _mixed_na_models(na_share=0.1, seed=5):
    """Both packages' model with normal, probit, lognormal-Poisson and
    Poisson columns (``test_torch_model.MIXED``), ``na_share`` of Y
    missing (at least one cell a column)."""
    Y, kw, units = model_inputs("mixed", seed=seed)
    rng = np.random.default_rng(seed)
    miss = rng.uniform(size=Y.shape) < na_share
    miss[rng.integers(Y.shape[0], size=Y.shape[1]), np.arange(Y.shape[1])] \
        = True
    Y = np.where(miss, np.nan, Y)
    out = []
    for pkg in (hmsc_tpu, hmsc_tpu_torch):
        rl = pkg.HmscRandomLevel(units=units[0])
        pkg.set_priors_random_level(rl, nf_max=3, nf_min=2)
        out.append(pkg.Hmsc(Y=Y, ran_levels={"unit": rl}, **kw))
    return tuple(out)


def test_b5_mixed_plain_matches_jax_update_z():
    """B5's mixed form, through its plain route (``ops.rand.z_mixed`` on
    the CPU), against the JAX package's ``update_z`` with its very draws
    (u, eps_pg, eps_z, eps_na) injected: normal, probit and
    (lognormal-)Poisson columns, 10% of Y missing, two chains."""
    mj, mt = _mixed_na_models()
    spec_j, data_j, states_j = jax_triple(mj, seeds=(3, 4))
    data_t, state_t = to_torch(spec_j, data_j, states_j)
    spec_t = build_spec(mt)
    assert TU.mixed_z(spec_t) and spec_t.has_na
    keys = [jax.random.key(200 + c) for c in range(2)]
    ref = [JU.update_z(spec_j, data_j, s, k) for s, k in zip(states_j, keys)]
    noise = _stack([z_noise(spec_j, k) for k in keys])
    assert set(noise) == {"u", "eps_pg", "eps_z", "eps_na"}
    E = TU.total_loading(spec_t, data_t, state_t)
    Z = trand.z_mixed(data_t.Y, state_t.Z, E, state_t.iSigma,
                      data_t.distr_family, data_t.Ymask, None, **noise)
    _compare(state_t.replace(Z=Z), ref, fields={"Z"})
    missing = (data_t.Ymask == 0).expand_as(Z)
    assert 0.05 < missing[0].float().mean() < 0.2
    # the updater routes to it and gives the same
    out = TU.update_z(spec_t, data_t, state_t, E=E, noise=noise)
    assert torch.equal(out.Z, Z)


@pytest.mark.parametrize("kind,na,mixed,fused", [
    ("mixed", False, True, False), ("mixed", True, True, False),
    ("probit", True, False, False), ("probit", False, False, True),
    ("normal", False, False, False)])
def test_mixed_z_route(kind, na, mixed, fused):
    """B5's mixed form is the Z update of every model with a Poisson
    column (config 5's families, with or without missing values); a
    probit-only model with missing values keeps B1's E-reading form, one
    without them B1's fused form; a normal model the torch ops."""
    if kind == "mixed" and na:
        _, mt = _mixed_na_models()
    else:
        Y, kw, units = model_inputs(kind, ns=6)
        if na:
            Y = Y.copy()
            Y[::7, ::2] = np.nan
        rls = {"unit": hmsc_tpu_torch.HmscRandomLevel(units=units[0])}
        hmsc_tpu_torch.set_priors_random_level(rls["unit"], nf_max=2,
                                               nf_min=2)
        mt = hmsc_tpu_torch.Hmsc(Y=Y, ran_levels=rls, **kw)
    spec = build_spec(mt)
    assert spec.has_na == na
    assert TU.mixed_z(spec) is mixed
    assert TU.fused_z(spec) is fused


# --- B6: masked grams ------------------------------------------------------

def _gram_inputs(P, seed=0, C=2, ny=33, ns=21):
    """A mask with an all-missing species (column 0) and an all-missing row
    (row 0)."""
    rng = np.random.default_rng(seed + P)
    XE = rng.standard_normal((C, ny, P)).astype(np.float32)
    mask = (rng.uniform(size=(ny, ns)) > 0.2).astype(np.float32)
    mask[:, 0] = 0.0
    mask[0, :] = 0.0
    Z = rng.standard_normal((C, ny, ns)).astype(np.float32)
    lam = rng.standard_normal((C, P, ns)).astype(np.float32)
    iSigma = rng.uniform(0.5, 2.0, (C, ns)).astype(np.float32)
    return XE, mask, Z, lam, iSigma


@pytest.mark.parametrize("P", [4, 10, 17])
def test_b6_plain_matches_jax_einsums(P):
    XE, mask, Z, lam, iSigma = _gram_inputs(P)
    # per species (updaters.py:246-250, 278-279)
    G, R = tgram.masked_gram(_t(XE), _t(mask).T, _t(Z).transpose(1, 2))
    jG = np.stack([np.asarray(jnp.einsum("ip,ij,iq->jpq", XE[c], mask,
                                         XE[c])) for c in range(len(XE))])
    jR = np.stack([np.asarray(jnp.einsum("ip,ij,ij->jp", XE[c], mask, Z[c]))
                   for c in range(len(XE))])
    np.testing.assert_allclose(G.numpy(), jG, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(R.numpy(), jR, rtol=RTOL, atol=ATOL)
    assert not G[:, 0].any() and not R[:, 0].any()      # all-missing species
    # per row of a level (updaters.py:618-623), S = Z
    G, R = tgram.masked_gram(_t(lam).transpose(1, 2), _t(mask), _t(Z),
                             _t(iSigma))
    jG = np.stack([np.asarray(jnp.einsum("fj,gj,j,ij->ifg", lam[c], lam[c],
                                         iSigma[c], mask))
                   for c in range(len(lam))])
    jR = np.stack([np.asarray(jnp.matmul(Z[c] * iSigma[c][None] * mask,
                                         lam[c].T)) for c in range(len(lam))])
    np.testing.assert_allclose(G.numpy(), jG, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(R.numpy(), jR, rtol=RTOL, atol=ATOL)
    assert not G[:, 0].any() and not R[:, 0].any()      # all-missing row


# --- B6's host-side layout: packed columns, column tiles, k splits ---------

@pytest.mark.parametrize("P", [1, 4, 8, 10, 16, 18, 50])
def test_b6_packed_columns_and_tiles(P):
    """The packed column map is G's upper-triangle pairs (p <= q) row by
    row, each once, then R's P entries as (p, -1); the column tiles carry
    at most 8 gram slots of 16 and together cover every gram and
    right-hand-side slot."""
    colp, colq = (t.numpy() for t in tgram.gram_columns(P))
    n_pair = P * (P + 1) // 2
    assert colp.dtype == colq.dtype == np.int32
    assert len(colp) == len(colq) == n_pair + P
    pairs = list(zip(colp[:n_pair].tolist(), colq[:n_pair].tolist()))
    assert pairs == [(p, q) for p in range(P) for q in range(p, P)]
    np.testing.assert_array_equal(colp[n_pair:], np.arange(P))
    assert (colq[n_pair:] == -1).all()
    NG, T = tgram.gram_tiles(P)
    assert 1 <= NG <= 8 and T >= 1
    assert T * NG * 16 >= n_pair and T * 16 >= P
    assert (T - 1) * NG * 16 < n_pair or (T - 1) * 16 < P   # no idle tile


@pytest.mark.parametrize("shape", [(4, 1000, 1000, 10), (4, 1000, 1000, 8),
                                   (2, 33, 21, 4), (1, 5, 0, 3),
                                   (4, 300, 90, 18), (3, 7, 4000, 2)])
def test_b6_k_splits_depend_on_the_shape_only(shape):
    """K is cut into S consecutive ranges of ``chunk`` rows, a multiple of
    the 16-row k tile, none empty, the same on every call; at the NA
    headline's two forms a launch of 64-output blocks has 7 to 9 blocks
    on each of an H100's 132 SMs."""
    C, O, Kd, P = shape
    S, chunk = tgram.gram_splits(C, O, Kd, P)
    assert (S, chunk) == tgram.gram_splits(C, O, Kd, P)
    assert S >= 1 and chunk >= 16 and chunk % 16 == 0
    assert S * chunk >= Kd and (S - 1) * chunk < max(Kd, 1)
    if (O, Kd) == (1000, 1000):
        blocks = -(-O // 64) * S * C * tgram.gram_tiles(P)[1]
        assert 7 * 132 <= blocks < 9 * 132


def _masked_gram_as_kernel(v, w, s, a):
    """csrc/masked_gram.cu's summation in plain PyTorch: each k range of
    ``gram_splits`` summed into the packed columns (``gram_columns``), the
    ranges added in split order, then G's pairs written to both halves and
    R's entries to R."""
    C, Kd, P = v.shape
    O = w.shape[0]
    colp, colq = (t.long() for t in tgram.gram_columns(P))
    n_pair = P * (P + 1) // 2
    S, chunk = tgram.gram_splits(C, O, Kd, P)
    a = torch.ones((C, Kd)) if a is None else a
    total = torch.zeros((C, O, n_pair + P))
    for sp in range(S):
        k = slice(sp * chunk, min(Kd, (sp + 1) * chunk))
        vk, ak = v[:, k], a[:, k]
        bg = ak[..., None] * vk[..., colp[:n_pair]] * vk[..., colq[:n_pair]]
        br = ak[..., None] * vk
        part = torch.cat([torch.einsum("ok,ckn->con", w[:, k], bg),
                          torch.einsum("cok,ckp->cop", w[None, :, k]
                                       * s[:, :, k], br)], dim=2)
        total = total + part
    G = torch.empty((C, O, P, P))
    G[:, :, colp[:n_pair], colq[:n_pair]] = total[..., :n_pair]
    G[:, :, colq[:n_pair], colp[:n_pair]] = total[..., :n_pair]
    return G, total[..., n_pair:]


@pytest.mark.parametrize("P", [3, 10, 18])
def test_b6_kernel_summation_order_matches_plain(P):
    """The kernel's order of summation (k ranges in split order over the
    packed columns, G mirrored) gives the plain version's G and R to rtol
    1e-5, in both forms; the inputs cut K into several splits, with a
    ragged last range, and include an all-missing species and row."""
    XE, mask, Z, lam, iSigma = _gram_inputs(P, C=2, ny=150, ns=111)
    for v, w, s, a in ((_t(XE), _t(mask).T, _t(Z).transpose(1, 2), None),
                       (_t(lam).transpose(1, 2), _t(mask), _t(Z),
                        _t(iSigma))):
        S, chunk = tgram.gram_splits(v.shape[0], w.shape[0], v.shape[1], P)
        assert S >= 3 and v.shape[1] % chunk != 0
        G, R = _masked_gram_as_kernel(v, w, s, a)
        Gp, Rp = tgram._masked_gram_plain(v, w, s, a)
        np.testing.assert_allclose(G.numpy(), Gp.numpy(), rtol=1e-5,
                                   atol=1e-5 * Gp.abs().max().item())
        np.testing.assert_allclose(R.numpy(), Rp.numpy(), rtol=1e-5,
                                   atol=1e-5 * Rp.abs().max().item())
        assert torch.equal(G, G.transpose(2, 3))
        assert not G[:, 0].any() and not R[:, 0].any()


# --- divergence containment ------------------------------------------------

def test_poisson_na_divergence_is_contained():
    """A chain whose state goes non-finite on a mixed model with missing
    values keeps sweeping without an exception, is flagged by
    first_bad_update, and leaves the other chain finite.  The NaN is
    planted in an observed Poisson cell of Z, where B5's guard keeps the
    previous (non-finite) value, so it persists as a diverged chain would."""
    from hmsc_tpu_torch.mcmc.sampler import first_bad_update, initial_states
    from hmsc_tpu_torch.mcmc.structs import build_model_data, build_spec
    from hmsc_tpu_torch.mcmc.sweep import make_sweep
    from hmsc_tpu_torch.precompute import compute_data_parameters

    from test_torch_model import make_models

    _, mt = make_models("na")
    spec = build_spec(mt)
    assert spec.any_poisson and spec.has_na
    data = build_model_data(mt, compute_data_parameters(mt), spec, "cpu")
    state, _ = initial_states(mt, spec, 0, 2, "cpu")
    i, j = [int(k) for k in torch.nonzero(
        (data.Ymask > 0) & (data.distr_family == 3))[0]]
    state = state.replace(Z=state.Z.clone())
    state.Z[1, i, j] = float("nan")
    sweep, rng = make_sweep(spec), trand.Rng(0, "cpu")
    bad = torch.full((2,), -1, dtype=torch.int32)
    for it in range(1, 4):
        state = sweep(data, state, rng, it=it)
        bad = first_bad_update(state, bad)
    assert bad.tolist() == [-1, 1]
    assert all(torch.isfinite(t[0]).all() for t in state.float_tensors())


# --- end to end ------------------------------------------------------------

Z_NY_UNITS, Z_PER, Z_NS, Z_NF = 20, 4, 6, 2
Z_TRANSIENT, Z_SAMPLES, Z_CHAINS = 200, 500, 2


def _mixed_na_model(pkg):
    """The JAX package's config-5 parity design (``tests/test_parity.py``,
    ``test_parity_config5_mixed_distr``): 4 rows per unit, so Lambda is
    identified for the Poisson columns; here with 10% of the cells
    missing and the lognormal-Poisson family beside the fixed-variance
    one."""
    rng = np.random.default_rng(5)
    ny = Z_NY_UNITS * Z_PER
    unit_of = np.repeat(np.arange(Z_NY_UNITS), Z_PER)
    X = np.column_stack([np.ones(ny), rng.standard_normal(ny)])
    L = X @ (rng.standard_normal((2, Z_NS)) * 0.4)
    Y = np.empty((ny, Z_NS))
    Y[:, :2] = L[:, :2] + rng.standard_normal((ny, 2))
    Y[:, 2:4] = (L[:, 2:4] + rng.standard_normal((ny, 2)) > 0).astype(float)
    Y[:, 4:] = rng.poisson(np.exp(np.clip(L[:, 4:], -5, 2.0)))
    Y[rng.uniform(size=Y.shape) < 0.1] = np.nan
    study = pd.DataFrame({"sample": [f"u{u:03d}" for u in unit_of]})
    rl = pkg.HmscRandomLevel(units=study["sample"])
    pkg.set_priors_random_level(rl, nf_max=Z_NF, nf_min=Z_NF)
    return pkg.Hmsc(Y=Y, X=X, distr=["normal", "normal", "probit", "probit",
                                     "lognormal poisson", "poisson"],
                    study_design=study, ran_levels={"sample": rl},
                    x_scale=False)


def test_mixed_na_posterior_moments_match_jax():
    kw = dict(samples=Z_SAMPLES, transient=Z_TRANSIENT, n_chains=Z_CHAINS,
              nf_cap=Z_NF, align_post=False)
    pj = hmsc_tpu.sample_mcmc(_mixed_na_model(hmsc_tpu), seed=4, **kw)
    pt = hmsc_tpu_torch.sample_mcmc(_mixed_na_model(hmsc_tpu_torch), seed=6,
                                    device="cpu", **kw)
    assert pt.chain_health["good_chains"].all()
    for k in ("Beta", "sigma", "Lambda_0"):
        assert pt[k].shape == pj[k].shape and np.isfinite(pt[k]).all(), k
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    lam_j, lam_t = pj["Lambda_0"][..., 0], pt["Lambda_0"][..., 0]
    om_j = np.einsum("csfj,csfk->csjk", lam_j, lam_j)
    om_t = np.einsum("csfj,csfk->csjk", lam_t, lam_t)
    _assert_parity([_z_scores(pj["Beta"], flat(pt["Beta"])),
                    _z_scores(om_j, flat(om_t)),
                    _z_scores(pj["sigma"], flat(pt["sigma"]))], "mixed+NA")
