"""End-to-end parity: the port's ``sample_mcmc`` (on the CPU, with its
kernels' plain versions) against the JAX package's ``sample_mcmc`` on the
same small probit model.  The random streams differ (Philox/mt19937 vs
threefry), so the posteriors are compared by moments: two-sample z-scores
of posterior means with ESS-based standard errors, the test_parity.py
criterion (max z < 5, mean z < 1.5).  The chains' initial states, drawn
from the same numpy seed table, must be equal."""

import numpy as np
import pytest
import torch

import hmsc_tpu
from hmsc_tpu import effective_size
from hmsc_tpu.mcmc import structs as jstructs

import hmsc_tpu_torch
from hmsc_tpu_torch.mcmc import structs as tstructs
from hmsc_tpu_torch.mcmc.sampler import initial_states

from test_torch_model import flatten, make_models

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

Z_MAX, Z_MEAN = 5.0, 1.5
NY, NS, NF = 60, 6, 3
TRANSIENT, SAMPLES, CHAINS = 150, 350, 2


def _z_scores(jax_draws, np_draws):
    """Entrywise two-sample z between (chains, n, ...) and (n, ...) draws
    (copied from tests/test_parity.py:103-128).  Constant entries are
    required to match exactly instead; the first side's SE is the larger of
    the ESS-based and the between-chain estimate."""
    A, B = np.asarray(jax_draws), np.asarray(np_draws)[None]
    mA, mB = A.mean(axis=(0, 1)), B.mean(axis=(0, 1))
    sA, sB = A.std(axis=(0, 1)), B.std(axis=(0, 1))
    live = (sA > 1e-10) & (sB > 1e-10)
    np.testing.assert_allclose(np.where(live, 0, mA), np.where(live, 0, mB),
                               atol=1e-6)
    seA = sA / np.sqrt(np.maximum(effective_size(A), 1.0))
    if A.shape[0] >= 2:
        between = A.mean(axis=1).std(axis=0, ddof=1) / np.sqrt(A.shape[0])
        seA = np.maximum(seA, between)
    seB = sB / np.sqrt(np.maximum(effective_size(B), 1.0))
    z = np.abs(mA - mB) / np.sqrt(seA**2 + seB**2 + 1e-30)
    return z[live]


def _assert_parity(z_all, label):
    z = np.concatenate([np.atleast_1d(z).ravel() for z in z_all])
    assert z.max() < Z_MAX and z.mean() < Z_MEAN, (
        label, float(z.max()), float(z.mean()))


def _omega(post):
    lam = post.pooled("Lambda_0")[..., 0]
    om = np.einsum("nfj,nfk->njk", lam, lam)
    return om.reshape((post.n_chains, -1) + om.shape[1:])


@pytest.fixture(scope="module")
def models():
    return make_models("probit", ny=NY, ns=NS, nf=NF, seed=66)


def test_posterior_moments_match_jax(models):
    mj, mt = models
    kw = dict(samples=SAMPLES, transient=TRANSIENT, n_chains=CHAINS)
    pj = hmsc_tpu.sample_mcmc(mj, seed=1, **kw)
    pt = hmsc_tpu_torch.sample_mcmc(mt, seed=2, device="cpu", **kw)
    assert pt["Beta"].shape == pj["Beta"].shape
    assert pt.chain_health["good_chains"].all()
    for k in pj.arrays:
        assert pt[k].shape == pj[k].shape, k
        assert np.isfinite(pt[k]).all(), k
    beta_t = pt["Beta"].reshape((-1,) + pt["Beta"].shape[2:])
    om_t = _omega(pt).reshape((-1, NS, NS))
    _assert_parity([_z_scores(pj["Beta"], beta_t),
                    _z_scores(_omega(pj), om_t)], "probit")
    assert set(pt.timing) == {"setup_s", "run_s"}


def test_chain_zero_initial_state_matches_jax_sampler(models):
    mj, mt = models
    seed, n = 5, 3
    # the JAX sampler's seed table (hmsc_tpu/mcmc/sampler.py:1166-1170, 1198)
    rng = np.random.default_rng(seed)
    chain_seeds = rng.integers(0, 2**31 - 1, size=n)
    spec_j = jstructs.build_spec(mj, 16)
    ref = flatten(jstructs.build_state(mj, spec_j, int(chain_seeds[0])))
    state, _ = initial_states(mt, tstructs.build_spec(mt), seed, n, "cpu")
    assert state.n_chains == n
    for k, v in ref.items():
        if k in ("BetaSel", "wRRR", "PsiRRR", "DeltaRRR"):
            continue
        head, _, field = k.rpartition(".")
        obj = state.levels[int(head.split(".")[1])] if head else state
        np.testing.assert_array_equal(getattr(obj, field)[0].numpy(), v,
                                      err_msg=k)


def test_record_restriction_and_thinning(models):
    _, mt = models
    post = hmsc_tpu_torch.sample_mcmc(mt, samples=4, transient=2, thin=2,
                                      n_chains=2, seed=3, device="cpu",
                                      record=("Eta",), align_post=False)
    assert set(post.arrays) == {"Beta", "Eta_0", "Lambda_0", "nfMask_0"}
    assert post["Beta"].shape == (2, 4, 2, NS)
    with pytest.raises(ValueError, match="unknown parameter"):
        hmsc_tpu_torch.sample_mcmc(mt, samples=1, device="cpu",
                                   record=("Nope",))


def test_divergence_is_contained_not_raised(models):
    """A chain whose state goes non-finite is reported by first_bad_it and
    excluded from pooled summaries; the factorisations return NaN instead
    of raising."""
    _, mt = models
    from hmsc_tpu_torch.mcmc.sampler import first_bad_update
    spec = tstructs.build_spec(mt)
    state, _ = initial_states(mt, spec, 0, 2, "cpu")
    state = state.replace(Beta=state.Beta.clone())
    state.Beta[1, 0, 0] = float("nan")
    bad = first_bad_update(state.replace(it=state.it + 3),
                           torch.full((2,), -1, dtype=torch.int32))
    assert bad.tolist() == [-1, 3]
