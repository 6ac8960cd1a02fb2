"""The probit-DA intercept interweave (``updater={"InterweaveDA": True}``)
in the port against the JAX package: the two-sided truncated normal (the
plain version behind kernel B7), the updater with its truncation interval
over NA cells and all-one / all-zero columns and on a mixed-family model,
its structural gate, one whole sweep with the block on, and the sampler.
The port receives the JAX updater's uniforms (its key repeated here)
through ``noise=``.  The CUDA kernel runs only on the card;
``chip_smoke.py`` holds it against these plain versions there."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hmsc_tpu
from hmsc_tpu.mcmc import structs as jstructs
from hmsc_tpu.mcmc import sweep as jsweep
from hmsc_tpu.mcmc import updaters as JU
from hmsc_tpu.ops import rand as jrand

import hmsc_tpu_torch
from hmsc_tpu_torch.mcmc import structs as tstructs
from hmsc_tpu_torch.mcmc import sweep as tsweep
from hmsc_tpu_torch.mcmc import updaters as TU
from hmsc_tpu_torch.ops import rand as trand

from test_torch_model import jax_triple, model_inputs, to_torch
from test_torch_sampler import _assert_parity, _z_scores
from test_torch_updaters import _compare, _stack, sweep_noise

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
SEEDS = (3, 4)


def _t(a):
    return torch.tensor(np.asarray(a))


# --- the two-sided truncated normal -----------------------------------------

def _tn_inputs():
    """Bounds of every kind the updater meets, each at 6 uniforms: the
    smallest (1e-38), one ulp below 1, and four inside."""
    inf = np.inf
    cases = [(-1.0, 2.0, 0.0, 1.0), (0.5, 3.0, 0.0, 1.0),      # two-sided
             (-3.0, -0.5, 0.0, 1.0), (-0.2, 0.1, 3.0, 0.5),
             (0.0, inf, 0.0, 1.0), (-inf, 0.0, 0.0, 1.0),      # one-sided
             (-inf, inf, 1.5, 2.0),                            # both infinite
             (12.0, inf, 0.0, 1.0), (-inf, -15.0, 0.0, 1.0),   # |a| > 9
             (10.0, 10.5, 0.0, 1.0), (-30.0, -29.0, 0.0, 1.0),
             (9.5, 40.0, 0.0, 1.0), (-2.0, 2.0, 50.0, 3.0),
             (1e-3, 2e-3, 0.0, 1.0)]
    lo, hi, mean, sd = (np.repeat(np.asarray(c, np.float32), 6)
                        for c in zip(*cases))
    u = np.tile(np.asarray([1e-38, np.nextafter(np.float32(1), 0), 0.5,
                            0.01, 0.99, 0.3], np.float32), len(cases))
    return lo, hi, mean, sd, u


def test_truncated_normal_plain_matches_jax_with_injected_uniforms():
    """The plain two-sided truncated normal against the JAX op with the
    same uniforms: one- and two-sided intervals, infinite bounds, far tails
    past 9 sigma, u = 1e-38 and u one ulp below 1 (rtol / atol 1e-5: f32
    ndtr / ndtri differ between the libraries by a few ulps); every draw
    is finite and inside its interval."""
    lo, hi, mean, sd, u = _tn_inputs()
    want = np.asarray(jrand.truncated_normal(
        jax.random.key(0), jnp.asarray(lo), jnp.asarray(hi),
        mean=jnp.asarray(mean), std=jnp.asarray(sd), _u=jnp.asarray(u)))
    got = trand.truncated_normal(_t(lo), _t(hi), mean=_t(mean), std=_t(sd),
                                 _u=_t(u)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    slack = 1e-6 * (1 + np.abs(mean))
    assert ((got >= lo - slack) & (got <= hi + slack)).all()


# --- the updater ------------------------------------------------------------

def _models(kind, ns=8):
    """Both packages' model of ``kind`` (test_torch_model.model_inputs) with
    an all-one and an all-zero probit column planted (their observed
    cells, for "na")."""
    Y, hkw, units = model_inputs(kind, ny=40, ns=ns, seed=11)
    Y = Y.copy()
    distr = hkw.get("distr", "probit")
    probit = [j for j in range(ns)
              if (distr if isinstance(distr, str) else distr[j]) == "probit"]
    for j, v in zip(probit[:2], (1.0, 0.0)):
        Y[:, j] = np.where(np.isnan(Y[:, j]), np.nan, v)
    out = []
    for pkg in (hmsc_tpu, hmsc_tpu_torch):
        rl = pkg.HmscRandomLevel(units=units[0])
        pkg.set_priors_random_level(rl, nf_max=3, nf_min=2)
        out.append(pkg.Hmsc(Y=Y, ran_levels={"unit": rl}, **hkw))
    return tuple(out)


def _setup(kind):
    """Chain states after one JAX update_z, so that Z agrees with the signs
    of Y, on the JAX and the port side."""
    mj, mt = _models(kind)
    spec_j, data_j, states_j = jax_triple(mj, seeds=SEEDS)
    states_j = [JU.update_z(spec_j, data_j, s, jax.random.key(50 + c))
                for c, s in enumerate(states_j)]
    data_t, state_t = to_torch(spec_j, data_j, states_j)
    keys = [jax.random.key(400 + c) for c in range(len(SEEDS))]
    return spec_j, data_j, states_j, tstructs.build_spec(mt), data_t, \
        state_t, keys


def da_noise(spec, key):
    """truncated_normal's uniforms in ``interweave_da_intercept``
    (``rand.py:47-49``, one per species)."""
    return {"u": jax.random.uniform(key, (spec.ns,), minval=jrand._TINY,
                                    maxval=1.0)}


@pytest.mark.parametrize("kind", ["probit", "mixed", "na"])
def test_interweave_da_intercept(kind):
    """The port's move against the JAX package's with the same uniforms:
    the new intercepts and Z (rtol 1e-4 / atol 1e-5); the all-one and
    all-zero columns draw from one-sided intervals; non-probit columns and
    their Z are left exactly as they were; Z - Beta[int] is unchanged."""
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup(kind)
    assert spec_t.has_na == (kind == "na")
    ref = [JU.interweave_da_intercept(spec_j, data_j, s, k)
           for s, k in zip(states_j, keys)]
    noise = _stack([da_noise(spec_j, k) for k in keys])
    out = TU.interweave_da_intercept(spec_t, data_t, state_t, noise=noise)
    _compare(out, ref, fields={"Beta", "Z"})
    ii = data_t.x_ones_ind
    prob = data_t.distr_family == 2
    assert not torch.equal(out.Beta[:, ii, prob], state_t.Beta[:, ii, prob])
    assert torch.equal(out.Beta[:, ii, ~prob], state_t.Beta[:, ii, ~prob])
    assert torch.equal(out.Z[..., ~prob], state_t.Z[..., ~prob])
    R0 = state_t.Z - state_t.Beta[:, ii][:, None]
    R1 = out.Z - out.Beta[:, ii][:, None]
    torch.testing.assert_close(R1, R0, rtol=0, atol=1e-5)


def test_da_intercept_draw_plain_bounds():
    """The truncation interval in the plain version: an all-one column has
    no upper bound, an all-zero one no lower bound, NA cells none; the new
    Z keeps the signs of Y on every observed probit cell."""
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup("na")
    ii = data_t.x_ones_ind
    Mu = state_t.Gamma @ data_t.Tr.T
    up = (state_t.iV[:, ii, None, :] @ (state_t.Beta - Mu))[:, 0]
    t, Z = trand.da_intercept_draw(
        state_t.Z, data_t.Y, data_t.Ymask, data_t.distr_family,
        state_t.Beta, ii, up, state_t.iV[:, ii, ii].contiguous(),
        trand.Rng(1, "cpu"))
    prob = (data_t.distr_family == 2).numpy()
    obs = data_t.Ymask.numpy() > 0
    sign = np.where(data_t.Y.numpy() > 0.5, 1.0, -1.0)
    z = Z.numpy()
    assert (sign * z >= -1e-5)[:, obs & prob[None]].all()
    assert np.isfinite(t.numpy()).all()


@pytest.mark.parametrize("kind", ["probit", "normal", "no_intercept"])
def test_da_intercept_gate_matches_jax(kind):
    """The gate gives the JAX package's answer: eligible on a probit model
    with an intercept, refused (with the same reason) without a probit
    column or without an intercept."""
    Y, hkw, units = model_inputs("normal" if kind == "normal" else "probit",
                                 ny=20, ns=4, seed=1)
    if kind == "no_intercept":
        hkw["X"] = hkw["X"][:, 1:]
    gates = []
    for pkg, st in ((hmsc_tpu, jstructs), (hmsc_tpu_torch, tstructs)):
        rl = pkg.HmscRandomLevel(units=units[0])
        hM = pkg.Hmsc(Y=Y, ran_levels={"unit": rl}, **hkw)
        spec = st.build_spec(hM)
        ones = st._find_ones_column(hM)
        gate = (JU if pkg is hmsc_tpu else TU).da_intercept_gate
        gates.append(gate(spec, has_intercept=ones is not None))
    assert gates[0] == gates[1]
    assert (gates[1] is None) == (kind == "probit")


# --- the sweep and the sampler -----------------------------------------------

@pytest.mark.parametrize("kind", ["probit", "na"])
def test_full_sweep_with_interweave_da(kind):
    """One whole sweep with the block on, after Z, from identical states
    with every JAX draw injected (rtol 1e-4 / atol 1e-5)."""
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup(kind)
    upd = {"InterweaveDA": True}
    ref = [jsweep.make_sweep(spec_j, updater=upd, adapt_nf=(0,))(
        data_j, s, k) for s, k in zip(states_j, keys)]
    per = []
    for s, k in zip(states_j, keys):
        nz = sweep_noise(spec_j, data_j, s, k)
        ks = jax.random.split(k, 13)
        nz["InterweaveDA"] = da_noise(spec_j, jax.random.fold_in(ks[7], 1))
        per.append(nz)
    noise = {n: None if per[0][n] is None else _stack([p[n] for p in per])
             for n in per[0]}
    names = [n for n, _ in tsweep.make_sweep_schedule(spec_t, updater=upd)]
    assert names[names.index("Z") + 1] == "InterweaveDA"
    out = tsweep.make_sweep(spec_t, updater=upd, adapt_nf=(0,))(
        data_t, state_t, None, it=1, noise=noise)
    _compare(out, ref)


def test_sample_mcmc_with_interweave_da(caplog):
    """The sampler runs the move on the CPU; on a model without a probit
    column the gate switches it off with a log line, as the JAX package's
    does, and the run goes on."""
    _, mt = _models("probit", ns=4)
    post = hmsc_tpu_torch.sample_mcmc(mt, samples=3, transient=2,
                                      n_chains=2, seed=1, device="cpu",
                                      updater={"InterweaveDA": True})
    assert np.isfinite(post["Beta"]).all()
    Y, hkw, units = model_inputs("normal", ny=20, ns=3, seed=2)
    rl = hmsc_tpu_torch.HmscRandomLevel(units=units[0])
    hM = hmsc_tpu_torch.Hmsc(Y=Y, ran_levels={"unit": rl}, **hkw)
    with caplog.at_level(logging.INFO):
        post = hmsc_tpu_torch.sample_mcmc(hM, samples=2, n_chains=1, seed=1,
                                          device="cpu",
                                          updater={"InterweaveDA": True})
    assert "Setting updater$InterweaveDA=FALSE: no probit column" \
        in caplog.text
    assert np.isfinite(post["Beta"]).all()


def test_da_posterior_moments_match_jax():
    """The port's sample_mcmc with the move on against the JAX package's
    (both on, CPU): z-scores of the posterior means of Beta (the
    test_parity.py criterion)."""
    mj, mt = _models("probit", ns=6)
    kw = dict(n_chains=2, updater={"InterweaveDA": True})
    pj = hmsc_tpu.sample_mcmc(mj, samples=200, transient=100, seed=1, **kw)
    pt = hmsc_tpu_torch.sample_mcmc(mt, samples=150, transient=50, seed=2,
                                    device="cpu", **kw)
    assert pt.chain_health["good_chains"].all()
    _assert_parity([_z_scores(pj["Beta"], pt["Beta"].reshape(
        (-1,) + pt["Beta"].shape[2:]))], "InterweaveDA")
