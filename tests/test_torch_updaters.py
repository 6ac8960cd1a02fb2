"""Each ported updater, and one whole sweep, against the JAX package's from
one identical state.  The port receives the very draws the JAX updater
makes: the test repeats the JAX updater's key splits and hands the
resulting normals, uniforms and (unit-rate) gamma draws to the port's
``noise=`` hook.  Agreement is to rtol 1e-4 / atol 1e-5 (float32 sums taken
in another order by XLA and by PyTorch, compounded over a few blocks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hmsc_tpu
from hmsc_tpu.mcmc import sweep as jsweep
from hmsc_tpu.mcmc import updaters as JU
from hmsc_tpu.ops.rand import _TINY, standard_gamma as jgamma

from hmsc_tpu_torch.mcmc import sweep as tsweep
from hmsc_tpu_torch.mcmc import updaters as TU
from hmsc_tpu_torch.mcmc.structs import build_spec
from hmsc_tpu_torch.ops import rand as trand

from test_torch_model import (flatten, jax_triple, make_models, model_inputs,
                              to_torch)

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
SEEDS = (3, 4)                       # two chains, distinct initial states


def _t(a):
    return torch.tensor(np.asarray(a))


def _stack(per_chain):
    """Stack per-chain noise structures (dicts / lists of arrays) along a
    new leading chain axis."""
    first = per_chain[0]
    if isinstance(first, dict):
        return {k: _stack([p[k] for p in per_chain]) for k in first}
    if isinstance(first, list):
        return [_stack([p[i] for p in per_chain]) for i in range(len(first))]
    return torch.stack([_t(p) for p in per_chain])


def _setup(kind="probit", it=None, **kw):
    mj, mt = make_models(kind, **kw)
    spec_j, data_j, states_j = jax_triple(mj, seeds=SEEDS)
    if it is not None:
        states_j = [s.replace(it=jnp.asarray(it, jnp.int32))
                    for s in states_j]
    data_t, state_t = to_torch(spec_j, data_j, states_j)
    spec_t = build_spec(mt)
    keys = [jax.random.key(100 + c) for c in range(len(SEEDS))]
    return spec_j, data_j, states_j, spec_t, data_t, state_t, keys


def _compare(port_state, jax_states, fields=None):
    """Every (or the named) field of the port's batched state against the
    per-chain JAX states."""
    ref = {}
    for c, s in enumerate(jax_states):
        for k, v in flatten(s).items():
            ref.setdefault(k, []).append(v)
    for k, vals in ref.items():
        if k in ("BetaSel", "wRRR", "PsiRRR", "DeltaRRR"):
            continue
        if fields is not None and k.rpartition(".")[2] not in fields:
            continue
        head, _, field = k.rpartition(".")
        obj = port_state.levels[int(head.split(".")[1])] if head \
            else port_state
        np.testing.assert_allclose(getattr(obj, field).numpy(),
                                   np.stack(vals), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# --- the JAX updaters' draws, by repeating their key splits ---------------

def z_noise(spec, key):
    """The draws of each active branch of ``update_z`` (``k_tn, k_pg, k_pg2,
    k_na``, updaters.py:152)."""
    k_tn, k_pg, k_pg2, k_na = jax.random.split(key, 4)
    shape = (spec.ny, spec.ns)
    out = {}
    if spec.any_probit:
        out["u"] = jax.random.uniform(k_tn, shape, minval=_TINY, maxval=1.0)
    if spec.any_poisson:
        out["eps_pg"] = jax.random.normal(k_pg, shape)
        out["eps_z"] = jax.random.normal(k_pg2, shape)
    if spec.has_na:
        out["eps_na"] = jax.random.normal(k_na, shape)
    return out


def beta_lambda_noise(spec, key):
    return {"eps": jax.random.normal(key, (spec.ns, spec.nc + spec.nf_total))}


def gamma_v_noise(spec, key):
    kv, kg = jax.random.split(key)
    kn, kc = jax.random.split(kv)
    p = spec.nc
    # the default float type: float64 under jax.enable_x64, as the JAX
    # wishart draws there
    dfs = (spec.f0 + spec.ns - jnp.arange(p, dtype=jnp.zeros(()).dtype)) \
        / 2.0
    return {"wishart": {"normal": jax.random.normal(kn, (p, p)),
                        "gamma": jgamma(kc, dfs)},
            "gamma": {"eps": jax.random.normal(kg, (spec.nc * spec.nt,))}}


def lambda_priors_noise(spec, data, state, key):
    out = []
    for r in range(spec.nr):
        lvd, lv, ls = data.levels[r], state.levels[r], spec.levels[r]
        kpsi, kdel = jax.random.split(jax.random.fold_in(key, r))
        a_psi = lvd.nu[None, None, :] / 2 + 0.5
        psi = jgamma(kpsi, jnp.broadcast_to(a_psi, lv.Lambda.shape))
        mask = lv.nf_mask
        nf_act = mask.sum()
        n_geq = jnp.cumsum(mask[::-1])[::-1]
        keys = jax.random.split(kdel, ls.nf_max)
        delta = []
        for h in range(ls.nf_max):
            ad = (lvd.a1 + 0.5 * spec.ns * nf_act if h == 0
                  else lvd.a2 + 0.5 * spec.ns * n_geq[h])
            delta.append(jgamma(keys[h], jnp.broadcast_to(ad, (ls.ncr,))))
        out.append({"psi": psi, "delta": jnp.stack(delta)})
    return out


def eta_noise(spec, key, r):
    ls = spec.levels[r]
    return {"eps": jax.random.normal(key, (ls.n_units, ls.nf_max))}


def scale_noise(spec, key):
    out = []
    for r in range(spec.nr):
        kr1, kr2 = jax.random.split(jax.random.fold_in(key, r))
        nf = spec.levels[r].nf_max
        out.append({"u": jax.random.normal(kr1, (nf,)),
                    "acc": jax.random.uniform(kr2, (nf,), minval=1e-38)})
    return out


def location_noise(spec, key):
    return [jax.random.normal(jax.random.fold_in(key, r),
                              (spec.levels[r].nf_max,))
            for r in range(spec.nr)]


def inv_sigma_noise(spec, data, key):
    shape = data.aSigma + 0.5 * data.Ymask.sum(axis=0)
    return {"gamma": jgamma(key, shape)}


def nf_noise(spec, data, key, r):
    lvd, ls = data.levels[r], spec.levels[r]
    ku, kadd = jax.random.split(jax.random.fold_in(key, r))
    k_eta, k_psi, k_del = jax.random.split(kadd, 3)
    return {"u": jax.random.uniform(ku),
            "eta": jax.random.normal(k_eta, (ls.n_units,)),
            "psi": jgamma(k_psi, jnp.broadcast_to(lvd.nu[None, :] / 2,
                                                  (spec.ns, ls.ncr))),
            "delta": jgamma(k_del, lvd.a2)}


def sweep_noise(spec, data, state, key):
    """Every draw of one JAX sweep (``sweep.py:76-345``), by block."""
    ks = jax.random.split(key, 13)
    kI1, kI2 = jax.random.split(ks[12])
    return {
        "BetaLambda": beta_lambda_noise(spec, ks[0]),
        "GammaV": gamma_v_noise(spec, ks[1]),
        "LambdaPriors": lambda_priors_noise(spec, data, state, ks[3]),
        "Eta": [eta_noise(spec, jax.random.fold_in(ks[4], r), r)
                for r in range(spec.nr)],
        "Interweave": {"scale": scale_noise(spec, kI1),
                       "location": location_noise(spec, kI2)},
        "InvSigma": (inv_sigma_noise(spec, data, ks[6])
                     if spec.any_estimated_sigma else None),
        "Z": z_noise(spec, ks[7]),
        "Nf": [nf_noise(spec, data, jax.random.fold_in(ks[5], 1000 + r), r)
               for r in range(spec.nr)],
    }


def _sweep_noise_stacked(spec, data, states, keys):
    per = [sweep_noise(spec, data, s, k) for s, k in zip(states, keys)]
    out = {}
    for name in per[0]:
        out[name] = None if per[0][name] is None else _stack(
            [p[name] for p in per])
    return out


# --- the updaters --------------------------------------------------------

@pytest.mark.parametrize("kind", ["probit", "normal", "mixed", "na"])
def test_update_z(kind):
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup(kind)
    ref = [JU.update_z(spec_j, data_j, s, k) for s, k in zip(states_j, keys)]
    noise = _stack([z_noise(spec_j, k) for k in keys])
    out = TU.update_z(spec_t, data_t, state_t, noise=noise)
    _compare(out, ref, fields={"Z"})


@pytest.mark.parametrize("kind", ["probit", "normal", "mixed", "na"])
def test_update_beta_lambda(kind):
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup(kind)
    ref = [JU.update_beta_lambda(spec_j, data_j, s, k)
           for s, k in zip(states_j, keys)]
    noise = _stack([beta_lambda_noise(spec_j, k) for k in keys])
    out = TU.update_beta_lambda(spec_t, data_t, state_t, noise=noise)
    _compare(out, ref, fields={"Beta", "Lambda"})


@pytest.mark.parametrize("kind", ["probit", "normal"])
def test_update_gamma_v(kind):
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup(kind)
    ref = [JU.update_gamma_v(spec_j, data_j, s, k)
           for s, k in zip(states_j, keys)]
    noise = _stack([gamma_v_noise(spec_j, k) for k in keys])
    out = TU.update_gamma_v(spec_t, data_t, state_t, noise=noise)
    _compare(out, ref, fields={"iV", "Gamma"})


def test_update_lambda_priors():
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup()
    ref = [JU.update_lambda_priors(spec_j, data_j, s, k)
           for s, k in zip(states_j, keys)]
    noise = _stack([lambda_priors_noise(spec_j, data_j, s, k)
                    for s, k in zip(states_j, keys)])
    out = TU.update_lambda_priors(spec_t, data_t, state_t, noise=noise)
    _compare(out, ref, fields={"Psi", "Delta"})


def _shrinkage_replay(Lambda, mask, Delta, nu, a1, b1, a2, b2, g_psi,
                      g_delta):
    """B3's shrinkage form (csrc/shrinkage_gamma.cu) replayed in float32 on
    the CPU from its unit draws: each (row, piece) item of
    ``shrinkage_geometry`` summed by its warp's lanes over the piece's
    species in turn, the xor-shuffle tree; a row's pieces by a warp (a
    lane's pieces in order, the same tree); each step's
    tail as the product of the deltas drawn before it times the sum over
    the factors from it on at their entry deltas; then the chain over the
    factors a column.  Returns (Psi, Delta, items a species was drawn
    in)."""
    f32 = np.float32
    C, nf, ns, ncr = Lambda.shape
    geo = trand.shrinkage_geometry(nf, ns, ncr)
    P, plen = geo["P"], geo["plen"]
    R = nf * ncr
    Psi = np.zeros(Lambda.shape, f32)
    hits = np.zeros(Lambda.shape, np.int64)
    Dout = np.zeros(Delta.shape, f32)
    lane = np.arange(32)
    for c in range(C):
        m = mask[c]
        tau0 = np.ones((nf, ncr), f32)
        p = np.ones(ncr, f32)
        for f in range(nf):
            p = p * np.where(m[f] > 0, Delta[c, f], f32(1))
            tau0[f] = p
        part = np.zeros(R * P, f32)
        for it in range(R * P):
            row, piece = divmod(it, P)
            f, col = divmod(row, ncr)
            sl = slice(piece * plen, min(ns, (piece + 1) * plen))
            lm = Lambda[c, f, sl, col] * m[f]
            lam2 = lm * lm
            b = f32(0.5) * nu[col] + (f32(0.5) * lam2) * tau0[f, col]
            psi = g_psi[c, f, sl, col] / b
            Psi[c, f, sl, col] = psi
            hits[c, f, sl, col] += 1
            x = psi * lam2
            x = np.concatenate([x, np.zeros(-len(x) % 32, f32)])
            acc = np.zeros(32, f32)
            for r in x.reshape(-1, 32):
                acc = acc + r
            for o in (16, 8, 4, 2, 1):
                acc = acc + acc[lane ^ o]
            part[it] = acc[0]
        msum = np.zeros(R, f32)
        for t in range(R):
            acc = np.zeros(32, f32)
            for q in range(P):
                acc[q % 32] = acc[q % 32] + part[t * P + q]
            for o in (16, 8, 4, 2, 1):
                acc = acc + acc[lane ^ o]
            msum[t] = acc[0]
        msum = msum.reshape(nf, ncr)
        d0 = np.where(m[:, None] > 0, Delta[c], f32(1)).astype(f32)
        q = np.zeros((nf, ncr), f32)
        for h in range(nf):
            p = np.ones(ncr, f32)
            for f in range(h, nf):
                p = p * d0[f]
                q[h] = q[h] + (p * msum[f]) * m[f]
        pre = np.ones(ncr, f32)
        for h in range(nf):
            bd = (b1 if h == 0 else b2) + (f32(0.5) * (pre * q[h])) / d0[h]
            Dout[c, h] = np.where(m[h] > 0, g_delta[c, h] / bd, f32(1))
            pre = pre * Dout[c, h]
    return Psi, Dout, hits


def test_shrinkage_form_summation_order_and_up_front_draws_match_jax():
    """B3's shrinkage form, replayed on the CPU (its launch shape, its
    fixed order of summation, delta's draws taken up front at the shapes
    ``shrinkage_shapes`` gives), against the JAX ``update_lambda_priors``
    with the same unit gamma draws injected: nf_max 8, masks with inactive
    slots, 300 species (3 blocks a chain, 9 pieces a row); Psi and Delta to
    rtol 1e-5, each species drawn once.  The plain update
    (``shrinkage_update``) fed the draws through a per-factor callable
    agrees too."""
    Y, hkw, units = model_inputs("probit", ny=30, ns=300)
    rl = hmsc_tpu.HmscRandomLevel(units=units[0])
    hmsc_tpu.set_priors_random_level(rl, nf_max=8, nf_min=2)
    mj = hmsc_tpu.Hmsc(Y=Y, ran_levels={"unit": rl}, **hkw)
    spec, data, states = jax_triple(mj, seeds=(0, 1, 2))
    assert spec.levels[0].nf_max == 8
    geo = trand.shrinkage_geometry(8, 300, 1)
    assert geo["S"] > 1 and geo["P"] > 1
    g = np.random.default_rng(5)
    masks = np.array([[1, 1, 1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1, 1, 1],
                      [1, 1, 0, 0, 0, 0, 0, 0]], np.float32)
    states = [s.replace(levels=(s.levels[0].replace(
        Lambda=jnp.asarray(g.standard_normal((8, 300, 1)) * 0.7,
                           jnp.float32),
        Delta=jnp.asarray(g.uniform(0.5, 3.0, (8, 1)), jnp.float32),
        nf_mask=jnp.asarray(mk)),)) for s, mk in zip(states, masks)]
    keys = [jax.random.key(300 + c) for c in range(3)]
    ref = [JU.update_lambda_priors(spec, data, s, k).levels[0]
           for s, k in zip(states, keys)]
    noise = [lambda_priors_noise(spec, data, s, k)[0]
             for s, k in zip(states, keys)]
    g_psi = np.stack([np.asarray(n["psi"]) for n in noise])
    g_delta = np.stack([np.asarray(n["delta"]) for n in noise])
    lvd = data.levels[0]
    hyp = [np.array(getattr(lvd, k), np.float32)
           for k in ("nu", "a1", "b1", "a2", "b2")]
    Lambda = np.stack([np.asarray(s.levels[0].Lambda) for s in states])
    Delta = np.stack([np.asarray(s.levels[0].Delta) for s in states])
    # delta's shapes, up front, as the JAX updater forms them step by step
    nu, a1, b1, a2, b2 = (torch.from_numpy(h) for h in hyp)
    _, ad = trand.shrinkage_shapes(torch.from_numpy(masks), nu, a1, a2, 300)
    for c, mk in enumerate(masks):
        n_geq = np.cumsum(mk[::-1])[::-1]
        want = [hyp[1] + 0.5 * 300 * mk.sum()] + [
            hyp[3] + 0.5 * 300 * n_geq[h] for h in range(1, 8)]
        np.testing.assert_array_equal(ad[c].numpy(),
                                      np.asarray(want, np.float32))
    Psi, Dl, hits = _shrinkage_replay(Lambda, masks, Delta, *hyp, g_psi,
                                      g_delta)
    assert (hits == 1).all()
    psi_t, delta_t = trand.shrinkage_update(
        torch.from_numpy(Lambda), torch.from_numpy(masks),
        torch.from_numpy(Delta), nu, b1, b2, torch.from_numpy(g_psi),
        lambda h: torch.from_numpy(g_delta[:, h]))
    for c, lv in enumerate(ref):
        for got in (Psi[c], psi_t[c].numpy()):
            np.testing.assert_allclose(got, np.asarray(lv.Psi), rtol=1e-5)
        for got in (Dl[c], delta_t[c].numpy()):
            np.testing.assert_allclose(got, np.asarray(lv.Delta), rtol=1e-5)


@pytest.mark.parametrize("nf,ns,ncr", [(8, 1000, 1), (2, 90, 1), (2, 50, 1),
                                       (20, 10, 1), (30, 5000, 1),
                                       (3, 7, 2)])
def test_shrinkage_geometry_covers_every_species(nf, ns, ncr):
    """The shrinkage form's launch shape: a cluster of at most 16 blocks of
    at most 512 threads (whole warps) a chain, each row's pieces covering
    its species once with none empty, and at most ~2 psi a lane where the
    cluster's threads allow (1 at the headline's nf 8, ns 1000)."""
    geo = trand.shrinkage_geometry(nf, ns, ncr)
    S, T, P, plen = geo["S"], geo["T"], geo["P"], geo["plen"]
    assert 1 <= S <= 16 and 32 <= T <= 512 and T % 32 == 0
    assert P * plen >= ns and (P - 1) * plen < ns
    warps = S * T // 32
    rounds = -(-(nf * ncr * P) // warps) * -(-plen // 32)
    if nf * ns * ncr <= 8 * 1024 and nf * ncr <= 256:
        assert rounds <= 2
    if (nf, ns) == (8, 1000):
        assert (S, T, P, plen, rounds) == (16, 512, 32, 32, 1)


@pytest.mark.parametrize("nf,ns,allowed,want", [
    (8, 1000, 16, 16), (8, 1000, 8, 8), (8, 1000, 0, 1),
    (20, 5000, 12, 12), (2, 90, 8, 1)])
def test_shrinkage_cluster_is_chosen_by_the_query(nf, ns, allowed, want):
    """The shrinkage form's cluster size is the largest, from 16 blocks
    down, that the card's occupancy query accepts (stubbed here: clusters
    of at most ``allowed`` blocks); the pieces stay those of 16 blocks, so
    the update's sums, and its bits, do not depend on it."""
    asked = []

    def schedulable(S, T, smem):
        asked.append(S)
        assert smem == trand.shrinkage_smem(nf, 1, geo16["P"])
        return S <= allowed

    geo16 = trand.shrinkage_geometry(nf, ns, 1)
    geo = trand.shrinkage_choose(nf, ns, 1, schedulable)
    assert geo["S"] == min(want, geo16["S"])
    assert (geo["P"], geo["plen"]) == (geo16["P"], geo16["plen"])
    assert geo == trand.shrinkage_geometry(nf, ns, 1, geo["S"])
    assert asked == sorted(asked, reverse=True)
    warps = geo["S"] * geo["T"] // 32
    assert warps >= 1 and geo["T"] <= 512


@pytest.mark.parametrize("n_units", [None, 10])
def test_update_eta_nonspatial(n_units):
    _check_eta_nonspatial("probit", n_units)


@pytest.mark.parametrize("kind,n_units", [("mixed", None), ("na", None),
                                          ("na", 10)])
def test_update_eta_nonspatial_mixed_and_na(kind, n_units):
    _check_eta_nonspatial(kind, n_units)


def _check_eta_nonspatial(kind, n_units):
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup(
        kind, n_units=n_units)
    ref = []
    for s, k in zip(states_j, keys):
        S = s.Z - JU.linear_fixed(spec_j, data_j, s.Beta)
        ref.append(s.replace(levels=(JU.update_eta_nonspatial(
            spec_j, data_j, s, 0, k, S),)))
    noise = _stack([eta_noise(spec_j, k, 0) for k in keys])
    S = state_t.Z - TU.linear_fixed(spec_t, data_t, state_t.Beta)
    lv = TU.update_eta_nonspatial(spec_t, data_t, state_t, 0, S=S,
                                  noise=noise)
    _compare(state_t.replace(levels=(lv,)), ref, fields={"Eta"})


def test_interweave_scale_and_location():
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup()
    ref = [JU.interweave_location(spec_j, data_j,
                                  JU.interweave_scale(spec_j, data_j, s, k),
                                  jax.random.fold_in(k, 9))
           for s, k in zip(states_j, keys)]
    sc = _stack([scale_noise(spec_j, k) for k in keys])
    loc = _stack([location_noise(spec_j, jax.random.fold_in(k, 9))
                  for k in keys])
    out = TU.interweave_location(
        spec_t, data_t, TU.interweave_scale(spec_t, data_t, state_t,
                                            noise=sc), noise=loc)
    _compare(out, ref, fields={"Eta", "Lambda", "Beta"})
    # the scale move must have been accepted somewhere for this to test it
    assert not np.allclose(out.levels[0].Eta.numpy(),
                           state_t.levels[0].Eta.numpy())


def test_update_inv_sigma():
    _check_inv_sigma("normal")


@pytest.mark.parametrize("kind", ["mixed", "na"])
def test_update_inv_sigma_mixed_and_na(kind):
    """Estimated dispersion for normal and lognormal-Poisson columns, the
    fixed 1e-2 of "poisson" and 1 of probit, over the observed cells."""
    out = _check_inv_sigma(kind)
    fam = out[1].distr_family.numpy()
    np.testing.assert_allclose(out[0].iSigma.numpy()[:, fam == 2], 1.0)
    np.testing.assert_allclose(out[0].iSigma.numpy()[:, fam == 3][
        :, out[1].distr_estsig.numpy()[fam == 3] == 0], 100.0)


def _check_inv_sigma(kind):
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup(kind)
    ref = [JU.update_inv_sigma(spec_j, data_j, s, k)
           for s, k in zip(states_j, keys)]
    noise = _stack([inv_sigma_noise(spec_j, data_j, k) for k in keys])
    out = TU.update_inv_sigma(spec_t, data_t, state_t, noise=noise)
    _compare(out, ref, fields={"iSigma"})
    return out, data_t


def _nf_case(case):
    """A state where the Nf move adapts: 'grow' past sweep 20, or 'drop' a
    factor whose loadings all shrank below the threshold."""
    setup = _setup(it=30 if case == "grow" else 5, nf=4)
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = setup
    if case == "drop":
        # three active factors (above nf_min = 2), the first one shrunk
        states_j = [s.replace(levels=(s.levels[0].replace(
            Lambda=s.levels[0].Lambda.at[0].multiply(1e-5),
            nf_mask=s.levels[0].nf_mask.at[2].set(1.0)),))
            for s in states_j]
        data_t, state_t = to_torch(spec_j, data_j, states_j)
    # keys whose adaptation draw fires (u < 1/exp(1 + 5e-4 it) ~ 0.36)
    keys, i = [], 0
    while len(keys) < len(states_j):
        k = jax.random.key(500 + i)
        i += 1
        if float(nf_noise(spec_j, data_j, k, 0)["u"]) < 0.3:
            keys.append(k)
    return spec_j, data_j, states_j, spec_t, data_t, state_t, keys


@pytest.mark.parametrize("case", ["grow", "drop"])
def test_update_nf(case):
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _nf_case(case)
    ref = [s.replace(levels=(JU.update_nf(spec_j, data_j, s, 0, k),))
           for s, k in zip(states_j, keys)]
    noise = _stack([nf_noise(spec_j, data_j, k, 0) for k in keys])
    lv = TU.update_nf(spec_t, data_t, state_t, 0, noise=noise)
    out = state_t.replace(levels=(lv,))
    _compare(out, ref)
    before = state_t.levels[0].nf_mask.sum(1)
    after = lv.nf_mask.sum(1)
    assert ((after > before) if case == "grow" else (after < before)).all()


@pytest.mark.parametrize("kind,levels", [("probit", 1), ("normal", 1),
                                         ("probit", 2), ("mixed", 1),
                                         ("na", 1)])
def test_full_sweep_and_record(kind, levels):
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup(
        kind, it=4, levels=levels)
    adapt = (10,) * levels
    jsw = jsweep.make_sweep(spec_j, adapt_nf=adapt)
    ref = [jsw(data_j, s, k) for s, k in zip(states_j, keys)]
    noise = _sweep_noise_stacked(spec_j, data_j, states_j, keys)
    out = tsweep.make_sweep(spec_t, adapt_nf=adapt)(data_t, state_t, None,
                                                    it=5, noise=noise)
    _compare(out, ref)
    rec_t = tsweep.record_sample(spec_t, data_t, out)
    rec_j = [jsweep.record_sample(spec_j, data_j, s) for s in ref]
    assert set(rec_t) == set(rec_j[0])
    for k, v in rec_t.items():
        np.testing.assert_allclose(
            v.numpy(), np.stack([np.asarray(r[k]) for r in rec_j]),
            rtol=RTOL, atol=ATOL, err_msg=k)
