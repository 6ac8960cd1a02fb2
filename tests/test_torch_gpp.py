"""GPP (knot-based predictive-process) spatial levels in the port against
the JAX package: the knots and grids, the plain versions of kernels B8d-1
(per-unit Woodbury blocks), B8d-2 (knot correction) and B8d-3 (prior
quadratics), the GPP Eta draw, the alpha sampler, both interweaving moves,
one whole sweep and a short end-to-end run.  The port receives the JAX
updaters' own draws (their key splits repeated here) through ``noise=``.
The CUDA kernels run only on the card; ``chip_smoke.py`` holds each
against these plain versions there.

The model has one unit placed on a knot, so its conditional variance sits
at the grids' floor (idD = 1e3), and its chains' factors sit at alpha
indices 0 (W = I, the knot algebra switched off), mid-grid and the last.
Where a result is a difference of terms (H = F - M' iA M, the quadratic
t1 - Et' iF Et and its ones-forms, which cancel far) it is held against
the sum of its terms' magnitudes instead of its own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import hmsc_tpu
from hmsc_tpu.mcmc import spatial as JS
from hmsc_tpu.mcmc import sweep as jsweep
from hmsc_tpu.mcmc import updaters as JU
from hmsc_tpu.precompute import compute_data_parameters as j_cdp
from hmsc_tpu.precompute import construct_knots as j_knots

import hmsc_tpu_torch as ht
from hmsc_tpu_torch.mcmc import spatial as TS
from hmsc_tpu_torch.mcmc import structs as tstructs
from hmsc_tpu_torch.mcmc import sweep as tsweep
from hmsc_tpu_torch.mcmc import updaters as TU
from hmsc_tpu_torch.ops import spatial as tops
from hmsc_tpu_torch.precompute import _GP_DD_FLOOR
from hmsc_tpu_torch.precompute import _gpp_grids as t_gpp_grids
from hmsc_tpu_torch.precompute import compute_data_parameters as t_cdp

from test_torch_model import flatten, flatten_states, jax_triple, to_torch
from test_torch_sampler import _assert_parity, _omega, _z_scores
from test_torch_spatial import alpha_noise, spatial_sweep_noise
from test_torch_updaters import _stack, location_noise, scale_noise

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

# float32 sums taken in another order by XLA and by PyTorch, compounded over
# a factorisation or a few blocks (as tests/test_torch_updaters.py)
RTOL, ATOL = 1e-4, 1e-5
# one reduction or product, only its order of summation differs: against
# the sum of the terms' magnitudes
OP_TOL = 1e-5
# the updaters on a GPP level in float64 (see _compare64)
RTOL64, ATOL64 = 1e-6, 1e-8
SEEDS = (3, 4)                        # two chains, distinct initial states
NP, NS, NF = 24, 5, 2
# each chain's factors' grid points: alpha 0 (W = I), mid-grid, the last
ALPHA = ((0, 50), (12, 100))


def _inputs(seed=5):
    """Coordinates, a 3 x 3 knot grid (the JAX package's construct_knots),
    two rows per unit, design [1, x] and a normal response; unit 0 is moved
    onto the centre knot."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(size=(NP, 2))
    knots = j_knots(xy, n_knots=3)
    xy[0] = knots[4]
    units = [f"u{i:02d}" for i in range(NP)]
    rows = np.repeat(np.arange(NP), 2)
    X = np.column_stack([np.ones(2 * NP), rng.standard_normal(2 * NP)])
    L = X @ rng.standard_normal((2, NS)) \
        + rng.standard_normal((NP, NF))[rows] @ rng.standard_normal((NF, NS))
    Y = L + rng.standard_normal((2 * NP, NS))
    return xy, knots, units, np.array(units)[rows], X, Y


def _models(distr="normal"):
    """The same GPP model built by both packages: (jax_model, port_model)."""
    xy, knots, units, labels, X, Y = _inputs()
    if distr == "probit":
        Y = (Y > 0).astype(float)
    out = []
    for pkg in (hmsc_tpu, ht):
        rl = pkg.HmscRandomLevel(s_data=pd.DataFrame(xy, index=units),
                                 s_method="GPP", s_knot=knots)
        pkg.set_priors_random_level(rl, nf_max=NF, nf_min=NF)
        out.append(pkg.Hmsc(Y=Y, X=X, distr=distr,
                            study_design=labels[:, None],
                            ran_levels={"lvl": rl}, x_scale=False))
    return tuple(out)


@pytest.fixture(scope="module")
def b():
    mj, mt = _models()
    spec_j, data_j, states_j = jax_triple(mj, seeds=SEEDS)
    states_j = [s.replace(it=jnp.asarray(4, jnp.int32), levels=(
        s.levels[0].replace(alpha_idx=jnp.asarray(a, jnp.int32)),))
        for s, a in zip(states_j, ALPHA)]
    data_t, state_t = to_torch(spec_j, data_j, states_j)
    keys = [jax.random.key(300 + c) for c in range(len(SEEDS))]
    return dict(mj=mj, mt=mt, spec_j=spec_j, data_j=data_j,
                states_j=states_j, spec_t=tstructs.build_spec(mt),
                data_t=data_t, state_t=state_t, keys=keys)


def _t(a):
    return torch.tensor(np.asarray(a))


def _residual(spec, data, state):
    U = TU if isinstance(state, tstructs.GibbsState) else JU
    return state.Z - U.linear_fixed(spec, data, state.Beta)


def gpp_eta_noise(spec, key):
    """``_eta_gpp``'s draws (``spatial.py:380-385``)."""
    ls = spec.levels[0]
    k1, k2 = jax.random.split(key)
    return {"eps1": jax.random.normal(k1, (ls.n_units, ls.nf_max)),
            "eps2": jax.random.normal(k2, (ls.nf_max * ls.n_knots,))}


def _jax_blocks(lvd, alpha):
    """``_eta_gpp``'s inputs to ``gpp_factor`` at one chain's alpha, with
    its alpha-0 overrides (``spatial.py:370-377``)."""
    a = jnp.asarray(alpha)
    alpha0 = lvd.alphapw[a, 0] == 0
    idD = jnp.where(alpha0[:, None], 1.0, lvd.idDg[a])
    M1 = jnp.where(alpha0[:, None, None], 0.0, lvd.idDW12g[a])
    return idD, M1, lvd.Fg[a]


def _to64(x):
    """Noise structures (dicts / lists of tensors) in float64."""
    if isinstance(x, dict):
        return {k: _to64(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to64(v) for v in x]
    return x.double() if x is not None and x.is_floating_point() else x


def _exact(b):
    """The model data and chain states in float64: the port's algorithm run
    in float64 on the same float32 inputs is the exact reference of both
    packages' float32 results."""
    return (tstructs.data_from_numpy(flatten(b["data_j"]), "cpu",
                                     torch.float64),
            tstructs.state_from_numpy(flatten_states(b["states_j"]), "cpu",
                                      torch.float64))


def _jax64(tree):
    """A JAX structure with its floating leaves in float64 (for use under
    ``jax.enable_x64``)."""
    return jax.tree.map(lambda a: a.astype(jnp.float64)
                        if hasattr(a, "dtype")
                        and jnp.issubdtype(a.dtype, jnp.floating) else a,
                        tree)


def _compare64(port, jax_states, fields=None):
    """The port's float64 state against the per-chain JAX states run in
    float64 from the same inputs and draws (rtol 1e-6 / atol 1e-8: the
    location move's ``1' iW 1`` is ~1e-7 of the sum of its terms'
    magnitudes here, so float64 rounding reaches ~1e-9 of it, compounded
    over a few blocks)."""
    ref = {}
    for st in jax_states:
        for k, v in flatten(st).items():
            ref.setdefault(k, []).append(v)
    for k, vals in ref.items():
        if k in ("BetaSel", "wRRR", "PsiRRR", "DeltaRRR"):
            continue
        if fields is not None and k.rpartition(".")[2] not in fields:
            continue
        head, _, field = k.rpartition(".")
        obj = port.levels[int(head.split(".")[1])] if head else port
        np.testing.assert_allclose(getattr(obj, field).numpy(),
                                   np.stack(vals), rtol=RTOL64, atol=ATOL64,
                                   err_msg=k)


def _compare_exact(port, jax_states, exact, fields=None):
    """Every (or the named) field of the port's float32 state and of the
    per-chain JAX states against the float64 run from the same inputs and
    draws.  The GPP Woodbury amplifies float32 rounding by up to cond(F) ~
    3e4 here (the unit on a knot), so the two float32 results are not held
    to each other but each to its distance from the exact one: the larger
    of the two packages' errors may be at most 4 times the smaller, plus
    rtol 1e-4 / atol 1e-5 of the field."""
    ref = {}
    for s in jax_states:
        for k, v in flatten(s).items():
            ref.setdefault(k, []).append(v)
    for k, vals in ref.items():
        if k in ("BetaSel", "wRRR", "PsiRRR", "DeltaRRR"):
            continue
        if fields is not None and k.rpartition(".")[2] not in fields:
            continue
        head, _, field = k.rpartition(".")

        def get(st):
            obj = st.levels[int(head.split(".")[1])] if head else st
            return getattr(obj, field).double().numpy()

        x64 = get(exact)
        e_t = np.abs(get(port) - x64).max()
        e_j = np.abs(np.stack(vals).astype(np.float64) - x64).max()
        assert max(e_t, e_j) <= 4 * min(e_t, e_j) + ATOL + RTOL * np.abs(
            x64).max(), (k, e_t, e_j)


def _lisl(seed=0):
    g = np.random.default_rng(seed)
    M = g.standard_normal((len(SEEDS), NP, NF, NF))
    return (M @ M.transpose(0, 1, 3, 2) * 20.0).astype(np.float32)


# --- host layer -------------------------------------------------------------

def test_knots_grids_and_level_data_match_jax(b):
    """construct_knots and the GPP grids equal the JAX package's (float64:
    1e-12); the unit on a knot sits at the variance floor; the spec and the
    model data equal the JAX package's (float32)."""
    xy = _inputs()[0]
    for kw in ({"n_knots": 3}, {"n_knots": 4}, {"knot_dist": 0.3},
               {"knot_dist": 0.25, "min_knot_dist": 0.1}):
        np.testing.assert_array_equal(ht.construct_knots(xy, **kw),
                                      j_knots(xy, **kw), err_msg=str(kw))
    assert ht.constructKnots is ht.construct_knots
    dp = t_cdp(b["mt"])
    gj, gt = j_cdp(b["mj"]).rL_par[0], dp.rL_par[0]
    alphas = b["mt"].ranLevels[0].alphapw[:, 0]
    for k in ("idDg", "idDW12g", "Fg", "iFg", "detDg"):
        np.testing.assert_allclose(getattr(gt, k), getattr(gj, k),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
    assert alphas[0] == 0 and (gt.idDg[0] == 1).all()
    np.testing.assert_array_equal(gt.idDg[1:, 0], 1.0 / _GP_DD_FLOOR)
    assert dataclasses.asdict(b["spec_t"]) == dataclasses.asdict(b["spec_j"])
    data_t = tstructs.build_model_data(b["mt"], dp, b["spec_t"], "cpu")
    flat = flatten(b["data_j"])
    for k in ("alphapw", "idDg", "idDW12g", "Fg", "iFg", "detDg"):
        # iFg, Fg and idDW12g are held in float64 (the JAX package's are
        # float32)
        np.testing.assert_array_equal(
            getattr(data_t.levels[0], k).numpy().astype(np.float32),
            flat[f"levels.0.{k}"], err_msg=k)
    for k in ("iFg", "Fg", "idDW12g"):
        assert getattr(data_t.levels[0], k).dtype == torch.float64, k


# --- B8d-1, B8d-2, B8d-3: the plain versions --------------------------------

def test_b8d1_b8d2_plain_match_gpp_factor(b):
    """The per-unit blocks iA and LiA (B8d-1) against the JAX gpp_factor's
    (rtol 1e-4 / atol 1e-5 of each block's largest entry: two float32
    factorisations and solves of an nf x nf block); the knot correction H
    (B8d-2), given the JAX iA, against the JAX einsum to 1e-5 of the sum of
    its terms' magnitudes (the port sums in float64 and returns H in
    float64); alpha 0 leaves F's block (the identity) alone."""
    lvd_j, lvd = b["data_j"].levels[0], b["data_t"].levels[0]
    LiSL = _lisl()
    alpha = _t(np.asarray(ALPHA, np.int32))
    iA, LiA = tops.gpp_unit(lvd, alpha, _t(LiSL))
    nK = lvd.idDW12g.shape[2]
    for c in range(len(SEEDS)):
        idD, M1, Fm = _jax_blocks(lvd_j, ALPHA[c])
        _, iAj, LiAj, _, _ = JS.gpp_factor(jnp.asarray(LiSL[c]), idD, M1, Fm)
        for got, want in ((iA[c], iAj), (LiA[c], LiAj)):
            want = np.asarray(want)
            scale = np.abs(want).max(axis=(1, 2), keepdims=True)
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=0)
            assert (np.abs(got.numpy() - want) <= ATOL * scale).all()
        # B8d-2 on the JAX iA: only the order of the unit sum differs
        H = tops.gpp_knot(lvd, alpha[c:c + 1], _t(iAj)[None])[0]
        assert H.dtype == torch.float64
        H = H.numpy()
        Hj = -np.asarray(jnp.einsum("hum,uhg,gun->hmgn", M1, iAj, M1))
        mag = np.einsum("hum,uhg,gun->hmgn", np.abs(M1), np.abs(iAj),
                        np.abs(M1))
        for f in range(NF):
            Hj[f, :, f, :] += np.asarray(Fm[f])
            mag[f, :, f, :] += np.abs(np.asarray(Fm[f]))
        Hj, mag = Hj.reshape(NF * nK, -1), mag.reshape(NF * nK, -1)
        assert (np.abs(H - Hj) <= OP_TOL * mag).all()
        if ALPHA[c][0] == 0:
            np.testing.assert_array_equal(H[:nK, :nK], np.eye(nK))
            assert not H[:nK, nK:].any() and not H[nK:, :nK].any()


@pytest.mark.parametrize("shape", [(4, 1000, 2, 100), (2, 300, 3, 9),
                                   (1, 40, 2, 9), (4, 5000, 4, 150),
                                   (2, 0, 2, 9)])
def test_b8d2_unit_splits_depend_on_the_shape_only(shape):
    """The unit range is cut into S consecutive ranges of ``chunk`` units,
    a multiple of the 16-unit stage, none empty, at least 64 units each
    where there are 64, the same on every call; at config 3c's shape the
    launch has one block for each of an H100's 132 SMs."""
    C, npr, nf, nK = shape
    S, chunk = tops._knot_splits(C, npr, nf, nK)
    assert (S, chunk) == tops._knot_splits(C, npr, nf, nK)
    assert S >= 1 and chunk % 16 == 0 and chunk >= min(64, max(npr, 1))
    assert S * chunk >= npr and (S - 1) * chunk < max(npr, 1)
    if shape == (4, 1000, 2, 100):
        assert C * 3 * S == 132


def _gpp_knot_as_kernel(lvd, alpha_idx, iA):
    """csrc/gpp_knot.cu's summation in plain PyTorch (float64): for each
    factor pair h >= g, the unit ranges of ``_knot_splits`` summed
    separately and added in split order, negated, F added on a diagonal
    pair at the lower position, and each lower entry (m >= n on a diagonal
    pair) written to both of its places."""
    C, npr, nf, _ = iA.shape
    M1 = tops.gpp_m1_at(lvd, alpha_idx).double()         # (C, nf, np, nK)
    nK = M1.shape[3]
    S, chunk = tops._knot_splits(C, npr, nf, nK)
    iA = iA.double()
    H = torch.empty((C, nf * nK, nf * nK), dtype=torch.float64)
    low = torch.tril(torch.ones((nK, nK), dtype=torch.bool))
    for h in range(nf):
        for g in range(h + 1):
            total = torch.zeros((C, nK, nK), dtype=torch.float64)
            for sp in range(S):
                u = slice(sp * chunk, min(npr, (sp + 1) * chunk))
                total = total + torch.einsum(
                    "cum,cu,cun->cmn", M1[:, h, u], iA[:, u, h, g],
                    M1[:, g, u])
            blk = -total
            if h == g:
                F = lvd.Fg[alpha_idx[:, h].long()].double()
                blk = torch.where(low, blk + F, (blk + F).transpose(1, 2))
                blk = torch.where(low, blk, blk.transpose(1, 2))
            H[:, h * nK:(h + 1) * nK, g * nK:(g + 1) * nK] = blk
            H[:, g * nK:(g + 1) * nK, h * nK:(h + 1) * nK] = \
                blk.transpose(1, 2)
    return H


def test_b8d2_kernel_summation_order_matches_plain():
    """The kernel's order of summation (the lower triangle by factor pair,
    unit ranges in split order, mirrored) gives the plain version's H to
    1e-12 of each chain's max|H| in float64, and an exactly symmetric H,
    on 300 units in 4 ranges (the last ragged), 9 knots, 3 factors at
    alpha indices 0, 50 and 100.  The kernel reads iA[u, h, g] for h >= g
    only, so iA is made exactly symmetric, as B8d-1's kernel writes it
    (the plain B8d-1's triangular solves leave ~1e-7 of asymmetry)."""
    rng = np.random.default_rng(11)
    xy = rng.uniform(size=(300, 2)) * 10
    alphas = float(np.sqrt(200.0)) * np.arange(101) / 100
    lp = t_gpp_grids(xy, ht.construct_knots(xy, n_knots=3), alphas)
    lvd = tstructs.LevelData(
        pi_row=None, unit_count=None, x_row=None, x_unit=None, nu=None,
        a1=None, b1=None, a2=None, b2=None,
        alphapw=_t(np.column_stack([alphas, np.full(101, 1 / 101)])).float(),
        **{k: tstructs._tensor(k, getattr(lp, k), "cpu", torch.float32)
           for k in ("idDg", "idDW12g", "Fg", "iFg", "detDg")})
    alpha = torch.tensor([[0, 50, 100], [100, 0, 50]], dtype=torch.int32)
    M = rng.standard_normal((2, 300, 3, 3))
    LiSL = _t((M @ M.transpose(0, 1, 3, 2) * 20.0).astype(np.float32))
    iA, _ = tops.gpp_unit(lvd, alpha, LiSL)
    iA = (iA + iA.transpose(2, 3)) / 2      # exactly symmetric, as B8d-1's
    S, chunk = tops._knot_splits(2, 300, 3, 9)
    assert S == 4 and 300 % chunk != 0
    H = _gpp_knot_as_kernel(lvd, alpha, iA)
    Hp = tops._gpp_knot_plain(lvd, alpha, iA)
    scale = Hp.abs().amax(dim=(1, 2), keepdim=True)
    assert ((H - Hp).abs() / scale).max() <= 1e-12
    assert torch.equal(H, H.transpose(1, 2))


def test_b8d1_plain_indefinite_block_is_nan(b):
    """A unit whose block is not positive definite comes out NaN in full,
    in iA and LiA (divergence containment); the others are finite."""
    lvd = b["data_t"].levels[0]
    LiSL = _lisl(1)
    LiSL[1, 3] -= 1e4 * np.eye(NF, dtype=np.float32)
    iA, LiA = tops.gpp_unit(lvd, _t(np.asarray(ALPHA, np.int32)), _t(LiSL))
    bad = torch.zeros((len(SEEDS), NP), dtype=torch.bool)
    bad[1, 3] = True
    for t in (iA, LiA):
        assert torch.isnan(t[bad]).all() and torch.isfinite(t[~bad]).all()


def _quad_terms(lvd_j, eta, g):
    """The sums of the magnitudes of the terms of the GPP forms at grid
    point g for (np, nf) eta, in float64: of ``eta' iW eta``, ``1' iW 1``
    and ``1' iW eta``, each ``sum_u |idD x y| + |x' W12| |iF| |W12' y|``
    with the knot sums taken over magnitudes too (iF has entries of both
    signs far larger than its quadratic forms: cond(F) reaches 3e4
    here)."""
    idD = np.asarray(lvd_j.idDg[g], np.float64)
    W12 = np.abs(np.asarray(lvd_j.idDW12g[g], np.float64))
    iF = np.abs(np.asarray(lvd_j.iFg[g], np.float64))
    e = np.abs(eta.astype(np.float64))
    Ee, E1 = e.T @ W12, W12.sum(axis=0)
    return (idD @ e ** 2 + np.einsum("hm,mn,hn->h", Ee, iF, Ee),
            idD.sum() + E1 @ iF @ E1,
            idD @ e + np.einsum("m,mn,hn->h", E1, iF, Ee))


def test_b8d3_plain_matches_jax_quadratics(b):
    """The grid quadratics against eta_quad_grid and the at-alpha forms
    against eta_quad_at / eta_ones_forms_at, per chain, each to 1e-5 of the
    sum of its terms' magnitudes (v = t1 - Et' iF Et cancels, and iF's
    entries are far larger than its forms); at alpha 0 (eta' eta, np,
    1' eta) within the same bound."""
    spec_j, lvd_j, lvd = b["spec_j"], b["data_j"].levels[0], \
        b["data_t"].levels[0]
    ls = spec_j.levels[0]
    eta = np.random.default_rng(7).standard_normal(
        (len(SEEDS), NP, NF)).astype(np.float32)
    grid = tops.gpp_quad_grid(lvd, _t(eta)).numpy()
    at = tops.gpp_quad_at(lvd, _t(np.asarray(ALPHA, np.int32)),
                          _t(eta)).numpy()
    assert grid.shape == (2, NF, ls.n_alpha) and at.shape == (2, NF, 3)
    for c in range(len(SEEDS)):
        v, ld = JS.eta_quad_grid(lvd_j, ls, jnp.asarray(eta[c]))
        np.testing.assert_array_equal(
            TS.eta_quad_grid(lvd, b["spec_t"].levels[0], _t(eta))[1].numpy(),
            np.asarray(ld)[0])
        for g in range(ls.n_alpha):
            mag = (eta[c].astype(np.float64) ** 2).sum(axis=0) if g == 0 \
                else _quad_terms(lvd_j, eta[c], g)[0]
            assert (np.abs(grid[c, :, g] - np.asarray(v)[:, g])
                    <= OP_TOL * mag).all(), g
        a = jnp.asarray(ALPHA[c])
        q = JS.eta_quad_at(lvd_j, ls, jnp.asarray(eta[c]), a)
        q1, s = JS.eta_ones_forms_at(lvd_j, ls, jnp.asarray(eta[c]), a)
        for f in range(NF):
            g = ALPHA[c][f]
            e = np.abs(eta[c, :, f].astype(np.float64))
            mq, m1, ms = ((e ** 2).sum(), NP, e.sum()) if g == 0 else (
                m[f] if np.ndim(m) else m
                for m in _quad_terms(lvd_j, eta[c], g))
            for i, (want, scale) in enumerate(((q, mq), (q1, m1), (s, ms))):
                assert abs(at[c, f, i] - float(want[f])) \
                    <= OP_TOL * scale, (c, f, i)


@pytest.mark.parametrize("shape", [(101, 4, 1000, 2, 100), (101, 2, 60, 3, 9),
                                   (101, 4, 5000, 4, 150), (11, 1, 7, 1, 9),
                                   (101, 2, 0, 2, 9), (101, 8, 300, 2, 300)])
def test_b8d3_unit_splits_depend_on_the_shape_only(shape):
    """B8d-3's first pass cuts each slice's units into U consecutive ranges
    of ``chunk`` units, none empty, at most 256 a range and at least 16
    where there are 16, the same on every call; at config 3c's shape the
    grid mode has ~4 blocks for each of an H100's 132 SMs and the at-alpha
    mode at least one."""
    G, C, npr, nf, nK = shape
    for items, target in ((tops._quad_items(G, C * nf, nK),
                           tops._QUAD_GRID_BLOCKS),
                          (tops._quad_items(None, C * nf, nK),
                           tops._QUAD_AT_BLOCKS)):
        U, chunk = tops._quad_splits(items, npr, target)
        assert (U, chunk) == tops._quad_splits(items, npr, target)
        n = max(npr, 1)
        assert U >= 1 and 1 <= chunk <= 256 and chunk >= min(16, n)
        assert U * chunk >= n and (U - 1) * chunk < n
        assert items * U <= max(target, items * -(-n // 256))
        if shape == (101, 4, 1000, 2, 100):
            assert items * U >= (3.5 * 132 if target == 528 else 132)


def _gpp_quad_as_kernel(lvd, alpha_idx, eta):
    """csrc/gpp_quad.cu's summation in plain PyTorch (float64): the knot
    sums and unit sums over each range of ``_quad_splits`` summed
    separately and added in range order, then z = iF' E and E . z; the
    grid mode's (C, nf, G) and the at-alpha mode's (C, nf, 3)."""
    C, npr, nf = eta.shape
    G, _, nK = lvd.idDW12g.shape
    e = eta.double().permute(0, 2, 1)                    # (C, nf, np)
    W, idD, iF = lvd.idDW12g.double(), lvd.idDg.double(), lvd.iFg.double()

    def ranged(U, chunk, fn):
        total = 0.0
        for us in range(U):
            total = total + fn(slice(us * chunk, min(npr, (us + 1) * chunk)))
        return total

    U, chunk = tops._quad_splits(tops._quad_items(G, C * nf, nK), npr,
                                 tops._QUAD_GRID_BLOCKS)
    Et = ranged(U, chunk, lambda u: torch.einsum("chu,gum->chgm", e[..., u],
                                                 W[:, u]))
    t1 = ranged(U, chunk, lambda u: torch.einsum("gu,chu->chg", idD[:, u],
                                                 e[..., u] ** 2))
    z = torch.einsum("chgm,gmk->chgk", Et, iF)
    grid = torch.where(lvd.alphapw[:, 0] == 0, (e * e).sum(-1)[..., None],
                       t1 - (z * Et).sum(-1))
    a = alpha_idx.long()
    U, chunk = tops._quad_splits(tops._quad_items(None, C * nf, nK), npr,
                                 tops._QUAD_AT_BLOCKS)
    Wa, da, iFa = W[a], idD[a], iF[a]                    # (C, nf, ...)
    E1 = ranged(U, chunk, lambda u: Wa[:, :, u].sum(2))
    Ee = ranged(U, chunk, lambda u: torch.einsum("chu,chum->chm", e[..., u],
                                                 Wa[:, :, u]))
    t1, td, te = (ranged(U, chunk, lambda u, f=f: (da[..., u] * f(e[..., u])
                                                   ).sum(-1))
                  for f in (lambda x: x * x, torch.ones_like, lambda x: x))
    z1 = torch.einsum("chm,chmk->chk", E1, iFa)
    ze = torch.einsum("chm,chmk->chk", Ee, iFa)
    at = torch.stack([t1 - (ze * Ee).sum(-1), td - (z1 * E1).sum(-1),
                      te - (z1 * Ee).sum(-1)], dim=2)
    zero = tops.gpp_alpha_zero(lvd, alpha_idx)[..., None]
    at = torch.where(zero, torch.stack([(e * e).sum(-1), torch.full_like(
        t1, float(npr)), e.sum(-1)], dim=2), at)
    return grid, at


def test_b8d3_kernel_summation_order_matches_plain():
    """The kernel's order of summation (unit ranges summed separately and
    added in order, then iF' E and its dot with E) gives the plain
    version's grid and at-alpha quadratics to 1e-12 of the sum of their
    terms' magnitudes in float64, on 300 units in 5 grid-mode ranges and
    18 at-alpha ranges (the last ragged), 9 knots, 3 factors at alpha
    indices 0, 50 and 100."""
    rng = np.random.default_rng(12)
    xy = rng.uniform(size=(300, 2)) * 10
    alphas = float(np.sqrt(200.0)) * np.arange(101) / 100
    lp = t_gpp_grids(xy, ht.construct_knots(xy, n_knots=3), alphas)
    lvd = tstructs.LevelData(
        pi_row=None, unit_count=None, x_row=None, x_unit=None, nu=None,
        a1=None, b1=None, a2=None, b2=None,
        alphapw=_t(np.column_stack([alphas, np.full(101, 1 / 101)])).float(),
        **{k: tstructs._tensor(k, getattr(lp, k), "cpu", torch.float32)
           for k in ("idDg", "idDW12g", "Fg", "iFg", "detDg")})
    alpha = torch.tensor([[0, 50, 100], [100, 0, 50]], dtype=torch.int32)
    eta = _t(rng.standard_normal((2, 300, 3)).astype(np.float32))
    assert tops._quad_splits(tops._quad_items(101, 6, 9), 300,
                            tops._QUAD_GRID_BLOCKS) \
        == (5, 60)
    assert tops._quad_splits(tops._quad_items(None, 6, 9), 300,
                            tops._QUAD_AT_BLOCKS) \
        == (18, 17)
    grid, at = _gpp_quad_as_kernel(lvd, alpha, eta)
    e64 = eta.double()
    vp = tops._gpp_quad_grid_plain(lvd, e64)
    ap = tops._gpp_quad_at_plain(lvd, alpha, e64)
    ea = e64.abs()
    W, iFa = lvd.idDW12g.double(), lvd.iFg.double().abs()
    Ee = torch.einsum("cuh,gum->chgm", ea, W.abs())
    mg = (torch.einsum("gu,cuh->chg", lvd.idDg.double(), ea ** 2)
          + torch.einsum("chgm,gmn,chgn->chg", Ee, iFa, Ee))
    assert ((grid - vp).abs() <= 1e-12 * mg).all()
    a = alpha.long()
    Ea = torch.einsum("cuh,chum->chm", ea, W.abs()[a])
    E1 = W.abs()[a].sum(2)
    idDa = lvd.idDg.double()[a]
    mags = torch.stack([
        torch.einsum("chu,cuh->ch", idDa, ea ** 2)
        + torch.einsum("chm,chmn,chn->ch", Ea, iFa[a], Ea),
        idDa.sum(2) + torch.einsum("chm,chmn,chn->ch", E1, iFa[a], E1),
        torch.einsum("chu,cuh->ch", idDa, ea)
        + torch.einsum("chm,chmn,chn->ch", E1, iFa[a], Ea)], dim=2)
    assert ((at - ap).abs() <= 1e-12 * mags).all()


def _large_alpha_level():
    """40 units on a 10 x 10 square with a 3 x 3 knot grid 0.2 apart at its
    centre (cond(F) reaches 2.5e5 at large alpha): the generator after the
    coordinates' draws, the coordinates, the host grids and alphapw."""
    rng = np.random.default_rng(4)
    xy = rng.uniform(size=(40, 2)) * 10
    diag = float(np.sqrt(((xy.max(0) - xy.min(0)) ** 2).sum()))
    alphas = diag * np.arange(101) / 100
    knots = ht.construct_knots(np.array([[4.8, 4.8], [5.2, 5.2]]), n_knots=3)
    alphapw = np.column_stack([alphas, np.full(101, 1 / 101)])
    return rng, xy, t_gpp_grids(xy, knots, alphas), alphapw


def test_gpp_quadratic_is_accurate_at_large_alpha():
    """The GPP prior quadratic eta' iW eta = t1 - Et' F^-1 Et at large alpha,
    where cond(F) reaches 2.5e5 (40 units on a 10 x 10 square, a 3 x 3 knot
    grid 0.2 apart at its centre, Eta smooth at range 4): the port's (iFg in
    float64, the sums in double; kernel B8d-3 computes the same way) is
    within 1e-4 of the float64 value at every grid point; the JAX package's
    float32 form is off by more than 1% there (1.9% when this test was
    written; on config 3c's 1000 units and 100 knots it sent the alpha
    sampler to the grid's top: ROADMAP Queue C)."""
    from types import SimpleNamespace

    rng, xy, lp, alphapw = _large_alpha_level()
    d = np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1))
    eta = (np.linalg.cholesky(np.exp(-d / 4.0))
           @ rng.standard_normal((40, 2))).astype(np.float32)
    e64 = eta.astype(np.float64)
    Et = np.einsum("uh,gum->hgm", e64, lp.idDW12g)
    ref = (np.einsum("gu,uh->hg", lp.idDg, e64 ** 2)
           - np.einsum("hgm,gmn,hgn->hg", Et, lp.iFg, Et))[:, 1:]
    f32 = {k: getattr(lp, k).astype(np.float32)
           for k in ("idDg", "idDW12g", "iFg", "detDg")}
    lvd = tstructs.LevelData(
        pi_row=None, unit_count=None, x_row=None, x_unit=None, nu=None,
        a1=None, b1=None, a2=None, b2=None, alphapw=_t(alphapw).float(),
        idDg=_t(f32["idDg"]), idDW12g=_t(f32["idDW12g"]),
        iFg=_t(lp.iFg))                                  # float64, as loaded
    v = tops.gpp_quad_grid(lvd, _t(eta)[None]).numpy()[0, :, 1:]
    assert (np.abs(v - ref) <= 1e-4 * np.abs(ref)).all()
    lvj = SimpleNamespace(alphapw=jnp.asarray(alphapw, jnp.float32),
                          **{k: jnp.asarray(a) for k, a in f32.items()})
    vj = np.asarray(JS.eta_quad_grid(lvj, SimpleNamespace(spatial="GPP"),
                                     jnp.asarray(eta))[0])[:, 1:]
    assert (np.abs(vj - ref) / np.abs(ref)).max() > 1e-2


def test_gpp_ones_forms_are_accurate_at_large_alpha():
    """The location move's ones-forms (1' iW 1, 1' iW eta) of the
    large-alpha level at grid indices 14, 50 and 100, through
    ``eta_ones_forms_at`` on the level as the port loads it (idDW12g, Fg
    and iFg in float64): within 1e-6 of the float64 values from the
    float64 grids (1' iW 1 relative, 1' iW eta of the sum of its terms'
    magnitudes).  With idDW12g rounded to float32, 1' iW 1 is off by more
    than that at the last index (1.3e-5 when this test was written, 3.6e-7
    from the float64 grids; ROADMAP Queue C, C1)."""
    from types import SimpleNamespace

    rng, xy, lp, alphapw = _large_alpha_level()
    d = np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1))
    eta = (np.linalg.cholesky(np.exp(-d / 4.0))
           @ rng.standard_normal((40, 2))).astype(np.float32)
    e64 = eta.astype(np.float64)
    fields = ("idDg", "idDW12g", "Fg", "iFg", "detDg")
    lvd = SimpleNamespace(
        alphapw=_t(alphapw).float(),
        **{k: tstructs._tensor(k, getattr(lp, k), "cpu", torch.float32)
           for k in fields})
    lvd32 = SimpleNamespace(**vars(lvd))
    lvd32.idDW12g = lvd.idDW12g.float()
    gpp = SimpleNamespace(spatial="GPP")
    for g in (14, 50, 100):
        idD, W, iF = lp.idDg[g], lp.idDW12g[g], lp.iFg[g]
        E1, Ee = W.sum(axis=0), e64.T @ W
        q1 = idD.sum() - E1 @ iF @ E1
        s = idD @ e64 - np.einsum("m,mn,hn->h", E1, iF, Ee)
        s_mag = (idD @ np.abs(e64)
                 + np.einsum("m,mn,hn->h", np.abs(E1), np.abs(iF),
                             np.abs(Ee)))
        alpha = torch.full((1, 2), g, dtype=torch.int32)
        got1, gots = TS.eta_ones_forms_at(lvd, gpp, _t(eta)[None], alpha)
        assert (np.abs(got1.numpy()[0] - q1) <= 1e-6 * abs(q1)).all(), g
        assert (np.abs(gots.numpy()[0] - s) <= 1e-6 * s_mag).all(), g
        if g == 100:
            f32 = TS.eta_ones_forms_at(lvd32, gpp, _t(eta)[None], alpha)[0]
            assert (np.abs(f32.numpy()[0] - q1) > 1e-6 * abs(q1)).all()


def test_gpp_draw_is_accurate_at_large_alpha():
    """The GPP Eta draw at grid indices 50 and 100 of the large-alpha level:
    the port's float32 draw (H summed and factorised in float64, the
    knot-space solves in float64) is within 1e-5 of the largest |value| of
    the float64 draw from the same float32 inputs and normals; the JAX
    package's float32 draw (H and its Cholesky in float32) is off by more
    than that at the last index (2.5e-4, 9 times the bound, when this test
    was written, the port's 0.05 times it; ~8% of the draw's standard
    deviation on config 3c's 1000 units and 100 knots: ROADMAP Queue C)."""
    from types import SimpleNamespace

    _, _, lp, alphapw = _large_alpha_level()
    n, nK = lp.idDW12g.shape[1:]
    lvd = SimpleNamespace(alphapw=_t(alphapw).float(), idDg=_t(lp.idDg).float(),
                          idDW12g=_t(lp.idDW12g).float(),
                          Fg=_t(lp.Fg).float(), iFg=_t(lp.iFg))
    lvd64 = SimpleNamespace(**{k: v.double() for k, v in vars(lvd).items()})
    rng = np.random.default_rng(9)
    lam = rng.standard_normal((NF, 5))
    LiSL = np.broadcast_to(2 * lam @ lam.T, (1, n, NF, NF)).astype(np.float32)
    F = (3 * rng.standard_normal((1, n, NF))).astype(np.float32)
    e1 = rng.standard_normal((1, n, NF)).astype(np.float32)
    e2 = rng.standard_normal((1, NF * nK)).astype(np.float32)
    for g in (50, 100):
        alpha = torch.full((1, NF), g, dtype=torch.int32)
        got = TS.gpp_draw(TS.gpp_factor(lvd, alpha, _t(LiSL)), _t(F), _t(e1),
                          _t(e2))[0].double().numpy()
        iA, LiA = tops.gpp_unit(lvd64, alpha, _t(LiSL).double())
        pay = (tops.gpp_m1_at(lvd64, alpha), iA, LiA, TS.chol_spd(
            tops.gpp_knot(lvd64, alpha, iA)))
        ref = TS.gpp_draw(pay, *(_t(a).double() for a in (F, e1, e2)))[0]
        ref = ref.numpy()
        bar = 1e-5 * np.abs(ref).max()
        assert np.abs(got - ref).max() <= bar, g
        blocks = [jnp.repeat(jnp.asarray(a[g], jnp.float32)[None], NF, 0)
                  for a in (lp.idDg, lp.idDW12g, lp.Fg)]
        want = np.asarray(JS.gpp_draw(
            JS.gpp_factor(jnp.asarray(LiSL[0]), *blocks), jnp.asarray(F[0]),
            jnp.asarray(e1[0]), jnp.asarray(e2[0])))
        if g == 100:
            assert np.abs(want - ref).max() > bar


# --- the updaters -----------------------------------------------------------

def test_gpp_draw_matches_jax(b):
    """The port's gpp_draw on the JAX gpp_factor payload and the JAX draws
    (rtol 1e-4 / atol 1e-5: a float32 double Woodbury)."""
    lvd_j = b["data_j"].levels[0]
    LiSL = _lisl(2)
    F = np.random.default_rng(8).standard_normal(
        (len(SEEDS), NP, NF)).astype(np.float32)
    pays, want, noise = [], [], []
    for c, k in enumerate(b["keys"]):
        idD, M1, Fm = _jax_blocks(lvd_j, ALPHA[c])
        pay = JS.gpp_factor(jnp.asarray(LiSL[c]), idD, M1, Fm)
        nz = gpp_eta_noise(b["spec_j"], k)
        want.append(np.asarray(JS.gpp_draw(pay, jnp.asarray(F[c]),
                                           nz["eps1"], nz["eps2"])))
        pays.append(pay[:4])
        noise.append(nz)
    payload = [torch.stack([_t(p[i]) for p in pays]) for i in range(4)]
    nz = _stack(noise)
    got = TS.gpp_draw(payload, _t(F), nz["eps1"], nz["eps2"]).numpy()
    np.testing.assert_allclose(got, np.stack(want), rtol=RTOL, atol=ATOL)


def test_update_eta_spatial_gpp(b):
    """The whole GPP Eta draw with the JAX function's normals injected,
    both packages against the float64 draw (``_compare_exact``)."""
    spec_j, data_j, keys = b["spec_j"], b["data_j"], b["keys"]
    ref = []
    for s, k in zip(b["states_j"], keys):
        S = _residual(spec_j, data_j, s)
        ref.append(s.replace(levels=(JS.update_eta_spatial(
            spec_j, data_j, s, 0, k, S),)))
    noise = _stack([gpp_eta_noise(spec_j, k) for k in keys])
    st = b["state_t"]
    lv = TS.update_eta_spatial(b["spec_t"], b["data_t"], st, 0,
                               S=_residual(b["spec_t"], b["data_t"], st),
                               noise=noise)
    d64, s64 = _exact(b)
    lv64 = TS.update_eta_spatial(b["spec_t"], d64, s64, 0,
                                 S=_residual(b["spec_t"], d64, s64),
                                 noise=_to64(noise))
    _compare_exact(st.replace(levels=(lv,)), ref,
                   s64.replace(levels=(lv64,)), fields={"Eta"})


def test_update_alpha_gpp(b):
    """With the Gumbel draws injected, the same grid indices."""
    spec_j, data_j, keys = b["spec_j"], b["data_j"], b["keys"]
    ref = [np.asarray(JS.update_alpha(spec_j, data_j, s, 0, k).alpha_idx)
           for s, k in zip(b["states_j"], keys)]
    noise = _stack([alpha_noise(spec_j, k) for k in keys])
    lv = TS.update_alpha(b["spec_t"], b["data_t"], b["state_t"], 0,
                         noise=noise)
    np.testing.assert_array_equal(lv.alpha_idx.numpy(), np.stack(ref))


def test_interweaves_on_a_gpp_level(b):
    """Scale then location interweave with the JAX draws injected; their
    prior forms come from the GPP iW at each factor's alpha, alpha 0
    included.  The location move's ``1' iW 1 = sum idD - E1' iF E1``
    cancels so far here (cond(F) ~ 3e4) that either package's float32
    value is 10% off the exact one, so the two are compared in float64
    (``_compare64``)."""
    spec_j, keys = b["spec_j"], b["keys"]
    with jax.enable_x64(True):
        data_j = _jax64(b["data_j"])
        ref = [JU.interweave_location(
            spec_j, data_j, JU.interweave_scale(spec_j, data_j, _jax64(s),
                                                k), jax.random.fold_in(k, 9))
            for s, k in zip(b["states_j"], keys)]
        sc = _stack([scale_noise(spec_j, k) for k in keys])
        loc = _stack([location_noise(spec_j, jax.random.fold_in(k, 9))
                      for k in keys])
    spec = b["spec_t"]
    d64, s64 = _exact(b)
    out = TU.interweave_location(
        spec, d64, TU.interweave_scale(spec, d64, s64, noise=sc), noise=loc)
    _compare64(out, ref, fields={"Eta", "Lambda", "Beta"})
    assert not np.allclose(out.levels[0].Eta.numpy(),
                           s64.levels[0].Eta.numpy())


def test_full_sweep_gpp(b):
    """One whole sweep from an identical state with every JAX draw
    injected, the GPP Eta and Alpha blocks included, in float64
    (``_compare64``: the location interweave's forms cancel too far for a
    float32 comparison)."""
    spec_j, keys = b["spec_j"], b["keys"]
    adapt = (10,)
    with jax.enable_x64(True):
        data_j = _jax64(b["data_j"])
        states_j = [_jax64(s) for s in b["states_j"]]
        jsw = jsweep.make_sweep(spec_j, adapt_nf=adapt)
        ref = [jsw(data_j, s, k) for s, k in zip(states_j, keys)]
        per = []
        for s, k in zip(states_j, keys):
            nz = spatial_sweep_noise(spec_j, data_j, s, k, dense=True)
            nz["EtaSpatial"] = [gpp_eta_noise(
                spec_j, jax.random.fold_in(jax.random.split(k, 13)[4], 0))]
            per.append(nz)
        noise = {n: _stack([p[n] for p in per]) for n in per[0]}
    sweep = tsweep.make_sweep(b["spec_t"], adapt_nf=adapt)
    d64, s64 = _exact(b)
    _compare64(sweep(d64, s64, None, it=5, noise=noise), ref)


# --- end to end -------------------------------------------------------------

def test_gpp_posterior_moments_match_jax():
    """The port's sample_mcmc (CPU) against the JAX package's on the small
    GPP model: z-scores of the posterior means of Beta and Omega (the
    test_parity.py criterion); the JAX run is short (2 chains, 20 + 40
    sweeps), so its standard errors are wide."""
    mj, mt = _models()
    pj = hmsc_tpu.sample_mcmc(mj, samples=40, transient=20, n_chains=2,
                              seed=1)
    pt = ht.sample_mcmc(mt, samples=150, transient=50, n_chains=2, seed=2,
                        device="cpu")
    assert pt.chain_health["good_chains"].all()
    for k in pj.arrays:
        assert pt[k].shape[2:] == pj[k].shape[2:], k
        assert np.isfinite(pt[k]).all(), k
    assert pt["Alpha_0"].min() >= 0 and pt["Alpha_0"].max() < 101
    beta_t = pt["Beta"].reshape((-1,) + pt["Beta"].shape[2:])
    om_t = _omega(pt).reshape((-1, NS, NS))
    _assert_parity([_z_scores(pj["Beta"], beta_t),
                    _z_scores(_omega(pj), om_t)], "GPP")
