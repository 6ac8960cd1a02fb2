"""Spatial random levels (Full and NNGP) in the port against the JAX
package: the grids, the plain versions of kernels B8a-B8c, the Eta draws
(dense and matrix-free CG), the alpha sampler, both interweaving moves, one
whole sweep and a short end-to-end run.  The port receives the JAX
updaters' own draws (their key splits repeated here) through ``noise=``.
The CUDA kernels run only on the card; ``chip_smoke.py`` holds each
against these plain versions there."""

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

import hmsc_tpu_torch as ht
from hmsc_tpu_torch.mcmc import spatial as TS
from hmsc_tpu_torch.mcmc import structs as tstructs
from hmsc_tpu_torch.mcmc import sweep as tsweep
from hmsc_tpu_torch.mcmc import updaters as TU
from hmsc_tpu_torch.ops import spatial as tops
from hmsc_tpu_torch.precompute import compute_data_parameters as t_cdp

from test_torch_model import flatten, jax_triple, to_torch
from test_torch_sampler import _assert_parity, _omega, _z_scores
from test_torch_updaters import (_compare, _stack, beta_lambda_noise,
                                 gamma_v_noise, inv_sigma_noise,
                                 lambda_priors_noise, location_noise,
                                 nf_noise, scale_noise, z_noise)
from util import small_model

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

# float32 sums taken in another order by XLA and by PyTorch, compounded over
# a factorisation or a few blocks (as tests/test_torch_updaters.py)
RTOL, ATOL = 1e-4, 1e-5
# a single gather-and-sum operator: only its summation order differs
OP_RTOL = 1e-5
SEEDS = (3, 4)                        # two chains, distinct initial states
NY, NS, NP, K_NN = 60, 6, 30, 5
# each chain's factors' grid points: away from alpha = 0 (iW = I), and one
# factor of chain 0 at alpha = 0 so that case is covered too
ALPHA = ((0, 12), (25, 7))


def _t(a):
    return torch.tensor(np.asarray(a))


def _port_model(mj, method):
    """The JAX package's model rebuilt from the same inputs by the port."""
    rl = mj.ranLevels[0]
    names = sorted(rl._s_index, key=rl._s_index.get)
    kw = {"n_neighbours": rl.n_neighbours} if method == "NNGP" else {}
    rt = ht.HmscRandomLevel(s_data=pd.DataFrame(rl.s, index=names),
                            s_method=method, **kw)
    ht.set_priors_random_level(rt, nf_max=2, nf_min=2)
    return ht.Hmsc(Y=mj.Y, X=mj.X, distr="normal",
                   study_design=mj.study_design, ran_levels={"lvl": rt})


def _setup(method):
    mj = small_model(ny=NY, ns=NS, n_units=NP, spatial=method, nf=2, seed=5,
                     n_neighbours=K_NN)
    mt = _port_model(mj, method)
    spec_j, data_j, states_j = jax_triple(mj, seeds=SEEDS)
    states_j = [s.replace(it=jnp.asarray(4, jnp.int32), levels=(
        s.levels[0].replace(alpha_idx=jnp.asarray(a, jnp.int32)),))
        for s, a in zip(states_j, ALPHA)]
    data_t, state_t = to_torch(spec_j, data_j, states_j)
    keys = [jax.random.key(200 + c) for c in range(len(SEEDS))]
    return dict(mj=mj, mt=mt, spec_j=spec_j, data_j=data_j,
                states_j=states_j, spec_t=tstructs.build_spec(mt),
                data_t=data_t, state_t=state_t, keys=keys)


@pytest.fixture(scope="module")
def built():
    return {m: _setup(m) for m in ("Full", "NNGP")}


@pytest.fixture
def cg_path(monkeypatch):
    """Send the NNGP Eta draw of both packages down the CG path."""
    monkeypatch.setattr(JS, "_NNGP_DENSE_MAX", 0)
    monkeypatch.setattr(TS, "_NNGP_DENSE_MAX", 0)


def _residual(spec, data, state):
    """S = Z - X Beta, the Eta update's residual on a one-level model, for
    a JAX or a port state."""
    U = TU if isinstance(state, tstructs.GibbsState) else JU
    return state.Z - U.linear_fixed(spec, data, state.Beta)


# --- the JAX updaters' draws, by repeating their key splits ---------------

def eta_spatial_noise(spec, key, dense=True):
    ls = spec.levels[0]
    if dense:       # spatial.py:283
        return {"eps": jax.random.normal(key, (ls.nf_max * ls.n_units,))}
    k1, k2 = jax.random.split(key)                       # spatial.py:320-332
    return {"eps1": jax.random.normal(k1, (ls.n_units, ls.nf_max)),
            "xi": jax.random.normal(k2, (spec.ny, spec.ns))}


def alpha_noise(spec, key):
    """jax.random.categorical's Gumbel draws (argmax of logits + gumbel)."""
    ls = spec.levels[0]
    return {"gumbel": jax.random.gumbel(key, (ls.nf_max, ls.n_alpha))}


def spatial_sweep_noise(spec, data, state, key, dense):
    """Every draw of one JAX sweep of a one-level spatial model
    (``sweep.py:76-345``), by block."""
    ks = jax.random.split(key, 13)
    kI1, kI2 = jax.random.split(ks[12])
    return {
        "BetaLambda": beta_lambda_noise(spec, ks[0]),
        "GammaV": gamma_v_noise(spec, ks[1]),
        "LambdaPriors": lambda_priors_noise(spec, data, state, ks[3]),
        "EtaSpatial": [eta_spatial_noise(spec, jax.random.fold_in(ks[4], 0),
                                         dense)],
        "Alpha": [alpha_noise(spec, jax.random.fold_in(ks[5], 0))],
        "Interweave": {"scale": scale_noise(spec, kI1),
                       "location": location_noise(spec, kI2)},
        "InvSigma": inv_sigma_noise(spec, data, ks[6]),
        "Z": z_noise(spec, ks[7]),
        "Nf": [nf_noise(spec, data, jax.random.fold_in(ks[5], 1000), 0)],
    }


# --- host layer -------------------------------------------------------------

@pytest.mark.parametrize("method", ["Full", "NNGP"])
def test_grids_and_level_data_match_jax(built, method):
    """The port's copy of compute_data_parameters gives the JAX package's
    grids (both are float64 numpy: 1e-12), its spec equals the JAX spec,
    and its model data equals the flattened JAX ModelData (float32)."""
    b = built[method]
    gj, gt = j_cdp(b["mj"]).rL_par[0], t_cdp(b["mt"]).rL_par[0]
    keys = (("iWg", "detWg") if method == "Full"
            else ("nn_idx", "nn_coef", "nn_D", "detWg"))
    for k in keys:
        np.testing.assert_allclose(getattr(gt, k), getattr(gj, k),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
    assert dataclasses.asdict(b["spec_t"]) == dataclasses.asdict(b["spec_j"])
    data_t = tstructs.build_model_data(b["mt"], t_cdp(b["mt"]), b["spec_t"],
                                       "cpu")
    flat = flatten(b["data_j"])
    lv = data_t.levels[0]
    for k in ("alphapw",) + keys:
        np.testing.assert_array_equal(getattr(lv, k).numpy(),
                                      flat[f"levels.0.{k}"], err_msg=k)
    if method == "NNGP":
        # nn_n derived from a JAX ModelData equals the grids' own counts,
        # so both bridges build the same reverse-neighbour lists
        for f in ("nn_n", "rev_ptr", "rev_pos"):
            np.testing.assert_array_equal(
                getattr(lv, f).numpy(),
                getattr(b["data_t"].levels[0], f).numpy(), err_msg=f)


def test_reverse_neighbour_lists_leave_out_the_pads(built):
    """Every real (unit, slot) pair appears once, under its neighbour, in
    ascending order; no pad does, so the all-pad unit 0 (and every short
    list) contributes nothing but its real entries."""
    lv = built["NNGP"]["data_t"].levels[0]
    nn, nn_n = lv.nn_idx.numpy(), lv.nn_n.numpy()
    k = nn.shape[1]
    assert nn_n[0] == 0 and (nn_n < k).any()
    ptr, pos = lv.rev_ptr.numpy(), lv.rev_pos.numpy()
    assert ptr[-1] == nn_n.sum() == pos.size
    for j in range(nn.shape[0]):
        p = pos[ptr[j]:ptr[j + 1]]
        assert (np.diff(p) > 0).all()
        assert (nn.ravel()[p] == j).all() and (p % k < nn_n[p // k]).all()
    want = {(i, s) for i in range(nn.shape[0]) for s in range(nn_n[i])}
    assert set(zip(pos // k, pos % k)) == want


# --- B8a, B8b, B8c: the plain versions --------------------------------------

def _vecchia_inputs(b, seed=0):
    g = np.random.default_rng(seed)
    C, nf = 2, 2
    x = g.standard_normal((C, NP, nf)).astype(np.float32)
    u = g.standard_normal((C, NP, nf)).astype(np.float32)
    M = g.standard_normal((C, NP, nf, nf)).astype(np.float32)
    LiSL = (M @ M.transpose(0, 1, 3, 2)).astype(np.float32)
    return np.asarray(ALPHA, np.int32), x, u, LiSL


def test_b8a_plain_matches_vecchia_ops(built):
    """RiW x, RiW' u and P x against the JAX package's vecchia_ops per chain
    (rtol 1e-5: one gather-and-sum, summed in another order); the adjoint
    identity <RiW x, u> = <x, RiW' u>; a factor at alpha = 0 returns its
    input exactly in both directions."""
    b = built["NNGP"]
    lvd_j, lvd = b["data_j"].levels[0], b["data_t"].levels[0]
    alpha, x, u, LiSL = _vecchia_inputs(b)
    at = _t(alpha)
    r_t = tops.vecchia_riw(lvd, at, _t(x)).numpy()
    t_t = tops.vecchia_riw(lvd, at, _t(x), twice=True).numpy()
    rt_t = tops.vecchia_riw_t(lvd, at, _t(u)).numpy()
    pmv_t = tops.vecchia_pmv(lvd, at, _t(x), _t(LiSL)).numpy()
    for c in range(alpha.shape[0]):
        a = jnp.asarray(alpha[c])
        coef, sqD = lvd_j.nn_coef[a], jnp.sqrt(lvd_j.nn_D[a])
        riw_t, pmv = JS.vecchia_ops(lvd_j.nn_idx, coef, sqD, LiSL[c])
        red = jnp.einsum("fik,ikf->if", coef, x[c][lvd_j.nn_idx])
        r_j = (x[c] - red) / sqD.T
        for got, want, name in ((r_t[c], r_j, "riw"),
                                (t_t[c], r_j / sqD.T, "riw twice"),
                                (rt_t[c], riw_t(u[c]), "riw_t"),
                                (pmv_t[c], pmv(x[c]), "pmv")):
            np.testing.assert_allclose(got, np.asarray(want), rtol=OP_RTOL,
                                       atol=OP_RTOL, err_msg=name)
    lhs = (r_t * u).sum(axis=(1, 2))
    rhs = (x * rt_t).sum(axis=(1, 2))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)
    # chain 0, factor 0 sits at alpha = 0: iW = I exactly
    assert alpha[0, 0] == 0
    np.testing.assert_array_equal(r_t[0, :, 0], x[0, :, 0])
    np.testing.assert_array_equal(rt_t[0, :, 0], u[0, :, 0])


def test_b8b_plain_matches_jax_quadratics(built):
    """The grid quadratics against eta_quad_grid and the at-alpha forms
    against eta_quad_at / eta_ones_forms_at, per chain (rtol 1e-5)."""
    b = built["NNGP"]
    spec_j, lvd_j, lvd = b["spec_j"], b["data_j"].levels[0], \
        b["data_t"].levels[0]
    ls = spec_j.levels[0]
    alpha, eta, _, _ = _vecchia_inputs(b, seed=1)
    grid = tops.nngp_quad_grid(lvd, _t(eta)).numpy()
    at = tops.nngp_quad_at(lvd, _t(alpha), _t(eta)).numpy()
    assert grid.shape == (2, 2, ls.n_alpha) and at.shape == (2, 2, 3)
    for c in range(alpha.shape[0]):
        v, _ = JS.eta_quad_grid(lvd_j, ls, jnp.asarray(eta[c]))
        a = jnp.asarray(alpha[c])
        q = JS.eta_quad_at(lvd_j, ls, jnp.asarray(eta[c]), a)
        q1, s = JS.eta_ones_forms_at(lvd_j, ls, jnp.asarray(eta[c]), a)
        np.testing.assert_allclose(grid[c], np.asarray(v), rtol=OP_RTOL)
        for i, want in enumerate((q, q1, s)):
            np.testing.assert_allclose(at[c, :, i], np.asarray(want),
                                       rtol=OP_RTOL, atol=OP_RTOL)


@pytest.fixture(scope="module")
def odd_nngp():
    """An NNGP level at an odd unit count (31 units, 5 neighbours) from the
    JAX package, and the port's copy of it."""
    mj = small_model(ny=62, ns=4, n_units=31, spatial="NNGP", nf=2, seed=7,
                     n_neighbours=5)
    spec_j, data_j, states_j = jax_triple(mj, seeds=(0,))
    data_t, _ = to_torch(spec_j, data_j, states_j)
    return spec_j.levels[0], data_j.levels[0], data_t.levels[0]


def test_b8b_plain_matches_jax_at_odd_np_and_many_columns(odd_nngp):
    """At np 31 and C nf = 5 x 2 = 10 columns (more than one 8-column
    chunk): the grid quadratics against eta_quad_grid and the at-alpha forms
    against eta_quad_at / eta_ones_forms_at, per chain (rtol 1e-5)."""
    ls, lvd_j, lvd = odd_nngp
    g = np.random.default_rng(3)
    C, nf = 5, 2
    npr = lvd.nn_idx.shape[0]
    assert npr % 2 == 1 and C * nf > 8
    eta = g.standard_normal((C, npr, nf)).astype(np.float32)
    alpha = g.integers(0, ls.n_alpha, (C, nf)).astype(np.int32)
    alpha[0, 0] = 0
    grid = tops.nngp_quad_grid(lvd, _t(eta)).numpy()
    at = tops.nngp_quad_at(lvd, _t(alpha), _t(eta)).numpy()
    for c in range(C):
        v, _ = JS.eta_quad_grid(lvd_j, ls, jnp.asarray(eta[c]))
        a = jnp.asarray(alpha[c])
        q = JS.eta_quad_at(lvd_j, ls, jnp.asarray(eta[c]), a)
        q1, s = JS.eta_ones_forms_at(lvd_j, ls, jnp.asarray(eta[c]), a)
        np.testing.assert_allclose(grid[c], np.asarray(v), rtol=OP_RTOL)
        for i, want in enumerate((q, q1, s)):
            np.testing.assert_allclose(at[c, :, i], np.asarray(want),
                                       rtol=OP_RTOL, atol=OP_RTOL)


def _random_level(npr, k, G, seed):
    """Random NNGP-shaped grids (any lists, positive variances): the
    quadratics are a formula in them."""
    from types import SimpleNamespace

    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, npr, (npr, k), generator=g, dtype=torch.int32)
    coef = torch.randn((G, npr, k), generator=g) * 0.3
    D = torch.rand((G, npr), generator=g) + 0.5
    unit = tstructs.unit_last_grids(idx.numpy(), coef.numpy())
    return SimpleNamespace(nn_idx=idx, nn_coef=coef, nn_D=D,
                           nn_idx_u=torch.from_numpy(unit[0]),
                           nn_coef_u=torch.from_numpy(unit[1]))


def _warp_sums(vals):
    """The grid kernel's reduction of a warp's 8 sums over its 32 lanes:
    ``vals`` (32 lanes, 8 values) -> (8,).  Three steps each keep the half
    of a lane's values that its lane bit (4, 3, 2) selects and add the
    partner's copy of that half; two butterfly steps (bits 1, 0) finish,
    so lane l ends with the sum of value l >> 2."""
    lane = torch.arange(32)
    v = vals
    for o, h in ((16, 4), (8, 2), (4, 1)):
        upper = ((lane & o) != 0)[:, None]
        keep = torch.where(upper, v[:, h:2 * h], v[:, :h])
        send = torch.where(upper, v[:, :h], v[:, h:2 * h])
        v = keep + send[lane ^ o]
    v = v + v[lane ^ 2]
    v = v + v[lane ^ 1]
    return v[::4, 0]


@pytest.mark.parametrize("C,npr,nf,k,G", [(4, 1000, 2, 10, 101),
                                          (4, 999, 2, 10, 101),
                                          (4, 1000, 8, 10, 101),
                                          (4, 100, 2, 10, 101),
                                          (3, 31, 3, 5, 11),
                                          (2, 3000, 2, 10, 11)])
def test_b8b_launch_geometry_and_summation_order(C, npr, nf, k, G):
    """B8b's grid-mode launch replayed on the CPU: a block of 512 threads a
    grid point, a thread a unit at a time over chunks of 8 columns; every
    (grid point, column, unit) is covered exactly once, and summing each
    thread's terms over its units in order, the warp's 8 sums by the
    kernel's shuffle steps and the warps in order gives the plain
    quadratics (rtol 1e-5); the at-alpha ranges cover the units once."""
    lvd = _random_level(npr, k, G, seed=npr)
    eta = torch.randn((C, npr, nf), generator=torch.Generator().manual_seed(1))
    assert tops.quad_geometry(C, npr, nf)["eta_smem"]
    ncol = C * nf
    cols = eta.permute(0, 2, 1).reshape(ncol, npr).double()
    # back from the unit-last layouts
    coef = lvd.nn_coef_u.double().permute(0, 2, 1)
    idx = lvd.nn_idx_u.long().T
    pred = torch.einsum("gik,qik->qgi", coef, cols[:, idx])
    term = (cols[:, None, :] - pred) ** 2 / lvd.nn_D.double()[None]
    hits = torch.zeros((ncol, G, npr), dtype=torch.int64)
    out = torch.zeros((ncol, G), dtype=torch.float64)
    for c0 in range(0, ncol, 8):
        cq = [min(c0 + x, ncol - 1) for x in range(8)]
        tb = term[cq].permute(1, 2, 0)                    # (G, np, 8)
        T = 512                                           # threads a block
        rows = torch.zeros((G, -(-npr // T) * T, 8), dtype=torch.float64)
        rows[:, :npr] = tb
        acc = torch.zeros((G, T, 8), dtype=torch.float64)
        for r in rows.reshape(G, -1, T, 8).unbind(1):     # a thread's units
            acc = acc + r
        hits[c0:c0 + 8] += 1
        part = sum(torch.stack([_warp_sums(acc[gg, w * 32:(w + 1) * 32])
                                for gg in range(G)])
                   for w in range(T // 32))
        out[c0:c0 + 8] = part.T[:min(8, ncol - c0)]
    assert (hits == 1).all()
    plain = tops._nngp_quad_grid_plain(lvd, eta).reshape(ncol, G)
    np.testing.assert_allclose(out.numpy(), plain.double().numpy(),
                               rtol=OP_RTOL)
    a = tops.quad_at_geometry(npr)
    assert a["S"] <= 8 and a["S"] * a["units"] >= npr
    assert (a["S"] - 1) * a["units"] < npr and a["threads"] in (128, 256)


def test_b8b_geometry_reads_eta_in_place_when_it_does_not_fit():
    """Where eta would not fit in a block's shared memory, the launch reads
    it in place."""
    assert tops.quad_geometry(4, 6000, 2)["eta_smem"]
    assert not tops.quad_geometry(4, 20000, 2)["eta_smem"]


def test_nngp_level_carries_its_grids_unit_last(odd_nngp):
    """LevelData's lists and coefficient grid with the unit last are the
    lists and the grid, transposed and contiguous, so the flat offsets
    B8b's kernels read, ``t np + i`` and ``(g k + t) np + i`` for unit i's
    slot t at grid point g, hold ``nn_idx[i, t]`` and ``nn_coef[g, i,
    t]``."""
    _, _, lvd = odd_nngp
    assert torch.equal(lvd.nn_idx_u, lvd.nn_idx.T)
    assert torch.equal(lvd.nn_coef_u, lvd.nn_coef.permute(0, 2, 1))
    assert lvd.nn_idx_u.is_contiguous() and lvd.nn_coef_u.is_contiguous()
    assert lvd.nn_idx_u.dtype == torch.int32
    G, npr, k = lvd.nn_coef.shape
    g, t, i = np.meshgrid(np.arange(G), np.arange(k), np.arange(npr),
                          indexing="ij")
    flat_idx = lvd.nn_idx_u.reshape(-1).numpy()
    flat_coef = lvd.nn_coef_u.reshape(-1).numpy()
    assert (flat_idx[t[0] * npr + i[0]]
            == lvd.nn_idx.numpy()[i[0], t[0]]).all()
    assert (flat_coef[(g * k + t) * npr + i]
            == lvd.nn_coef.numpy()[g, i, t]).all()


@pytest.mark.parametrize("form", ["iw", "riw"])
def test_b8c_plain_matches_jax_dense_iw(built, form):
    """B8c's plain version, iW (the wrapper's on the CPU and
    ``_nngp_dense_iW``'s), against _nngp_dense_iW (rtol 1e-5); and its
    scatter, the factor RiW, exactly: the scatter, identity and scaling are
    the same operations in the same order."""
    b = built["NNGP"]
    lvd_j, lvd = b["data_j"].levels[0], b["data_t"].levels[0]
    alpha = np.asarray(ALPHA, np.int32)
    if form == "iw":
        for iW in (tops._nngp_riw_dense_plain(lvd, _t(alpha)),
                   TS._nngp_dense_iW(lvd, _t(alpha))):
            for c in range(alpha.shape[0]):
                np.testing.assert_allclose(
                    iW[c].numpy(), np.asarray(JS._nngp_dense_iW(
                        lvd_j, jnp.asarray(alpha[c]), NP)),
                    rtol=OP_RTOL, atol=OP_RTOL)
        return
    RiW = tops._nngp_riw_scatter(lvd, _t(alpha)).numpy()
    for c in range(alpha.shape[0]):
        a = jnp.asarray(alpha[c])
        coef = np.asarray(lvd_j.nn_coef[a])
        D = np.asarray(lvd_j.nn_D[a])
        for f in range(2):
            R = np.zeros((NP, NP), np.float32)
            np.add.at(R, (np.arange(NP)[:, None], np.asarray(lvd_j.nn_idx)),
                      -coef[f])
            R = (R + np.eye(NP, dtype=np.float32)) / np.sqrt(D[f])[:, None]
            np.testing.assert_array_equal(RiW[c, f], R)


def _iw_replay(nn_idx, nn_n, coef, D, rev_ptr, rev_pos, rows):
    """B8c's kernel (csrc/nngp_riw.cu) replayed in float32 for one factor at
    its alpha's grid slices ``coef`` (np, k), ``D`` (np,): a block a tile
    of ``rows`` rows that stages the units from its first row on, a warp a
    row j that adds r_i[j] r_i, nonzero at i and unit i's real neighbours
    (all below i), for i = j, then for the units that list j in the
    reverse-neighbour CSR's order.  Vectorised over l."""
    npr, k = nn_idx.shape
    f32 = np.float32
    sq = np.sqrt(D.astype(f32))
    vv = -coef.astype(f32) / sq[:, None]
    di = f32(1) / sq
    out = np.full((npr, npr), np.nan, f32)
    for j0 in range(0, npr, rows):
        for j in range(j0, min(npr, j0 + rows)):
            def row(i):                       # r_i[l] over l
                r = np.zeros(npr, f32)
                r[i] = di[i]
                n = nn_n[i]
                assert (nn_idx[i, :n] < i).all()
                r[nn_idx[i, :n]] = vv[i, :n]
                return r
            acc = di[j] * row(j)
            for e in range(rev_ptr[j], rev_ptr[j + 1]):
                i, slot = divmod(int(rev_pos[e]), k)
                assert i >= j0                # staged by this block
                acc = acc + vv[i, slot] * row(i)
            out[j] = acc
    return out


@pytest.mark.parametrize("npr,nf", [(97, 2), (128, 2), (256, 1)])
def test_b8c_kernel_sum_over_reverse_neighbours_matches_jax(npr, nf):
    """B8c's per-entry sum over the reverse-neighbour CSR, replayed on the
    CPU at ``iw_geometry``'s tiles, against _nngp_dense_iW (rtol 1e-5) on a
    10-neighbour level (unit 0 with no neighbour, the first units' lists
    padded), 4 chains with alpha 0 among their factors; the block's shared
    memory fits the card's."""
    from types import SimpleNamespace

    from hmsc_tpu_torch.precompute import _nngp_grids

    g = np.random.default_rng(npr)
    pts = g.uniform(size=(npr, 2)) * 10.0
    lp = _nngp_grids(pts, 10, np.linspace(0.0, 14.0, 11))
    nn_idx, nn_n = lp.nn_idx, lp.nn_n
    assert nn_n[0] == 0 and (nn_n < 10).sum() >= 10
    rev_ptr, rev_pos = tstructs.reverse_neighbours(nn_idx, nn_n)
    geo = tops.iw_geometry(npr, 10, len(rev_pos))
    assert geo["tiles"] * geo["rows"] >= npr > (geo["tiles"] - 1) * geo["rows"]
    assert geo["smem"] <= tops._IW_SMEM_MAX
    coef = lp.nn_coef.astype(np.float32)
    D = lp.nn_D.astype(np.float32)
    lvd_j = SimpleNamespace(nn_coef=jnp.asarray(coef), nn_D=jnp.asarray(D),
                            nn_idx=jnp.asarray(nn_idx, jnp.int32))
    alpha = g.integers(0, 11, (4, nf))
    alpha[0, 0] = 0
    for c in range(4):
        want = np.asarray(JS._nngp_dense_iW(lvd_j, jnp.asarray(alpha[c]), npr))
        for f in range(nf):
            a = alpha[c, f]
            got = _iw_replay(nn_idx, nn_n, coef[a], D[a], rev_ptr, rev_pos,
                             geo["rows"])
            np.testing.assert_allclose(got, want[f], rtol=OP_RTOL,
                                       atol=OP_RTOL * np.abs(want[f]).max())


# --- the updaters -----------------------------------------------------------

@pytest.mark.parametrize("method", ["Full", "NNGP"])
def test_update_eta_spatial_dense(built, method):
    """The dense (nf np)^2 draw with the JAX function's normals injected
    (rtol 1e-4 / atol 1e-5: two float32 Cholesky factorisations of one
    60 x 60 precision)."""
    b = built[method]
    spec_j, data_j, keys = b["spec_j"], b["data_j"], b["keys"]
    ref = []
    for s, k in zip(b["states_j"], keys):
        S = _residual(spec_j, data_j, s)
        ref.append(s.replace(levels=(JS.update_eta_spatial(
            spec_j, data_j, s, 0, k, S),)))
    noise = _stack([eta_spatial_noise(spec_j, k) for k in keys])
    st = b["state_t"]
    lv = TS.update_eta_spatial(b["spec_t"], b["data_t"], st, 0,
                               S=_residual(b["spec_t"], b["data_t"], st),
                               noise=noise)
    _compare(st.replace(levels=(lv,)), ref, fields={"Eta"})


def _cg_system(b):
    """The port's CG system for chain states of ``b`` with the JAX draws:
    (pmv, right-hand side, dense float64 precision per chain)."""
    spec, data, st = b["spec_t"], b["data_t"], b["state_t"]
    lvd, lv, ls = data.levels[0], st.levels[0], spec.levels[0]
    S = _residual(spec, data, st)
    LiSL, F = TU._level_gram(spec, data, lvd, ls, lv, st.iSigma, S)
    noise = _stack([eta_spatial_noise(b["spec_j"], k, dense=False)
                    for k in b["keys"]])
    lam = TU.lambda_effective(lv)[..., 0]
    w = noise["xi"] * torch.sqrt(st.iSigma)[:, None, :]
    b_like = F.new_zeros(F.shape).index_add_(1, lvd.pi_row,
                                             w @ lam.transpose(1, 2))
    rhs = F + tops.vecchia_riw_t(lvd, lv.alpha_idx, noise["eps1"]) + b_like
    iW = TS._nngp_dense_iW(lvd, lv.alpha_idx).double().numpy()
    C, nf = iW.shape[:2]
    P = np.zeros((C, nf, NP, nf, NP))
    for h in range(nf):
        P[:, h, :, h, :] = iW[:, h]
    for u in range(NP):
        P[:, :, u, :, u] += LiSL[:, u].double().numpy()
    return (lambda x: tops.vecchia_pmv(lvd, lv.alpha_idx, x, LiSL), rhs,
            P.reshape(C, nf * NP, nf * NP), noise)


def test_update_eta_nngp_cg(built, cg_path):
    """The matrix-free CG draw against the JAX package's with eps1 and xi
    injected, and against the dense solve of the same system.  CG stops at
    a relative residual of tol = 1e-5 (recursive, float32); the true
    residual is allowed 10 tol for the float32 gap, so each solution lies
    within |P^-1| 10 tol |b| of the exact one, and the two packages'
    within twice that of each other."""
    b = built["NNGP"]
    spec_j, data_j, keys = b["spec_j"], b["data_j"], b["keys"]
    ref = [JS.update_eta_spatial(spec_j, data_j, s, 0, k,
                                 _residual(spec_j, data_j, s)).Eta
           for s, k in zip(b["states_j"], keys)]
    pmv, rhs, P, noise = _cg_system(b)
    st = b["state_t"]
    log = []
    lv = TS.update_eta_spatial(b["spec_t"], b["data_t"], st, 0,
                               S=_residual(b["spec_t"], b["data_t"], st),
                               noise=noise, cg_log=log)
    (r, loop, kmax, chains), = log
    assert r == 0 and kmax == int(chains.max())
    assert 0 < kmax <= loop and loop % TS._CG_CHECK_EVERY == 0
    tol = 10 * TS.CG_TOL
    for c in range(len(keys)):
        bv = rhs[c].T.reshape(-1).double().numpy()
        exact = np.linalg.solve(P[c], bv)
        got = lv.Eta[c].T.reshape(-1).double().numpy()
        want = np.asarray(ref[c]).T.reshape(-1)
        bound = np.linalg.norm(np.linalg.inv(P[c]), 2) * tol * \
            np.linalg.norm(bv)
        assert np.linalg.norm(P[c] @ got - bv) <= tol * np.linalg.norm(bv)
        assert np.linalg.norm(got - exact) <= bound
        assert np.linalg.norm(got - want) <= 2 * bound
    # a warm start at the solution stops at once; chains are frozen apart
    x, res, it, kmax, k = TS.vecchia_cg_draw(pmv, rhs, lv.Eta)
    assert it <= TS._CG_CHECK_EVERY and (res < 1e-3).all()


def test_cg_first_check_follows_previous_draw(built, cg_path):
    """The host's first convergence read comes at the level's previous
    draw's largest per-chain count: converged chains are frozen, so the
    solution is the same bit for bit whenever the reads come, and a draw
    that needs no more iterations than the previous one stops there."""
    b = built["NNGP"]
    pmv, rhs, _, noise = _cg_system(b)
    x0 = b["state_t"].levels[0].Eta
    x, _, it, kmax, k = TS.vecchia_cg_draw(pmv, rhs, x0)
    assert it % TS._CG_CHECK_EVERY == 0
    assert 1 < kmax <= it < kmax + TS._CG_CHECK_EVERY
    for first, want_it in ((kmax, kmax), (kmax - 1,
                                          kmax - 1 + TS._CG_CHECK_EVERY)):
        x1, _, it1, kmax1, k1 = TS.vecchia_cg_draw(pmv, rhs, x0,
                                                   first_check=first)
        assert it1 == want_it and kmax1 == kmax
        assert torch.equal(x1, x) and torch.equal(k1, k)
    # through the Eta draw: the hint is the same level's entry, not the
    # last one of another level
    st = b["state_t"]
    log = [(0, 8, kmax, k), (1, 8, kmax + 3, k)]
    TS.update_eta_spatial(b["spec_t"], b["data_t"], st, 0,
                          S=_residual(b["spec_t"], b["data_t"], st),
                          noise=noise, cg_log=log)
    assert log[-1][:3] == (0, kmax, kmax)


def test_fused_cg_plain_matches_jax_cg_draw(built, cg_path):
    """The one-launch CG draw's plain semantics (``vecchia_cg`` on the CPU:
    b formed inside, each chain stopped at its own count, no host schedule)
    against the JAX package's ``vecchia_cg_draw`` per chain with the same
    F, LiSL, b_like, eps1 and warm start: x within 1e-4 of max |x|, and
    counts within one of the JAX solve's (its maxiter = the port's count +
    1 gives its converged x bit for bit, the port's count - 2 does not).
    Both stop at a relative residual of 1e-5 in float32, and two float32
    solves summed in another order may cross it an iteration apart: here
    the JAX solve's true residual after the port's 22 iterations is
    1.16e-5, the port's 9.93e-6."""
    b = built["NNGP"]
    spec, data, st = b["spec_t"], b["data_t"], b["state_t"]
    lvd, lv, ls = data.levels[0], st.levels[0], spec.levels[0]
    LiSL, F = TU._level_gram(spec, data, lvd, ls, lv, st.iSigma,
                             _residual(spec, data, st))
    noise = _stack([eta_spatial_noise(b["spec_j"], k, dense=False)
                    for k in b["keys"]])
    lam = TU.lambda_effective(lv)[..., 0]
    w = noise["xi"] * torch.sqrt(st.iSigma)[:, None, :]
    b_like = F.new_zeros(F.shape).index_add_(1, lvd.pi_row,
                                             w @ lam.transpose(1, 2))
    x, res, k = tops.vecchia_cg(lvd, lv.alpha_idx, LiSL, F, noise["eps1"],
                                b_like, lv.Eta, TS.CG_TOL, TS.CG_MAXITER)
    assert k.dtype == torch.int32 and (res < 1e-3).all()
    lvd_j = b["data_j"].levels[0]
    for c in range(F.shape[0]):
        a = jnp.asarray(lv.alpha_idx[c].numpy())
        riw_t, pmv = JS.vecchia_ops(lvd_j.nn_idx, lvd_j.nn_coef[a],
                                    jnp.sqrt(lvd_j.nn_D[a]),
                                    jnp.asarray(LiSL[c].numpy()))
        ins = [jnp.asarray(t[c].numpy()) for t in (F, b_like, noise["eps1"],
                                                    lv.Eta)]

        def run(m):
            return np.asarray(JS.vecchia_cg_draw(
                riw_t, pmv, ins[0], ins[1], ins[2], x0=ins[3],
                tol=TS.CG_TOL, maxiter=m)[0])

        want = run(TS.CG_MAXITER)
        got = x[c].numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        kc = int(k[c])
        assert kc > 2
        assert np.array_equal(run(kc + 1), want)
        assert not np.array_equal(run(kc - 2), want)


@pytest.mark.parametrize("npr,nf", [(30, 2), (1000, 2), (5000, 2),
                                    (5000, 8), (100000, 4)])
def test_cg_geometry(npr, nf):
    """The fused CG draw's launch: a cluster of 1-8 CTAs (a power of two)
    covering the level's units, a unit a thread below 8 CTAs in whole
    warps of at most 256 threads, the vectors (p and t whole, four
    slices) in shared memory within 227 KB or else in global memory."""
    G, units, threads, smem, glob = tops.cg_geometry(npr, nf)
    assert G in (1, 2, 4, 8) and G * units >= npr > (G - 1) * units
    assert threads % 32 == 0 and threads <= tops._CG_THREADS
    assert G == 8 or units <= threads
    assert smem <= 227 * 1024
    assert glob == (4 * (tops._CG_SCRATCH + 2 * npr * nf + 4 * units * nf)
                    > 227 * 1024)
    if (npr, nf) == (1000, 2):
        assert (G, threads, glob) == (8, 128, False)


def test_cg_stall_poisons_the_draw(built):
    """A CG solve cut off far from convergence returns NaN for the chain,
    so that the sampler's divergence tracker reports it."""
    b = built["NNGP"]
    _, _, _, noise = _cg_system(b)
    st = b["state_t"]
    lv = TS._eta_nngp_cg(b["spec_t"], b["data_t"], st, 0, None,
                         _residual(b["spec_t"], b["data_t"], st), noise,
                         maxiter=1)
    assert torch.isnan(lv.Eta).all()


@pytest.mark.parametrize("method", ["Full", "NNGP"])
def test_update_alpha(built, method):
    """With the Gumbel draws injected, the same grid indices."""
    b = built[method]
    spec_j, data_j, keys = b["spec_j"], b["data_j"], b["keys"]
    ref = [np.asarray(JS.update_alpha(spec_j, data_j, s, 0, k).alpha_idx)
           for s, k in zip(b["states_j"], keys)]
    noise = _stack([alpha_noise(spec_j, k) for k in keys])
    lv = TS.update_alpha(b["spec_t"], b["data_t"], b["state_t"], 0,
                         noise=noise)
    np.testing.assert_array_equal(lv.alpha_idx.numpy(), np.stack(ref))
    assert lv.alpha_idx.dtype == torch.int32


@pytest.mark.parametrize("method", ["Full", "NNGP"])
def test_interweaves_on_a_spatial_level(built, method):
    """Scale then location interweave with the JAX draws injected; their
    prior forms come from iW at each factor's alpha (rtol 1e-4 /
    atol 1e-5)."""
    b = built[method]
    spec_j, data_j, keys = b["spec_j"], b["data_j"], b["keys"]
    ref = [JU.interweave_location(spec_j, data_j,
                                  JU.interweave_scale(spec_j, data_j, s, k),
                                  jax.random.fold_in(k, 9))
           for s, k in zip(b["states_j"], keys)]
    sc = _stack([scale_noise(spec_j, k) for k in keys])
    loc = _stack([location_noise(spec_j, jax.random.fold_in(k, 9))
                  for k in keys])
    spec, data, st = b["spec_t"], b["data_t"], b["state_t"]
    out = TU.interweave_location(
        spec, data, TU.interweave_scale(spec, data, st, noise=sc), noise=loc)
    _compare(out, ref, fields={"Eta", "Lambda", "Beta"})
    assert not np.allclose(out.levels[0].Eta.numpy(),
                           st.levels[0].Eta.numpy())


@pytest.mark.parametrize("method", ["Full", "NNGP-CG"])
def test_full_sweep_spatial(built, method, monkeypatch):
    """One whole sweep from an identical state with every JAX draw
    injected, the spatial Eta and Alpha blocks included (rtol 1e-4 /
    atol 1e-5, compounded over the blocks)."""
    dense = method == "Full"
    if not dense:
        monkeypatch.setattr(JS, "_NNGP_DENSE_MAX", 0)
        monkeypatch.setattr(TS, "_NNGP_DENSE_MAX", 0)
    b = built["Full" if dense else "NNGP"]
    spec_j, data_j, keys = b["spec_j"], b["data_j"], b["keys"]
    adapt = (10,)
    jsw = jsweep.make_sweep(spec_j, adapt_nf=adapt)
    ref = [jsw(data_j, s, k) for s, k in zip(b["states_j"], keys)]
    per = [spatial_sweep_noise(spec_j, data_j, s, k, dense)
           for s, k in zip(b["states_j"], keys)]
    noise = {n: _stack([p[n] for p in per]) for n in per[0]}
    sweep = tsweep.make_sweep(b["spec_t"], adapt_nf=adapt)
    names = [n for n, _ in tsweep.make_sweep_schedule(b["spec_t"],
                                                      adapt_nf=adapt)]
    assert names[3:5] == ["EtaSpatial", "Alpha"]
    out = sweep(b["data_t"], b["state_t"], None, it=5, noise=noise)
    _compare(out, ref)


# --- end to end -------------------------------------------------------------

def test_full_posterior_moments_match_jax():
    """The port's sample_mcmc (CPU) against the JAX package's on a small
    Full model: z-scores of the posterior means of Beta and Omega (the
    test_parity.py criterion).  The JAX run is short (2 chains, 20 + 40
    sweeps), so its standard errors are wide."""
    mj = small_model(ny=40, ns=6, n_units=20, spatial="Full", nf=2, seed=1)
    mt = _port_model(mj, "Full")
    pj = hmsc_tpu.sample_mcmc(mj, samples=40, transient=20, n_chains=2,
                              seed=1)
    pt = ht.sample_mcmc(mt, samples=300, transient=100, n_chains=2, seed=2,
                        device="cpu")
    assert pt.chain_health["good_chains"].all()
    for k in pj.arrays:
        assert pt[k].shape[2:] == pj[k].shape[2:], k
        assert np.isfinite(pt[k]).all(), k
    assert pt["Alpha_0"].min() >= 0 and pt["Alpha_0"].max() < 101
    beta_t = pt["Beta"].reshape((-1,) + pt["Beta"].shape[2:])
    om_t = _omega(pt).reshape((-1, NS, NS))
    _assert_parity([_z_scores(pj["Beta"], beta_t),
                    _z_scores(_omega(pj), om_t)], "Full")


def test_nngp_cg_sampler_reports_iterations(cg_path):
    """A run whose NNGP level takes the CG path reports each draw's
    iterations: one entry per sweep, chain counts within the loop's."""
    mj = small_model(ny=40, ns=6, n_units=20, spatial="NNGP", nf=2, seed=2,
                     n_neighbours=K_NN)
    post = ht.sample_mcmc(_port_model(mj, "NNGP"), samples=3, transient=2,
                          n_chains=2, seed=1, device="cpu")
    cg = post.cg_iterations
    assert len(cg["loop"]) == 5 and cg["chains"].shape == (5, 2)
    assert (cg["chains"] > 0).all()
    assert (cg["chains"].max(axis=1) <= np.asarray(cg["loop"])).all()
    assert np.isfinite(post["Eta_0"]).all()


def test_gpp_still_raises():
    """GPP levels are in the port (tests/test_torch_gpp.py): the grids
    build and the sampler runs them; what still raises on a GPP model is a
    feature of a later slice, here a phylogeny, refused by name."""
    mj = small_model(ny=20, ns=4, n_units=10, spatial="GPP", nf=2, seed=3)
    rl = mj.ranLevels[0]
    names = sorted(rl._s_index, key=rl._s_index.get)
    rt = ht.HmscRandomLevel(s_data=pd.DataFrame(rl.s, index=names),
                            s_method="GPP", s_knot=rl.s_knot)
    kw = dict(Y=mj.Y, X=mj.X, distr="normal", study_design=mj.study_design,
              ran_levels={"lvl": rt})
    mt = ht.Hmsc(**kw)
    assert t_cdp(mt).rL_par[0].kind == "GPP"
    post = ht.sample_mcmc(mt, samples=2, transient=1, n_chains=2, seed=1,
                          device="cpu")
    assert post.chain_health["good_chains"].all()
    assert np.isfinite(post["Eta_0"]).all()
    with pytest.raises(NotImplementedError, match="phylogeny"):
        ht.sample_mcmc(ht.Hmsc(C=np.eye(mj.ns), **kw), samples=1,
                       device="cpu")
