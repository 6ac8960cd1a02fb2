"""Kernel B1's two operand forms on the CPU: the fused form's plain version
(the linear predictor formed from X Beta and the level's loadings, then the
truncated normal) against the JAX package's ``update_z`` and its op, the
sweep that hands Z no linear predictor on the models where Z's probit
branch is its only reader, the launch geometry, and the float32 formulas
of the kernel's Phi and Phi^-1 against scipy.  The CUDA kernel itself runs
only on the card; ``chip_smoke.py`` holds both forms against these plain
versions there."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special

from hmsc_tpu.mcmc import updaters as JU
from hmsc_tpu.ops import rand as jrand

from hmsc_tpu_torch.mcmc import sweep as tsweep
from hmsc_tpu_torch.mcmc import updaters as TU
from hmsc_tpu_torch.ops import rand as trand

from test_torch_updaters import (ATOL, RTOL, _compare, _setup, _stack,
                                 _sweep_noise_stacked, z_noise)

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

CSRC = pathlib.Path(trand.__file__).resolve().parent.parent / "csrc"


def _mask_one_factor(states_j, state_t):
    """Make chain 0's last factor inactive in both packages' states."""
    lv = states_j[0].levels[0]
    m = np.asarray(lv.nf_mask).copy()
    m[-1] = 0.0
    states_j[0] = states_j[0].replace(levels=(lv.replace(
        nf_mask=jnp.asarray(m)),))
    lv_t = state_t.levels[0]
    mt = lv_t.nf_mask.clone()
    mt[0, -1] = 0.0
    return states_j, state_t.replace(levels=(lv_t.replace(nf_mask=mt),))


@pytest.mark.parametrize("n_units", [None, 10])
def test_fused_plain_matches_jax_update_z(n_units):
    """Z from the fused form's plain version, and ``update_z`` without E
    (which takes it), against the JAX ``update_z`` and against the JAX op at
    the JAX linear predictor, on its uniforms; with one factor inactive and
    (n_units 10) fewer units than rows."""
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup(
        "probit", n_units=n_units)
    states_j, state_t = _mask_one_factor(states_j, state_t)
    assert TU.fused_z(spec_t)
    assert (spec_t.levels[0].n_units < spec_t.ny) == (n_units is not None)
    ref = [JU.update_z(spec_j, data_j, s, k) for s, k in zip(states_j, keys)]
    noise = _stack([z_noise(spec_j, k) for k in keys])
    out = TU.update_z(spec_t, data_t, state_t, noise=noise)
    _compare(out, ref, fields={"Z"})

    lv = state_t.levels[0]
    z = trand.probit_z_fused(
        data_t.X, state_t.Beta, state_t.iSigma ** -0.5, data_t.Y,
        u=noise["u"], level=(lv.Eta, data_t.levels[0].pi_row,
                             lv.Lambda[..., 0], lv.nf_mask)).numpy()
    for c, s in enumerate(states_j):
        E = JU.total_loading(spec_j, data_j, s)
        zj = jrand.truncated_normal_onesided(
            keys[c], 0.0, data_j.Y > 0.5, E, s.iSigma[None, :] ** -0.5,
            _u=jnp.asarray(noise["u"][c].numpy()))
        np.testing.assert_allclose(z[c], np.asarray(zj), rtol=RTOL,
                                   atol=ATOL)


def test_fused_plain_without_a_level_is_x_beta():
    """With no random level the fused form's E is X Beta alone."""
    rng = np.random.default_rng(0)
    C, ny, ns, nc = 2, 9, 7, 3
    X, Beta = (torch.tensor(rng.standard_normal(s), dtype=torch.float32)
               for s in ((ny, nc), (C, nc, ns)))
    std = torch.tensor(rng.uniform(0.5, 2.0, (C, ns)), dtype=torch.float32)
    Y = torch.tensor(rng.uniform(size=(ny, ns)) < 0.5, dtype=torch.float32)
    u = torch.tensor(rng.uniform(1e-38, 1.0, (C, ny, ns)),
                     dtype=torch.float32)
    z = trand.probit_z_fused(X, Beta, std, Y, u=u)
    want = trand.truncated_normal_onesided(X @ Beta, std, Y, u=u)
    assert torch.equal(z, want)
    with pytest.raises(ValueError):
        trand.probit_z_fused(torch.zeros((ny, 33)), torch.zeros((C, 33, ns)),
                             std, Y, u=u)


@pytest.mark.parametrize("kind,fused", [("probit", True), ("mixed", False),
                                        ("na", False)])
def test_eta_block_forms_e_only_where_another_block_reads_it(kind, fused):
    """The Eta block hands Z no linear predictor on a headline-like probit
    model and forms it on a config-5-like mixed model and an NA model; one
    sweep of each matches the JAX sweep (which always forms it) from the
    JAX draws at rtol 1e-4 / atol 1e-5."""
    from hmsc_tpu.mcmc import sweep as jsweep

    spec_j, data_j, states_j, spec_t, data_t, state_t, keys = _setup(
        kind, it=4, n_units=10 if kind == "probit" else None)
    assert TU.fused_z(spec_t) is fused
    noise = _sweep_noise_stacked(spec_j, data_j, states_j, keys)
    steps = dict(tsweep.make_sweep_schedule(spec_t, adapt_nf=(10,)))
    _, E = steps["Eta"](data_t, (state_t, None), None, noise["Eta"])
    assert (E is None) is fused
    jsw = jsweep.make_sweep(spec_j, adapt_nf=(10,))
    ref = [jsw(data_j, s, k) for s, k in zip(states_j, keys)]
    out = tsweep.make_sweep(spec_t, adapt_nf=(10,))(data_t, state_t, None,
                                                    it=5, noise=noise)
    _compare(out, ref)


@pytest.mark.parametrize("ny,ns", [(1000, 1000), (2000, 50), (300, 90),
                                   (7, 3), (33, 130)])
def test_launch_geometry_covers_every_cell_once(ny, ns):
    """B1's grid of (column tile, row tile) blocks, each thread 4 columns of
    4 rows, covers every (row, column) of a chain exactly once."""
    lg, (gx, gy) = trand.probit_z_geometry(ny, ns)
    tcg = 1 << lg
    slots = 256 // tcg
    assert 4 * tcg >= min(ns, 128) and (tcg == 4 or 2 * tcg < ns)
    bx, by, t, r, q = np.meshgrid(np.arange(gx), np.arange(gy),
                                  np.arange(256), np.arange(4), np.arange(4),
                                  indexing="ij")
    i = by * slots * 4 + t // tcg + r * slots
    j = bx * 4 * tcg + 4 * (t % tcg) + q
    ok = (i < ny) & (j < ns)
    hits = np.zeros((ny, ns), np.int64)
    np.add.at(hits, (i[ok], j[ok]), 1)
    assert (hits == 1).all()


# the kernels' float32 Phi and Phi^-1 (csrc/truncnorm.cuh · upper_prob,
# neg_ndtri, shared by B1 and B9b), transcribed: the Numerical Recipes
# erfc and AS 241 (PPND7)
_ERFC = (0.17087277, -0.82215223, 1.48851587, -1.13520398, 0.27886807,
         -0.18628806, 0.09678418, 0.37409196, 1.00002368, -1.26551223)
_A = (5.9109374720e+01, 1.5929113202e+02, 5.0434271938e+01, 3.3871327179e+00)
_B = (6.7187563600e+01, 7.8757757664e+01, 1.7895169469e+01, 1.0)
_C = (1.7023821103e-01, 1.3067284816e+00, 2.7568153900e+00, 1.4234372777e+00)
_D = (1.2021132975e-01, 7.3700164250e-01, 1.0)
_E = (1.7337203997e-02, 4.2868294337e-01, 3.0812263860e+00, 6.6579051150e+00)
_F = (1.2258202635e-02, 2.4197894225e-01, 1.0)


def _horner(x, coefs):
    f32 = np.float32
    p = np.full_like(x, f32(coefs[0]))
    for c in coefs[1:]:
        p = p * x + f32(c)
    return p


def _upper_prob(t):
    f32 = np.float32
    z = np.abs(t) * f32(0.70710678118654752)
    r = f32(1.0) / (f32(0.5) * z + f32(1.0))
    p = _horner(r, _ERFC)
    h = f32(0.5) * r * np.exp2(f32(1.4426950408889634) * (-z * z + p))
    return np.where(t > 0, h, f32(1.0) - h)


def _neg_ndtri(p):
    f32 = np.float32
    q = p - f32(0.5)
    r = f32(0.180625) - q * q
    w = f32(-0.69314718055994531) * np.log2(np.minimum(p, f32(1.0) - p))
    v = np.sqrt(w)
    near = v <= f32(5.0)
    v = np.where(near, v - f32(1.6), v - f32(5.0))
    nc = np.where(near, _horner(v, _C), _horner(v, _E))
    nd = np.where(near, _horner(v, _D), _horner(v, _F))
    central = np.abs(q) <= f32(0.425)
    num = np.where(central, -q * _horner(r, _A), np.where(q < 0, nc, -nc))
    return num / np.where(central, _horner(r, _B), nd)


def test_kernel_phi_formulas_match_scipy_in_float32():
    """In float32 the kernel's erfc polynomial keeps P(W > t) within 2e-5
    relative for t up to 9 (the far tail takes over above), and AS 241's
    rationals keep -Phi^-1(p) within 1e-5 absolute over [1e-30, 1 -
    2^-24]; the draw's gate on the card is 1e-4 sd.  The coefficients are
    the ones in csrc/truncnorm.cuh."""
    src = (CSRC / "truncnorm.cuh").read_text()
    for c in _ERFC + _A + _B[:-1] + _C + _D[:-1] + _E + _F[:-1]:
        assert f"{c}" in src or f"{c:.10e}" in src, c
    t = np.concatenate([np.linspace(-12.0, 9.0, 20001),
                        -np.logspace(-6, 0, 200), np.logspace(-6, 0, 200)]
                       ).astype(np.float32)
    got = _upper_prob(t).astype(np.float64)
    want = special.ndtr(-t.astype(np.float64))
    assert np.max(np.abs(got / want - 1.0)) < 2e-5
    p = np.concatenate([np.logspace(-30, -1, 3000), np.linspace(0.01, 0.99,
                                                                9801),
                        1.0 - np.logspace(-7.2, -1, 600),
                        [1.0 - 2.0 ** -24]]).astype(np.float32)
    got = _neg_ndtri(p).astype(np.float64)
    want = -special.ndtri(p.astype(np.float64))
    assert np.max(np.abs(got - want)) < 1e-5
