"""The port's per-block mixed-precision policy (``precision_policy=``)
against the JAX package's (``hmsc_tpu/mcmc/precision.py``,
``hmsc_tpu/ops/mixed.py``): every routed contraction (kernel B10's plain
version), the bf16 forms of B4, B6, B8b (at alpha) and B8c, one policy'd
sweep per model kind from one state with the JAX draws injected, and the
API.  Inputs are made with numpy from a seed and handed to both.

The JAX reference sweep is compiled with ``xla_allow_excess_precision``
off: by default XLA may skip a bfloat16 rounding whose result is read in
float32 (a jitted program then differs from the same ops run one by one);
the port rounds every one, as op-by-op JAX does."""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hmsc_tpu
from hmsc_tpu.mcmc import precision as jprec
from hmsc_tpu.mcmc import spatial as JS
from hmsc_tpu.mcmc import sweep as jsweep
from hmsc_tpu.mcmc import updaters as JU
from hmsc_tpu.ops import mixed as jmx

import hmsc_tpu_torch
from hmsc_tpu_torch.mcmc import precision as tprec
from hmsc_tpu_torch.mcmc import structs as tstructs
from hmsc_tpu_torch.mcmc import spatial as TS
from hmsc_tpu_torch.mcmc import sweep as tsweep
from hmsc_tpu_torch.mcmc import updaters as TU
from hmsc_tpu_torch.ops import gram as tgram
from hmsc_tpu_torch.ops import mixed as tmx

from test_torch_gamma_v import _gamma_v_model
from test_torch_model import flatten, make_models, to_torch
from test_torch_updaters import (_setup as base_setup, _stack,
                                 _sweep_noise_stacked, gamma_v_noise)
import test_torch_gpp as tgpp
import test_torch_spatial as tspat

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
# a routed product against the JAX op: the same exact products (bf16 x bf16
# is exact in float32), summed in another order
TERM_TOL = 1e-5
# one policy'd sweep against the JAX package's: per state tensor, the 99th
# percentile of |port - JAX| / max|JAX| and its maximum (a tensor of fewer
# than 100 entries is held to the maximum alone)
P99_TOL, MAX_TOL, SMALL = 1e-4, 1e-2, 100
_SKIP = ("BetaSel", "wRRR", "PsiRRR", "DeltaRRR")


def _bf16_exact(rng, shape):
    """Normals rounded to bfloat16 values, held in float32."""
    return tmx.round_bf16(torch.tensor(rng.standard_normal(shape),
                                       dtype=torch.float32))


def _terms(a, b):
    """|a| @ |b| of the rounded operands in float64: the sum of the
    products' magnitudes each output adds."""
    return (tmx.round_bf16(a).double().abs()
            @ tmx.round_bf16(b).double().abs())


# --- B10: every routed contraction ------------------------------------------

def _matmul_cases(rng, exact):
    mk = (lambda s: _bf16_exact(rng, s)) if exact else (
        lambda s: torch.tensor(rng.standard_normal(s), dtype=torch.float32))
    C, ny, nc, ns, P, nf = 3, 40, 3, 17, 6, 4
    X, Beta = mk((ny, nc)), mk((C, nc, ns))
    XE, Z = mk((C, ny, P)), mk((C, ny, ns))
    lam, S, isig = mk((C, nf, ns)), mk((C, ny, ns)), mk((C, ns)).abs()
    u = mk((C, ns, 1))
    E = mk((C, nc, ns))
    return {
        "X Beta (linear_fixed)": (X, Beta),
        "XE'XE": (XE.transpose(1, 2), XE),
        "XE'Z": (XE.transpose(1, 2), Z),
        "(lam iSigma) lam'": (lam * isig[:, None, :], lam.transpose(1, 2)),
        "(S iSigma) lam'": (S * isig[:, None, :], lam.transpose(1, 2)),
        "lam lam'": (lam, lam.transpose(1, 2)),
        "lam u": (lam, u),
        "E E'": (E, E.transpose(1, 2)),
    }


@pytest.mark.parametrize("exact", [True, False],
                         ids=["bf16_exact", "float32"])
def test_routed_matmuls_match_jax(exact):
    """Each product the port routes (``mixed.matmul``: B10's plain version)
    against ``hmsc_tpu.ops.mixed.matmul`` in a bf16 scope, within 1e-5 of
    the sum of its terms' magnitudes, bf16-exact operands or general
    float32 ones (rounded by both to nearest even; measured at most
    ~3e-8 of the terms either way)."""
    rng = np.random.default_rng(11)
    for name, (a, b) in _matmul_cases(rng, exact).items():
        with tmx.scope("bfloat16"):
            got = tmx.matmul(a, b)
        with jmx.scope("bfloat16"):
            ref = jmx.matmul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
        assert got.dtype == torch.float32 and ref.dtype == jnp.float32
        err = (got.double() - torch.tensor(np.asarray(ref)).double()).abs()
        assert (err <= TERM_TOL * _terms(a, b)).all(), name
        with tmx.scope("float32"):         # layout-only: the plain product
            assert torch.equal(tmx.matmul(a, b), a @ b), name


@pytest.mark.parametrize("eq", ["chu,chuv,chv->ch", "chik,cikh->chi",
                                "cyf,cfj->cyj"])
def test_routed_einsums_match_jax(eq):
    """``mixed.einsum`` (one B10 call by permute and reshape; a third
    operand meets the float32 intermediate, rounded) against the JAX
    package's ``mx.einsum`` in a bf16 scope, on float32 operands and a
    bfloat16 shadow; 1e-5 of the terms' magnitudes."""
    rng = np.random.default_rng(12)
    size = dict(c=2, h=3, u=9, v=9, i=11, k=4, y=7, f=3, j=5)
    terms = eq.split("->")[0].split(",")
    ops = [torch.tensor(rng.standard_normal([size[i] for i in t]),
                        dtype=torch.float32) for t in terms]
    if len(ops) == 3:                      # the staged grid, as a shadow
        ops[1] = ops[1].to(torch.bfloat16)
    with tmx.scope("bfloat16"):
        got = tmx.einsum(eq, *ops)
    jops = [jnp.asarray(o.float().numpy()).astype(
        jnp.bfloat16 if o.dtype == torch.bfloat16 else jnp.float32)
        for o in ops]
    with jmx.scope("bfloat16"):
        ref = np.asarray(jmx.einsum(eq, *jops), np.float64)
    mags = torch.einsum(eq, *[tmx.round_bf16(o).double().abs()
                              for o in ops])
    err = (got.double() - torch.tensor(ref)).abs()
    assert got.dtype == torch.float32
    assert (err <= TERM_TOL * mags).all()


def test_gemm_splits_cover_k_in_order():
    """B10's split of K depends on the shape alone, every split non-empty,
    each a whole number of k tiles (the kernel's ordered second pass then
    gives the same bits on every rerun)."""
    for nb, M, N, K in [(4, 10, 1000, 1000), (4, 10, 10, 1000),
                        (1, 2, 2, 33), (4, 8, 8, 1000), (8, 100, 100, 64)]:
        S, chunk = tmx.gemm_splits(nb, M, N, K)
        assert chunk % 32 == 0 and S >= 1
        assert (S - 1) * chunk < K <= S * chunk
        assert (S, chunk) == tmx.gemm_splits(nb, M, N, K)


# --- the bf16 forms of B4, B6, B8b and B8c ----------------------------------

@pytest.mark.parametrize("nc,nt", [(2, 1), (4, 3)])
def test_gamma_v_bf16_form_matches_jax(nc, nt):
    """B4's bf16 form (on the CPU the plain block with its products through
    B10's plain version, ``Tr`` from its shadow, ``Tr'Tr`` of the shadow)
    against JAX ``update_gamma_v`` under ``scope`` and ``staged_scope``,
    the JAX draws injected; 1e-4 relative."""
    spec, data, states, spec_t = _gamma_v_model(nc, nt)
    pol_j = jprec.PrecisionPolicy(blocks=("GammaV",), staged=("Tr",))
    pol_t = tprec.PrecisionPolicy(blocks=("GammaV",), staged=("Tr",))
    keys = [jax.random.key(70 + c) for c in range(len(states))]
    with jmx.staged_scope(jprec.stage_data(data, pol_j)), \
            jmx.scope("bfloat16"):
        ref = [JU.update_gamma_v(spec, data, s, k)
               for s, k in zip(states, keys)]
    data_t, state_t = to_torch(spec, data, states)
    noise = _stack([gamma_v_noise(spec, k) for k in keys])
    staged = tprec.stage_data(data_t, pol_t)
    with tmx.staged_scope(staged), tmx.scope("bfloat16"):
        out = TU.update_gamma_v(spec_t, data_t, state_t, noise=noise)
    for f in ("iV", "Gamma"):
        np.testing.assert_allclose(
            getattr(out, f).numpy(),
            np.stack([np.asarray(getattr(r, f)) for r in ref]),
            rtol=1e-4, atol=1e-5, err_msg=f)
    f32 = TU.update_gamma_v(spec_t, data_t, state_t, noise=noise)
    assert not torch.allclose(f32.Gamma, out.Gamma, rtol=1e-6, atol=0)


@pytest.mark.parametrize("form", ["species", "row"])
def test_masked_gram_bf16_form_matches_jax(form):
    """B6's bf16 form (plain version) against the JAX package's masked mx
    einsums under a scope: per species ``XE' diag(m_j) XE`` and ``XE'
    (m_j Z_j)`` (``updaters.py:246-250, 278-279``), per row the factor
    gram with iSigma and ``(S iSigma m) lam'`` (``:618-623``); 1e-5 of the
    terms' magnitudes."""
    rng = np.random.default_rng(13)
    C, ny, ns, P = 2, 30, 9, 5
    mask = (rng.uniform(size=(ny, ns)) > 0.2).astype(np.float32)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    if form == "species":
        XE, Z = f32(C, ny, P), f32(C, ny, ns)
        args = (torch.tensor(XE), torch.tensor(mask.T),
                torch.tensor(Z).transpose(1, 2))
        with jmx.scope("bfloat16"):
            Gj = [jmx.einsum("ip,ij,iq->jpq", XE[c], mask, XE[c])
                  for c in range(C)]
            Rj = [jmx.einsum("ip,ij,ij->jp", XE[c], mask, Z[c])
                  for c in range(C)]
        mags_g = np.einsum("cip,ij,ciq->cjpq", np.abs(XE), mask, np.abs(XE))
        mags_r = np.einsum("cip,ij,cij->cjp", np.abs(XE), mask, np.abs(Z))
    else:
        lam, S = f32(C, P, ns), f32(C, ny, ns)
        isig = np.abs(f32(C, ns)) + 0.5
        args = (torch.tensor(lam).transpose(1, 2), torch.tensor(mask),
                torch.tensor(S), torch.tensor(isig))
        with jmx.scope("bfloat16"):
            Gj = [jmx.einsum("fj,gj,j,ij->ifg", lam[c], lam[c], isig[c],
                             mask) for c in range(C)]
            Rj = [jmx.matmul(S[c] * isig[c][None, :] * mask, lam[c].T)
                  for c in range(C)]
        mags_g = np.einsum("cfj,cgj,cj,ij->cifg", np.abs(lam), np.abs(lam),
                           isig, mask)
        mags_r = np.einsum("cij,cj,ij,cfj->cif", np.abs(S), isig, mask,
                           np.abs(lam))
    G, R = tgram.masked_gram(*args, bf16=True)
    for got, ref, mags in ((G, Gj, mags_g), (R, Rj, mags_r)):
        err = np.abs(got.numpy().astype(np.float64)
                     - np.stack([np.asarray(r) for r in ref]))
        # the terms' magnitudes of the rounded operands: within 2^-8 of
        # those of the float32 ones
        assert (err <= TERM_TOL * 1.01 * mags).all()
    G32, _ = tgram.masked_gram(*args)
    assert not torch.allclose(G32, G, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def nngp():
    return tspat._setup("NNGP")


def _staged_pair(b, names):
    pol_j = jprec.PrecisionPolicy(blocks=("EtaSpatial",), staged=names)
    pol_t = tprec.PrecisionPolicy(blocks=("EtaSpatial",), staged=names)
    return (jprec.stage_data(b["data_j"], pol_j),
            tprec.stage_data(b["data_t"], pol_t))


def test_nngp_dense_iw_bf16_form_matches_jax(nngp):
    """B8c's bf16-grid form (plain version: the staged coefficient and
    variance grids widened, iW and its gram in float32) against the JAX
    ``_nngp_dense_iW`` under ``scope`` and ``staged_scope``; 1e-5 of
    max |iW|."""
    b = nngp
    stj, stt = _staged_pair(b, ("nn_coef_0", "nn_D_0"))
    lvd_j, lvd_t = b["data_j"].levels[0], b["data_t"].levels[0]
    npr = b["spec_j"].levels[0].n_units
    alpha = b["state_t"].levels[0].alpha_idx
    with tmx.staged_scope(stt), tmx.scope("bfloat16"):
        got = TS._nngp_dense_iW(lvd_t, alpha, 0).numpy()
    with jmx.staged_scope(stj), jmx.scope("bfloat16"):
        ref = np.stack([np.asarray(JS._nngp_dense_iW(
            lvd_j, jnp.asarray(alpha[c].numpy()), npr, 0))
            for c in range(alpha.shape[0])])
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    f32 = TS._nngp_dense_iW(lvd_t, alpha, 0).numpy()
    assert np.abs(f32 - ref).max() > 1e-4 * np.abs(ref).max()


def test_nngp_quadratics_at_alpha_bf16_form_match_jax(nngp):
    """B8b's at-alpha bf16-grid form (plain version) against the JAX
    ``eta_quad_at`` and ``eta_ones_forms_at`` under a scope with the
    grids staged: the neighbours' eta rounded in the prediction,
    ``sqrt(D)`` in bfloat16; 1e-5 relative."""
    b = nngp
    stj, stt = _staged_pair(b, ("nn_coef_0", "nn_D_0"))
    lvd_j, lvd_t = b["data_j"].levels[0], b["data_t"].levels[0]
    ls_j, ls_t = b["spec_j"].levels[0], b["spec_t"].levels[0]
    lv = b["state_t"].levels[0]
    with tmx.staged_scope(stt), tmx.scope("bfloat16"):
        q = TS.eta_quad_at(lvd_t, ls_t, lv.Eta, lv.alpha_idx, 0)
        q1, s = TS.eta_ones_forms_at(lvd_t, ls_t, lv.Eta, lv.alpha_idx, 0)
    for c, sj in enumerate(b["states_j"]):
        lj = sj.levels[0]
        with jmx.staged_scope(stj), jmx.scope("bfloat16"):
            qj = JS.eta_quad_at(lvd_j, ls_j, lj.Eta, lj.alpha_idx, r=0)
            q1j, s_j = JS.eta_ones_forms_at(lvd_j, ls_j, lj.Eta,
                                            lj.alpha_idx, r=0)
        for got, ref in ((q[c], qj), (q1[c], q1j), (s[c], s_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6)


# --- one policy'd sweep against the JAX package's ---------------------------

def _port_staged(pol):
    """``pol`` staging what the port stages: not the float64 GPP knot
    grids (ROADMAP C4)."""
    keep = tuple(n for n in pol.staged
                 if n.rpartition("_")[0] not in tstructs._F64_FIELDS)
    return type(pol)(blocks=pol.blocks, staged=keep, dtype=pol.dtype,
                     batched_layouts=pol.batched_layouts)


def _jax_policy_sweep(spec, data, states, keys, c4_free=True):
    """The JAX package's policy'd sweep (its default policy, in-code
    selection; staging what the port stages unless ``c4_free`` is False)
    on each chain, compiled with excess precision off."""
    zeros = tuple(0 for _ in range(spec.nr))
    pol = jprec.default_policy(spec, ledger={})
    staged = jprec.stage_data(data, _port_staged(pol) if c4_free else pol)
    fn = jax.jit(jsweep.make_sweep(spec, None, zeros, precision=pol))
    comp = fn.lower(data, states[0], keys[0], staged).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return [comp(data, s, k, staged) for s, k in zip(states, keys)], pol


def _deviations(port, jax_states):
    """{tensor: (entries, p99, max)} of |port - JAX| / max|JAX|."""
    ref = {}
    for s in jax_states:
        for k, v in flatten(s).items():
            ref.setdefault(k, []).append(np.asarray(v))
    out = {}
    for k, vals in ref.items():
        if k in _SKIP:
            continue
        head, _, field = k.rpartition(".")
        obj = port.levels[int(head.split(".")[1])] if head else port
        j = np.stack(vals).astype(np.float64)
        p = getattr(obj, field).numpy().astype(np.float64)
        d = np.abs(p - j) / max(np.abs(j).max(), 1e-6)
        out[k] = (j.size, float(np.percentile(d, 99)), float(d.max()))
    return out


def _within(dev):
    n, p99, mx = dev
    return mx <= MAX_TOL and (n < SMALL or p99 <= P99_TOL)


@functools.lru_cache(maxsize=None)
def _sweep_case(kind):
    """(spec_j, data_j, states_j, spec_t, data_t, state_t, keys, noise) of
    one model kind, the JAX draws of one sweep stacked over chains (built
    once a module; nothing mutates them)."""
    if kind in ("probit", "na"):
        spec_j, data_j, states_j, spec_t, data_t, state_t, keys = \
            base_setup(kind, it=4)
        return (spec_j, data_j, states_j, spec_t, data_t, state_t, keys,
                _sweep_noise_stacked(spec_j, data_j, states_j, keys))
    if kind == "GPP":
        mj, mt = tgpp._models()
        spec_j, data_j, states_j = tgpp.jax_triple(mj, seeds=tgpp.SEEDS)
        states_j = [s.replace(it=jnp.asarray(4, jnp.int32), levels=(
            s.levels[0].replace(alpha_idx=jnp.asarray(a, jnp.int32)),))
            for s, a in zip(states_j, tgpp.ALPHA)]
        data_t, state_t = to_torch(spec_j, data_j, states_j)
        keys = [jax.random.key(300 + c) for c in range(len(states_j))]
        per = []
        for s, k in zip(states_j, keys):
            nz = tspat.spatial_sweep_noise(spec_j, data_j, s, k, dense=True)
            nz["EtaSpatial"] = [tgpp.gpp_eta_noise(
                spec_j, jax.random.fold_in(jax.random.split(k, 13)[4], 0))]
            per.append(nz)
        return (spec_j, data_j, states_j, tgpp.tstructs.build_spec(mt),
                data_t, state_t, keys,
                {n: _stack([p[n] for p in per]) for n in per[0]})
    b = tspat._setup("Full" if kind == "Full" else "NNGP")
    dense = kind != "NNGP-CG"
    per = [tspat.spatial_sweep_noise(b["spec_j"], b["data_j"], s, k, dense)
           for s, k in zip(b["states_j"], b["keys"])]
    return (b["spec_j"], b["data_j"], b["states_j"], b["spec_t"],
            b["data_t"], b["state_t"], b["keys"],
            {n: _stack([p[n] for p in per]) for n in per[0]})


@pytest.mark.parametrize("kind", ["probit", "na", "Full", "NNGP", "NNGP-CG",
                                  "GPP"])
def test_policy_sweep_matches_jax(kind, monkeypatch):
    """One sweep under the default policy (BetaLambda and GammaV without a
    spatial level, EtaSpatial and Interweave with one) from one state,
    every JAX draw injected, against the JAX package's policy'd sweep: per
    state tensor the 99th percentile of |port - JAX| / max|JAX| at most
    1e-4 and the maximum at most 1e-2 (fewer than 100 entries: the maximum
    alone; a rare bf16 rounding tie may flip one operand).  The port's
    float32 sweep from the same state and draws fails that bound, so the
    test tells the two streams apart."""
    if kind == "NNGP-CG":
        monkeypatch.setattr(JS, "_NNGP_DENSE_MAX", 0)
        monkeypatch.setattr(TS, "_NNGP_DENSE_MAX", 0)
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys, noise = \
        _sweep_case(kind)
    ref, pol_j = _jax_policy_sweep(spec_j, data_j, states_j, keys)
    pol = tprec.default_policy(spec_t, ledger={})
    assert pol.to_meta() == pol_j.to_meta()
    zeros = tuple(0 for _ in range(spec_t.nr))
    out = tsweep.make_sweep(spec_t, adapt_nf=zeros, precision=pol,
                            staged=tprec.stage_data(data_t, pol))(
        data_t, state_t, None, it=5, noise=noise)
    devs = _deviations(out, ref)
    bad = {k: d for k, d in devs.items() if not _within(d)}
    assert not bad, bad
    f32 = tsweep.make_sweep(spec_t, adapt_nf=zeros)(data_t, state_t, None,
                                                    it=5, noise=noise)
    assert any(not _within(d) for d in _deviations(f32, ref).values())


def test_policy_gpp_knot_grids_stay_unstaged():
    """ROADMAP C4: the JAX package's default policy rounds the GPP knot
    grids ``Fg`` and ``idDW12g`` to bfloat16, which leaves ``H = F - M'
    iA M`` indefinite on the test level at these alphas: its policy'd GPP
    Eta draw is NaN.  The port stages no float64 grid (C1's), so its draw
    is finite (and matches the JAX sweep that stages what the port does:
    ``test_policy_sweep_matches_jax[GPP]``)."""
    spec_j, data_j, states_j, spec_t, data_t, state_t, keys, noise = \
        _sweep_case("GPP")
    ref, _ = _jax_policy_sweep(spec_j, data_j, states_j, keys,
                               c4_free=False)
    assert np.isnan(np.stack([np.asarray(s.levels[0].Eta)
                              for s in ref])).any()
    pol = tprec.default_policy(spec_t, ledger={})
    staged = tprec.stage_data(data_t, pol)
    assert set(staged) == {"idDg_0", "X"}
    out = tsweep.make_sweep(spec_t, adapt_nf=(0,), precision=pol,
                            staged=staged)(data_t, state_t, None, it=5,
                                           noise=noise)
    assert all(torch.isfinite(t).all() for t in out.float_tensors())


@pytest.mark.parametrize("kind", ["probit", "Full"])
def test_none_and_layout_only_policies_are_the_exact_engine(kind):
    """``precision=None`` and a layout-only policy (``dtype="float32"``)
    give the same bits in the port."""
    _, _, _, spec_t, data_t, state_t, _, noise = _sweep_case(kind)
    zeros = tuple(0 for _ in range(spec_t.nr))
    blocks = tprec.default_policy(spec_t, ledger={}).blocks
    lay = tprec.PrecisionPolicy(blocks=blocks, dtype="float32")
    a = tsweep.make_sweep(spec_t, adapt_nf=zeros)(data_t, state_t, None,
                                                  it=5, noise=noise)
    b = tsweep.make_sweep(spec_t, adapt_nf=zeros, precision=lay,
                          staged=tprec.stage_data(data_t, lay))(
        data_t, state_t, None, it=5, noise=noise)
    assert tprec.stage_data(data_t, lay) == {}
    for ta, tb in zip(a.float_tensors(), b.float_tensors()):
        assert torch.equal(ta, tb)


# --- the API ----------------------------------------------------------------

def test_sample_mcmc_auto_runs_and_records_the_policy():
    """``precision_policy="auto"`` (and its ``to_meta()`` dict) runs on the
    CPU, draws finite values and records the policy in the Posterior;
    ``None`` records none."""
    _, hM = make_models("probit")
    kw = dict(samples=3, transient=2, n_chains=2, seed=1, device="cpu")
    post = hmsc_tpu_torch.sample_mcmc(hM, precision_policy="auto", **kw)
    assert np.isfinite(post["Beta"]).all()
    assert post.precision_policy == {
        "blocks": ["BetaLambda", "GammaV"],
        "staged": ["U", "Qeig", "UTr", "X", "Tr"], "dtype": "bfloat16",
        "batched_layouts": True}
    again = hmsc_tpu_torch.sample_mcmc(
        hM, precision_policy=post.precision_policy, **kw)
    np.testing.assert_array_equal(again["Beta"], post["Beta"])
    exact = hmsc_tpu_torch.sample_mcmc(hM, **kw)
    assert exact.precision_policy is None
    assert not np.array_equal(exact["Beta"], post["Beta"])


@pytest.mark.parametrize("kind", ["probit", "Full", "NNGP", "GPP"])
def test_default_policy_and_ledger_copy_match_jax(kind):
    """The port's ``default_policy`` (from its copy of the cost ledger's
    selection) equals the JAX package's (from the ledger itself), and the
    copy equals ``hmsc_tpu/obs/cost_ledger.json``'s ``precision``
    section."""
    spec_j, _, _, spec_t, *_ = _sweep_case(kind)
    assert (tprec.default_policy(spec_t).to_meta()
            == jprec.default_policy(spec_j).to_meta())
    ledger = json.loads((REPO / "hmsc_tpu/obs/cost_ledger.json").read_text())
    assert tprec.load_ledger()["precision"] == ledger["precision"]
    assert tprec.load_tolerance() == jprec.load_tolerance()
    assert tprec.PRECISION_AGREEMENT_TOL == jprec.PRECISION_AGREEMENT_TOL
    assert tprec.SUPPORTED_BLOCKS == jprec.SUPPORTED_BLOCKS


@pytest.mark.parametrize("blocks,item", [(["Alpha"], "A9.2b"),
                                         (["Rho"], "A5"),
                                         (["GammaV", "wRRR"], "A7")])
def test_unported_blocks_raise(blocks, item):
    _, hM = make_models("probit")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        hmsc_tpu_torch.sample_mcmc(hM, samples=1, device="cpu",
                                   precision_policy={"blocks": blocks})


def test_invalid_policies_raise_value_error():
    """As ``tests/test_precision.py``'s validation: an unknown block, a
    dtype other than bfloat16 / float32, an unknown string or type."""
    with pytest.raises(ValueError, match="no mixed-precision"):
        tprec.PrecisionPolicy(blocks=("NotABlock",))
    with pytest.raises(ValueError, match="dtype"):
        tprec.PrecisionPolicy(blocks=("GammaV",), dtype="float16")
    _, hM = make_models("probit")
    for bad in ("bogus", 3):
        with pytest.raises(ValueError, match="precision_policy"):
            hmsc_tpu_torch.sample_mcmc(hM, samples=1, device="cpu",
                                       precision_policy=bad)
    pol = tprec.PrecisionPolicy(blocks=("GammaV", "Eta"), staged=("X",),
                                batched_layouts=False)
    assert tprec.PrecisionPolicy.from_meta(pol.to_meta()) == pol
