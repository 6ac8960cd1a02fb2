"""The port's host layer against the JAX package's: the same small models
built by both ``Hmsc`` classes give equal specs, equal model data and equal
initial states (after float32 conversion).  Also home of the builders the
other ``test_torch_*`` files share: small models and the flattening of the
JAX package's structures into the numpy dicts that
``hmsc_tpu_torch.mcmc.structs.data_from_numpy`` / ``state_from_numpy``
take."""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

import hmsc_tpu
from hmsc_tpu.mcmc import structs as jstructs
from hmsc_tpu.precompute import compute_data_parameters as j_cdp

import hmsc_tpu_torch
from hmsc_tpu_torch.mcmc import structs as tstructs
from hmsc_tpu_torch.precompute import compute_data_parameters as t_cdp
from hmsc_tpu_torch.utils.mesh import Mesh

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


# the column families of the "mixed" and "na" kinds, cycled over species
MIXED = ("normal", "probit", "lognormal poisson", "poisson")


def model_inputs(kind="probit", ny=30, ns=5, n_units=None, seed=0,
                 levels=1):
    """Numpy inputs for both packages' ``Hmsc``: ``kind`` is "probit" (raw
    [1, x] design, intercept found by value), "normal" (a pandas frame
    and formula with a named intercept, scaled X, traits), "mixed" (the
    families of ``MIXED`` cycled over the species, counts up to ~150) or
    "na" (mixed, with 15% of Y's cells missing, at least one in each
    column); ``n_units`` groups the rows into fewer units; ``levels=2`` adds
    a second random level of 5 plots."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(ny)
    X = np.column_stack([np.ones(ny), x])
    L = X @ (rng.standard_normal((2, ns)) * 0.6) \
        + rng.standard_normal((ny, 2)) @ rng.standard_normal((2, ns)) * 0.5
    n_units = n_units or ny
    units = np.array([f"u{i % n_units:03d}" for i in range(ny)])
    design = [units, np.array([f"p{i % 5}" for i in range(ny)])][:levels]
    kw = dict(study_design=np.stack(design, axis=1))
    if kind == "normal":
        Y = L + rng.standard_normal((ny, ns))
        kw.update(x_data=pd.DataFrame({"x": x}), x_formula="~x",
                  distr="normal",
                  Tr=np.column_stack([np.ones(ns), rng.standard_normal(ns)]))
    elif kind in ("mixed", "na"):
        Zl = L + rng.standard_normal((ny, ns))
        distr = [MIXED[j % len(MIXED)] for j in range(ns)]
        fam = np.array([{"normal": 1, "probit": 2}.get(d, 3) for d in distr])
        Y = np.where(fam == 1, Zl, (Zl > 0).astype(float))
        Y = np.where(fam == 3, rng.poisson(np.exp(np.clip(2 * Zl, -8, 5))),
                     Y)
        if kind == "na":
            miss = rng.uniform(size=(ny, ns)) < 0.15
            miss[rng.integers(ny, size=ns), np.arange(ns)] = True
            Y = np.where(miss, np.nan, Y)
        kw.update(X=X, distr=distr, x_scale=False)
    else:
        Y = (L + rng.standard_normal((ny, ns)) > 0).astype(float)
        kw.update(X=X, distr="probit", x_scale=False)
    return Y, kw, [sorted(set(col)) for col in design]


def make_models(kind="probit", nf=3, **kw):
    """The same model built by both packages: (jax_model, torch_model)."""
    Y, hkw, units = model_inputs(kind, **kw)
    out = []
    for pkg in (hmsc_tpu, hmsc_tpu_torch):
        rls = {}
        for name, u in zip(("unit", "plot"), units):
            rls[name] = pkg.HmscRandomLevel(units=u)
            pkg.set_priors_random_level(rls[name], nf_max=nf, nf_min=2)
        out.append(pkg.Hmsc(Y=Y, ran_levels=rls, **hkw))
    return tuple(out)


def jax_triple(hM, seeds=(0,), nf_cap=16):
    """(spec, data, [chain states]) from the JAX package."""
    spec = jstructs.build_spec(hM, nf_cap)
    data = jstructs.build_model_data(hM, j_cdp(hM), spec)
    return spec, data, [jstructs.build_state(hM, spec, s) for s in seeds]


def flatten(obj) -> dict:
    """A JAX ModelData / GibbsState as numpy arrays keyed by field name,
    per-level fields as ``levels.<r>.<field>``."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "levels":
            for r, lv in enumerate(v):
                for g in dataclasses.fields(lv):
                    a = getattr(lv, g.name)
                    if a is not None:
                        out[f"levels.{r}.{g.name}"] = np.asarray(a)
        elif v is None or isinstance(v, tuple) or f.name == "tenant":
            continue
        else:
            out[f.name] = np.asarray(v)
    return out


def flatten_states(states) -> dict:
    """JAX chain states stacked along a new leading chain axis."""
    flat = [flatten(s) for s in states]
    return {k: np.stack([f[k] for f in flat]) for k in flat[0]}


def to_torch(spec_j, data_j, states_j):
    data = tstructs.data_from_numpy(flatten(data_j), "cpu")
    state = tstructs.state_from_numpy(flatten_states(states_j), "cpu")
    return data, state


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["probit", "normal", "probit_units",
                                  "mixed", "na"])
def test_spec_data_state_match_jax(kind):
    kw = {"n_units": 10} if kind == "probit_units" else {}
    mj, mt = make_models("probit" if kind == "probit_units" else kind, **kw)
    spec_j, data_j, (state_j,) = jax_triple(mj, seeds=(7,))
    spec_t = tstructs.build_spec(mt)
    assert dataclasses.asdict(spec_t) == dataclasses.asdict(spec_j)

    data_t = tstructs.build_model_data(mt, t_cdp(mt), spec_t, "cpu")
    flat = flatten(data_j)
    for f in dataclasses.fields(data_t):
        v = getattr(data_t, f.name)
        if f.name == "levels":
            for r, lv in enumerate(v):
                for g in dataclasses.fields(lv):
                    if getattr(lv, g.name) is None:
                        # a spatial field on a non-spatial level: None in
                        # the JAX package's LevelData as well
                        assert f"levels.{r}.{g.name}" not in flat, g.name
                        continue
                    np.testing.assert_array_equal(
                        getattr(lv, g.name).numpy(),
                        flat[f"levels.{r}.{g.name}"], err_msg=g.name)
        elif f.name in ("x_intercept_ind", "tr_intercept_ind", "x_ones_ind"):
            ref = getattr(data_j, f.name)
            assert v == (None if ref is None else int(ref)), f.name
        elif f.name in ("TtT", "iUGmG"):
            # the GammaV block's constants, formed from the JAX fields
            Tr, iU, mG = (flat[k].astype(np.float32)
                          for k in ("Tr", "iUGamma", "mGamma"))
            ref = Tr.T @ Tr if f.name == "TtT" else iU @ mG
            np.testing.assert_allclose(v.numpy(), ref, rtol=1e-6,
                                       atol=1e-6, err_msg=f.name)
        else:
            np.testing.assert_array_equal(v.numpy(), flat[f.name],
                                          err_msg=f.name)
    # the location interweave's shiftable column must be found either way
    assert data_t.x_ones_ind == 0

    state_t = tstructs.build_state(mt, spec_t, 7, "cpu")
    for k, ref in flatten(state_j).items():
        if k in ("BetaSel", "wRRR", "PsiRRR", "DeltaRRR"):
            continue
        head, _, field = k.rpartition(".")
        obj = state_t
        if head:
            obj = state_t.levels[int(head.split(".")[1])]
        np.testing.assert_array_equal(getattr(obj, field).numpy()[0], ref,
                                      err_msg=k)


def test_numpy_roundtrip_of_jax_structures():
    mj, _ = make_models("probit")
    spec_j, data_j, states_j = jax_triple(mj, seeds=(1, 2))
    data, state = to_torch(spec_j, data_j, states_j)
    assert state.n_chains == 2 and state.Z.shape == (2, spec_j.ny, spec_j.ns)
    np.testing.assert_array_equal(state.levels[0].Lambda[1].numpy(),
                                  np.asarray(states_j[1].levels[0].Lambda))
    assert data.levels[0].pi_row.dtype == torch.int64
    assert data.x_ones_ind == int(data_j.x_ones_ind)


def _model_with(case):
    Y, kw, (units,) = model_inputs("probit")
    rl = hmsc_tpu_torch.HmscRandomLevel(units=units)
    hkw = dict(Y=Y, ran_levels={"unit": rl}, **kw)
    if case == "poisson":
        hkw["distr"] = "poisson"
    elif case == "na":
        Y = Y.copy()
        Y[0, 0] = np.nan
        hkw["Y"] = Y
    elif case == "phylo":
        hkw["C"] = np.eye(Y.shape[1])
    elif case in ("spatial", "gpp"):
        # a GPP level (in the port); "spatial" adds a phylogeny, which is
        # not (ROADMAP A5)
        g = np.random.default_rng(0)
        xy = pd.DataFrame(g.uniform(size=(len(units), 2)), index=units)
        hkw["ran_levels"] = {"unit": hmsc_tpu_torch.HmscRandomLevel(
            s_data=xy, s_method="GPP", s_knot=g.uniform(size=(4, 2)))}
        if case == "spatial":
            hkw["C"] = np.eye(Y.shape[1])
    elif case == "x_dim":
        xd = pd.DataFrame(np.ones((len(units), 2)), index=units)
        hkw["ran_levels"] = {"unit": hmsc_tpu_torch.HmscRandomLevel(
            x_data=xd)}
    elif case == "x_list":
        hkw["X"] = [kw["X"]] * Y.shape[1]
    return hmsc_tpu_torch.Hmsc(**hkw)


@pytest.mark.parametrize("case", ["phylo", "spatial", "x_dim", "x_list"])
def test_features_outside_the_slice_raise(case):
    """Each feature of a later slice is refused by name; a GPP model is in
    the slice, so with a phylogeny it is the phylogeny that is named."""
    hM = _model_with(case)
    match = "phylogeny" if case == "spatial" else "ROADMAP A"
    with pytest.raises(NotImplementedError, match=match):
        hmsc_tpu_torch.sample_mcmc(hM, samples=1, device="cpu")


@pytest.mark.parametrize("arg", [{"precision_policy": {"blocks": ["Alpha"]}},
                                 # a mesh runs the site axis only (A9.3)
                                 {"mesh": Mesh(species_shards=2)},
                                 {"checkpoint_every": 5},
                                 {"updater": {"Gamma2": True}}])
def test_options_outside_the_slice_raise(arg):
    _, hM = make_models("probit")
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        hmsc_tpu_torch.sample_mcmc(hM, samples=1, device="cpu", **arg)


@pytest.mark.parametrize("case", ["poisson", "na", "gpp"])
def test_poisson_and_na_models_sample(case):
    """Poisson responses, missing values in Y and GPP levels are in the
    slice: the sampler runs them on the CPU when asked, and without a card
    it refuses to run them anywhere else."""
    hM = _model_with(case)
    post = hmsc_tpu_torch.sample_mcmc(hM, samples=2, transient=1,
                                      n_chains=1, seed=0, device="cpu")
    assert np.isfinite(post["Beta"]).all()
    assert post.chain_health["good_chains"].all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hmsc_tpu_torch.sample_mcmc(hM, samples=1)
