"""The port's offline prediction against the JAX package's on the CPU: the
same posterior draws (made with numpy, carried into both packages'
``Posterior`` — the port's through ``posterior_from_numpy``) give the same
``predict(expected=True)`` at training units, at new units (mean-field and
spatial kriging with a seeded generator), over a constructed gradient, and
through the serving engine's gradient query; ``construct_gradient`` and
``prepare_gradient`` build the same designs."""

import numpy as np
import pandas as pd
import pytest
import torch

import hmsc_tpu
from hmsc_tpu.mcmc import structs as jstructs
from hmsc_tpu.predict.gradient import prepare_gradient as jax_prepare

import hmsc_tpu_torch as ht
from hmsc_tpu_torch.post import posterior_from_numpy
from hmsc_tpu_torch.predict import prepare_gradient

from test_torch_model import make_models

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

CHAINS, SAMPLES, NF = 2, 4, 2


def draws(hM, seed, n_alpha=1):
    """Posterior arrays (chains, samples, ...) shaped for ``hM``."""
    rng = np.random.default_rng(seed)
    shp = (CHAINS, SAMPLES)
    a = {"Beta": 0.7 * rng.standard_normal(shp + (hM.nc, hM.ns)),
         "sigma": rng.uniform(0.3, 1.2, shp + (hM.ns,))}
    for r in range(hM.nr):
        a[f"Eta_{r}"] = rng.standard_normal(shp + (int(hM.np_[r]), NF))
        a[f"Lambda_{r}"] = 0.5 * rng.standard_normal(shp + (NF, hM.ns, 1))
        a[f"Alpha_{r}"] = rng.integers(0, n_alpha, shp + (NF,))
    return {k: (v.astype(np.float32) if v.dtype.kind == "f" else
                v.astype(np.int32)) for k, v in a.items()}


def posteriors(mj, mt, seed, n_alpha=1):
    """(JAX Posterior, port Posterior) over the same draws."""
    arrays = draws(mj, seed, n_alpha)
    pj = hmsc_tpu.post.Posterior(mj, jstructs.build_spec(mj, NF), arrays,
                                 samples=SAMPLES, transient=0, thin=1)
    pt = posterior_from_numpy(mt, pj.arrays, samples=SAMPLES, transient=0,
                              thin=1)
    return pj, pt


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind,levels", [("probit", 2), ("mixed", 1)])
def test_predict_matches_jax_at_training_units(kind, levels):
    mj, mt = make_models(kind, ny=30, ns=6, nf=NF, n_units=8, seed=5,
                         levels=levels)
    pj, pt = posteriors(mj, mt, 1)
    want = hmsc_tpu.predict(pj, expected=True)
    got = ht.predict(pt, expected=True, device="cpu")
    assert got.shape == want.shape == (CHAINS * SAMPLES, 30, 6)
    close(got, want)


def test_predict_matches_jax_at_new_units_with_eta_mean():
    mj, mt = make_models("probit", ny=30, ns=6, nf=NF, n_units=8, seed=6)
    pj, pt = posteriors(mj, mt, 2)
    study = np.array([["u000"], ["new_a"], ["u003"], ["new_b"]])
    X = np.column_stack([np.ones(4), np.linspace(-1, 1, 4)])
    kw = dict(X=X, study_design=study, predict_eta_mean=True, expected=True)
    want = hmsc_tpu.predict(pj, study_design=pd.DataFrame(
        {"unit": study[:, 0]}), **{k: v for k, v in kw.items()
                                   if k != "study_design"})
    got = ht.predict(pt, device="cpu", **kw)
    close(got, want)


@pytest.mark.parametrize("method", ["Full", "NNGP", "GPP"])
def test_predict_kriges_new_spatial_units_like_jax(method):
    """New spatial units through ``prepare_gradient``: the latent factors
    kriged from the same seeded generator, then B9a's expected draws."""
    rng = np.random.default_rng(12)
    ny, ns, n_units = 24, 4, 8
    xy = rng.uniform(size=(n_units, 2))
    names = [f"s{i}" for i in range(n_units)]
    study = np.array([names[i % n_units] for i in range(ny)])
    xdf = pd.DataFrame({"x": rng.standard_normal(ny)})
    Y = (rng.standard_normal((ny, ns)) > 0).astype(float)
    models = []
    for pkg in (hmsc_tpu, ht):
        kw = dict(s_data=pd.DataFrame(xy, index=names), s_method=method)
        if method == "NNGP":
            kw["n_neighbours"] = 4
        if method == "GPP":
            kw["s_knot"] = xy[:4]
        rl = pkg.HmscRandomLevel(**kw)
        pkg.set_priors_random_level(rl, nf_max=NF, nf_min=NF)
        models.append(pkg.Hmsc(Y=Y, x_data=xdf, x_formula="~x",
                               distr="probit",
                               study_design=pd.DataFrame({"site": study}),
                               ran_levels={"site": rl}))
    mj, mt = models
    pj, pt = posteriors(mj, mt, 3, n_alpha=mj.ranLevels[0].alphapw.shape[0])
    xnew = pd.DataFrame({"x": [-0.5, 0.0, 0.7]})
    snew = {"site": rng.uniform(size=(3, 2))}
    gj = jax_prepare(mj, xnew, snew)
    gt = prepare_gradient(mt, xnew, snew)
    assert list(gt["studyDesignNew"]["site"]) == list(
        gj["studyDesignNew"]["site"])
    want = hmsc_tpu.predict(pj, gradient=gj, expected=True, seed=4)
    got = ht.predict(pt, gradient=gt, expected=True, seed=4, device="cpu")
    close(got, want)


def test_construct_gradient_and_gradient_predictions_match_jax():
    mj, mt = make_models("normal", ny=30, ns=5, nf=NF, n_units=6, seed=7)
    gj = hmsc_tpu.construct_gradient(mj, "x", ngrid=7)
    gt = ht.construct_gradient(mt, "x", ngrid=7)
    pd.testing.assert_frame_equal(gt["XDataNew"], gj["XDataNew"])
    pd.testing.assert_frame_equal(gt["studyDesignNew"], gj["studyDesignNew"])
    assert list(gt["rLNew"]["unit"].pi) == list(gj["rLNew"]["unit"].pi)
    pj, pt = posteriors(mj, mt, 4)
    want = hmsc_tpu.predict(pj, gradient=gj, expected=True,
                            predict_eta_mean=True)
    got = ht.predict(pt, gradient=gt, expected=True, predict_eta_mean=True,
                     device="cpu")
    close(got, want)
    with ht.ServingEngine(pt, coalesce_ms=0.5, device="cpu") as eng:
        served = eng.gradient("x", ngrid=7)
    np.testing.assert_array_equal(served["grid"], gt["XDataNew"]["x"])
    close(served["mean"], want.mean(axis=0))


def test_sampled_predict_and_what_raises():
    mj, mt = make_models("mixed", ny=30, ns=6, nf=NF, n_units=8, seed=8)
    _, pt = posteriors(mj, mt, 5)
    a = ht.predict(pt, seed=3, device="cpu")
    b = ht.predict(pt, seed=3, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.shape == (CHAINS * SAMPLES, 30, 6)
    fam = mt.distr[:, 0]
    m, s = mt.y_scale_par
    y = (a - m) / s
    assert set(np.unique(y[..., fam == 2])) <= {0.0, 1.0}
    assert np.allclose(y[..., fam == 3], np.round(y[..., fam == 3]),
                       atol=1e-4)
    Yc = np.full((30, 6), np.nan)
    ht.predict(pt, Yc=Yc, expected=True, device="cpu")   # nothing observed
    Yc[0, 0] = 1.0
    with pytest.raises(NotImplementedError, match="A8b"):
        ht.predict(pt, Yc=Yc, device="cpu")
    with pytest.raises(ValueError, match="Yc"):
        ht.predict(pt, Yc=Yc[:, :3], device="cpu")


def test_predict_without_a_device_raises_on_a_box_without_a_card():
    from hmsc_tpu_torch.mcmc.sampler import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    mj, mt = make_models("probit", ny=10, ns=3, nf=NF, n_units=4, seed=9)
    _, pt = posteriors(mj, mt, 6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ht.predict(pt, expected=True)
