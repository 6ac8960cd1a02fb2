"""Posterior-predictive distribution at new covariates / units (port of
``hmsc_tpu/predict/predict.py``; reference ``R/predict.R:55-232``).

The whole posterior is one stacked (n_draws, ...) batch: the latent
factors at the prediction units come from :func:`predict_latent_factor`
(numpy, every spatial method), and the linear predictor, the link, the
response sampling and the back-scaling are one launch of the serving
kernel B9a (:func:`hmsc_tpu_torch.ops.serve.serve_predict`, draws mode) per
block of up to ``OFFLINE_CHUNK`` rows, so offline and served predictions
come from the same kernel.

Conditional prediction (``Yc``) with the spatial priors over the
prediction units is ROADMAP A8b; per-species designs, the reduced-rank
term and covariate-dependent levels raise, naming their ROADMAP items.
``predict.R:174,192`` uses ``object$ny`` where the new-data row count
belongs; the new row count is used here, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mcmc.sampler import resolve_device
from ..ops.serve import serve_predict
from ..utils.formula import align_factor_levels, design_matrix
from .latent import predict_latent_factor

__all__ = ["predict", "OFFLINE_CHUNK"]

# query rows per B9a launch: the serving engine's largest bucket
OFFLINE_CHUNK = 64


def _new_design(hM, x_data, X):
    """Resolve the prediction design matrix like the reference's
    model.matrix-with-pinned-xlev step (``predict.R:76-90``)."""
    if x_data is not None and X is not None:
        raise ValueError("Hmsc.predict: only one of XData and X arguments can be specified")
    if x_data is not None:
        # pin the training frame's factor levels (R's xlev)
        ref = hM.x_data
        if isinstance(x_data, (list, tuple)):
            refs = (ref if isinstance(ref, (list, tuple))
                    else [ref] * len(x_data))
            mats = [design_matrix(hM.x_formula,
                                  align_factor_levels(df, rf))[0]
                    for df, rf in zip(x_data, refs)]
            return np.stack(mats, axis=0), True
        M, _ = design_matrix(
            hM.x_formula,
            align_factor_levels(x_data,
                                ref[0] if isinstance(ref, (list, tuple))
                                else ref))
        return M, False
    if X is not None:
        X = np.asarray(X, dtype=float)
        return X, X.ndim == 3
    return hM.X, hM.x_is_list


def predict(post, x_data=None, X=None, xrrr_data=None, XRRR=None,
            study_design=None, ran_levels=None, gradient=None, Yc=None,
            mcmc_step: int = 1, expected: bool = False,
            predict_eta_mean: bool = False, predict_eta_mean_field: bool = False,
            seed: int | None = None, device=None) -> np.ndarray:
    """Posterior-predictive draws; returns (n_draws, ny_new, ns) float32.

    ``post`` is the :class:`~hmsc_tpu_torch.post.Posterior` (all pooled
    draws are used).  With ``expected=True`` each observation model's
    location is returned instead of sampled responses.  ``device=None``
    runs on the card and raises without one; ``device="cpu"`` runs the
    kernel's plain version."""
    hM, spec = post.hM, post.spec
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    if gradient is not None:
        x_data = gradient["XDataNew"]
        study_design = gradient["studyDesignNew"]
        ran_levels = gradient["rLNew"]
    if xrrr_data is not None and XRRR is not None:
        raise ValueError("Hmsc.predict: only one of XRRRData and XRRR arguments can be specified")
    if predict_eta_mean and predict_eta_mean_field:
        raise ValueError("Hmsc.predict: predictEtaMean and predictEtaMeanField arguments cannot be TRUE simultanuisly")
    if hM.nc_rrr > 0:
        raise NotImplementedError("predict: reduced-rank regression is not "
                                  "ported yet (ROADMAP A7)")
    if any(ls.x_dim > 0 for ls in spec.levels):
        raise NotImplementedError("predict: covariate-dependent random "
                                  "levels (x_dim > 0) are not ported yet "
                                  "(ROADMAP A5)")

    Xn, x_is_list = _new_design(hM, x_data, X)
    if x_is_list:
        raise NotImplementedError("predict: per-species X lists are not "
                                  "ported yet (ROADMAP A5)")
    ny_new = Xn.shape[0]

    if Yc is not None:
        Yc = np.asarray(Yc, dtype=float)
        if Yc.shape[1] != hM.ns:
            raise ValueError("hMsc.predict: number of columns in Yc must be equal to ns")
        if Yc.shape[0] != ny_new:
            raise ValueError("hMsc.predict: number of rows in Yc and X must be equal")
        if not np.all(np.isnan(Yc)):
            raise NotImplementedError(
                "predict(Yc=...): offline conditional prediction with the "
                "spatial priors over the prediction units is not ported yet "
                "(ROADMAP A8b); the serving engine answers conditional "
                "queries (ServingEngine.predict(Yc=...))")

    # ---- study design -> per-level unit labels ---------------------------
    if ran_levels is None:
        ran_levels = {hM.rl_names[r]: hM.ranLevels[r] for r in range(hM.nr)}
    if study_design is None:
        labels = hM.df_pi                               # training labels
    else:
        cols = ([str(c) for c in study_design.columns]
                if hasattr(study_design, "columns") else None)
        if cols is not None and any(n not in cols for n in hM.rl_names):
            raise ValueError("hMsc.predict: dfPiNew does not contain all the necessary named columns")
        labels = []
        for r, name in enumerate(hM.rl_names):
            col = (study_design[name] if cols is not None
                   else np.asarray(study_design)[:, r])
            labels.append([str(v) for v in np.asarray(col)])
    if any(n not in ran_levels for n in hM.rl_names):
        raise ValueError("hMsc.predict: rL does not contain all the necessary named levels")

    # ---- latent factors at the prediction units --------------------------
    etas, pis = [], []
    for r in range(hM.nr):
        rL = ran_levels[hM.rl_names[r]]
        units_pred = sorted(set(labels[r]))
        ep = predict_latent_factor(units_pred, hM.pi_names[r],
                                   post.pooled(f"Eta_{r}"),
                                   post.pooled(f"Alpha_{r}"), rL,
                                   predict_mean=predict_eta_mean,
                                   predict_mean_field=predict_eta_mean_field,
                                   rng=rng)
        lut = {u: i for i, u in enumerate(units_pred)}
        etas.append(ep)
        pis.append(np.array([lut[v] for v in labels[r]], dtype=np.int32))

    # ---- linear predictor, link, back-scaling: B9a, draws mode -----------
    def stage(a):
        return torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.float32)).to(dev)

    Beta = stage(post.pooled("Beta"))
    sigma = stage(post.pooled("sigma"))
    lams = []
    for r in range(hM.nr):
        lam = post.pooled(f"Lambda_{r}")
        lams.append(stage(lam[..., 0] if lam.ndim == 4 else lam))
    etas = [stage(e) for e in etas]
    fam = torch.from_numpy(np.asarray(hM.distr[:, 0], dtype=np.int32)).to(dev)
    m, s = hM.y_scale_par
    ym, ys = stage(m), stage(s)
    Xd = stage(Xn)
    uidx = torch.from_numpy(np.stack(pis) if pis else
                            np.zeros((0, ny_new), np.int32)).to(dev)
    out = np.empty((Beta.shape[0], ny_new, hM.ns), dtype=np.float32)
    for c0 in range(0, ny_new, OFFLINE_CHUNK):
        c1 = min(ny_new, c0 + OFFLINE_CHUNK)
        _, _, y = serve_predict(
            Xd[c0:c1].contiguous(), uidx[:, c0:c1].contiguous(), Beta,
            sigma, lams, etas, fam, ym, ys, expected=bool(expected),
            moments=False, draws=True,
            seed=int(rng.integers(0, 2**31 - 1)))
        out[:, c0:c1] = y.cpu().numpy()
    return out
