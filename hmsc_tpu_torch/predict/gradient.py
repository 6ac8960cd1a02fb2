"""Environmental-gradient construction for prediction (reference
``R/constructGradient.R:39-216``, ``R/prepareGradient.R:31-66``).

``construct_gradient`` builds a prediction design where a focal variable
sweeps a grid and every non-focal variable is set by one of three policies
(matching the reference's ``non.focalVariables`` codes):

1. most-likely value (mode for factors, mean for numeric),
2. value predicted from a regression on the focal variable (default; linear
   regression for numeric, multinomial logistic for factors),
3. a fixed user-given value.

A single ``new_unit`` is appended to every random level (centroid coordinates
for coordinate-based levels, a near-medoid pseudo-distance row for
distance-matrix levels) — reference ``constructGradient.R:180-212``.
The reference's ``sprintf('new_unit', 1:ngrid)`` yields the *same* unit name
for every gradient point (one shared new unit); that behavior is kept
deliberately.

A copy of ``hmsc_tpu/predict/gradient.py``; pandas is imported where a
function needs it, so the package imports without it.
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["construct_gradient", "prepare_gradient"]


def _formula_vars(formula: str, df) -> list[str]:
    """Data-frame columns referenced by the formula (R's ``all.vars``).
    A ``.`` term anywhere in the RHS pulls in every column."""
    rhs = formula.split("~", 1)[-1]
    toks = set(re.findall(r"[A-Za-z_.][\w.]*", rhs))
    has_dot = bool(re.search(r"(^|[^\w.])\.($|[^\w.])", rhs.strip()))
    return [str(c) for c in df.columns if str(c) in toks or has_dot]


def _mode(values) -> object:
    vals, counts = np.unique(np.asarray(values), return_counts=True)
    return vals[np.argmax(counts)]


def _multinom_predict(y_labels, x, x_new):
    """Most-probable class from a small multinomial-logistic fit of a factor
    on the focal variable (reference uses ``nnet::multinom``,
    ``constructGradient.R:146-148``)."""
    classes = sorted(set(map(str, y_labels)))
    K = len(classes)
    if K == 1:
        return np.array([classes[0]] * len(x_new))
    Yi = np.array([classes.index(str(v)) for v in y_labels])
    X = np.column_stack([np.ones(len(x)), np.asarray(x, dtype=float)])
    W = np.zeros((2, K))
    Y1h = np.eye(K)[Yi]
    for _ in range(200):                      # tiny IRLS-flavoured GD
        P = np.exp(X @ W - (X @ W).max(axis=1, keepdims=True))
        P /= P.sum(axis=1, keepdims=True)
        g = X.T @ (P - Y1h) / len(x)
        W -= 1.0 * g
    Xn = np.column_stack([np.ones(len(x_new)), np.asarray(x_new, dtype=float)])
    return np.array([classes[i] for i in (Xn @ W).argmax(axis=1)])


def construct_gradient(hM, focal_variable: str, non_focal_variables=None,
                       ngrid: int = 20) -> dict:
    """Returns ``{"XDataNew", "studyDesignNew", "rLNew"}`` for ``predict``."""
    import pandas as pd

    from ..random_level import HmscRandomLevel, set_priors_random_level

    non_focal_variables = dict(non_focal_variables or {})
    if hM.x_data is None or isinstance(hM.x_data, (list, tuple)):
        xdf = hM.x_data[0] if isinstance(hM.x_data, (list, tuple)) else None
        if xdf is None:
            raise ValueError("constructGradient requires the model to be built from XData + XFormula")
    else:
        xdf = hM.x_data
    vars_ = _formula_vars(hM.x_formula, xdf)
    if focal_variable not in vars_:
        raise ValueError(f"constructGradient: focal variable {focal_variable!r} not among formula variables {vars_}")

    v_focal = xdf[focal_variable]
    is_factor = np.asarray(v_focal).dtype.kind in "OUSb"
    if is_factor:
        xx = sorted(set(map(str, np.asarray(v_focal))))
        ngrid = len(xx)
    else:
        v = np.asarray(v_focal, dtype=float)
        xx = np.linspace(v.min(), v.max(), ngrid)
    x_new = pd.DataFrame({focal_variable: xx})

    for var in vars_:
        if var == focal_variable:
            continue
        spec = non_focal_variables.get(var)
        type_ = int(spec[0]) if spec is not None else 2
        val = spec[1] if (spec is not None and len(spec) > 1) else None
        col = xdf[var]
        f_nf = np.asarray(col).dtype.kind in "OUSb"
        if type_ == 1:
            x_new[var] = (_mode(col) if f_nf
                          else float(np.mean(np.asarray(col, dtype=float))))
        elif type_ == 3:
            x_new[var] = [val] * ngrid
        else:  # type 2: regression on the focal variable
            if is_factor:
                # focal is a factor: use group means / modes per level
                grp = pd.Series(np.asarray(col), index=None).groupby(
                    np.asarray(v_focal).astype(str))
                if f_nf:
                    x_new[var] = [_mode(grp.get_group(g)) for g in xx]
                else:
                    x_new[var] = [float(np.mean(np.asarray(
                        grp.get_group(g), dtype=float))) for g in xx]
            elif f_nf:
                x_new[var] = _multinom_predict(np.asarray(col),
                                               np.asarray(v_focal, float), xx)
            else:
                b = np.polyfit(np.asarray(v_focal, float),
                               np.asarray(col, float), 1)
                x_new[var] = np.polyval(b, xx)

    study_new = pd.DataFrame({name: ["new_unit"] * ngrid
                              for name in hM.rl_names})
    rl_new = {}
    for r, name in enumerate(hM.rl_names):
        rL = hM.ranLevels[r]
        if rL.s is not None:
            units1 = list(rL._s_index.keys()) + ["new_unit"]
            s1 = np.vstack([rL.s, rL.s.mean(axis=0)])
            rL1 = HmscRandomLevel(
                s_data=pd.DataFrame(s1, index=units1),
                s_method=rL.spatial_method,
                n_neighbours=rL.n_neighbours,
                s_knot=rL.s_knot)
        elif rL.dist_mat is not None:
            rm = rL.dist_mat.mean(axis=1)
            focals = np.argsort(rm)[:2]
            newdist = rL.dist_mat[focals].mean(axis=0)
            dm1 = np.vstack([np.column_stack([rL.dist_mat, newdist]),
                             np.append(newdist, 0.0)[None, :]])
            units1 = list(rL._dist_names) + ["new_unit"]
            rL1 = HmscRandomLevel(dist_mat=pd.DataFrame(dm1, index=units1),
                                  s_method=rL.spatial_method)
        elif rL.x_dim > 0:
            # covariate-dependent level: the new unit gets the mean covariates
            units1 = list(rL._x_index.keys()) + ["new_unit"]
            x1 = np.vstack([rL.x, rL.x.mean(axis=0)])
            rL1 = HmscRandomLevel(x_data=pd.DataFrame(x1, index=units1))
        else:
            rL1 = HmscRandomLevel(units=list(rL.pi) + ["new_unit"])
        set_priors_random_level(rL1, nu=rL.nu, a1=rL.a1, b1=rL.b1, a2=rL.a2,
                                b2=rL.b2, alphapw=rL.alphapw,
                                nf_max=rL.nf_max, nf_min=rL.nf_min)
        rl_new[name] = rL1
    return {"XDataNew": x_new, "studyDesignNew": study_new, "rLNew": rl_new}


def prepare_gradient(hM, x_data_new, s_data_new=None) -> dict:
    """Wrap user-supplied new covariates (+ spatial coordinates per level)
    into the Gradient structure (reference ``prepareGradient.R:31-66``)."""
    import pandas as pd

    from ..random_level import HmscRandomLevel, set_priors_random_level

    ny_new = len(x_data_new)
    study = {}
    rl_new = {}
    s_data_new = dict(s_data_new or {})
    for r, name in enumerate(hM.rl_names):
        rL = hM.ranLevels[r]
        if rL.s_dim == 0:
            study[name] = ["new_unit"] * ny_new
            if rL.x_dim > 0:
                units1 = list(rL._x_index.keys()) + ["new_unit"]
                x1 = np.vstack([rL.x, rL.x.mean(axis=0)])
                rL1 = HmscRandomLevel(x_data=pd.DataFrame(x1, index=units1))
            else:
                rL1 = HmscRandomLevel(units=list(rL.pi) + ["new_unit"])
        else:
            if name not in s_data_new:
                raise ValueError(f"prepareGradient: sDataNew must contain coordinates for spatial level {name!r}")
            xy_new = np.asarray(s_data_new[name], dtype=float)
            labels = [f"new_spatial_unit{i+1:06d}" for i in range(len(xy_new))]
            study[name] = labels
            units1 = list(rL._s_index.keys()) + labels
            s1 = np.vstack([rL.s, xy_new])
            rL1 = HmscRandomLevel(s_data=pd.DataFrame(s1, index=units1),
                                  s_method=rL.spatial_method,
                                  n_neighbours=rL.n_neighbours,
                                  s_knot=rL.s_knot)
        set_priors_random_level(rL1, nu=rL.nu, a1=rL.a1, b1=rL.b1, a2=rL.a2,
                                b2=rL.b2, alphapw=rL.alphapw,
                                nf_max=rL.nf_max, nf_min=rL.nf_min)
        rl_new[name] = rL1
    return {"XDataNew": x_data_new,
            "studyDesignNew": pd.DataFrame(study) if study else None,
            "rLNew": rl_new}
