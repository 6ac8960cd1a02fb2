"""Model specification layer (reference ``R/Hmsc.R:109-634``,
``R/setPriors.Hmsc.R:20-104``).

``Hmsc(...)`` validates and assembles the model: the response matrix Y, the
environmental design matrix X (shared, or per-species), species traits Tr,
phylogenetic correlation C, the study design -> random levels mapping Pi, the
observation-model table ``distr``, X/Tr/Y scaling with stored back-transform
parameters, and the default priors.  Everything here is host-side numpy; the
result is a frozen spec that the PyTorch sampling engine consumes.

A copy of ``hmsc_tpu/model.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from .random_level import HmscRandomLevel
from .utils.formula import design_matrix

__all__ = ["Hmsc", "set_priors"]

_DISTR_CODES = {
    # family: 1=normal, 2=probit, 3=Poisson(log); second entry: dispersion estimated?
    "normal": (1, 1),
    "probit": (2, 0),
    "poisson": (3, 0),
    "lognormal poisson": (3, 1),
}
# fixed residual variance when dispersion is not estimated, per family
# (reference computeInitialParameters.R:119-124)
FIXED_SIGMA2 = {1: 1.0, 2: 1.0, 3: 1e-2}


class XSelect:
    """One spike-and-slab variable-selection group (reference
    ``R/updateBetaSel.R``): covariate columns ``cov_group`` (0-based indices
    into X) are switched on/off jointly for each species group, with prior
    inclusion probability ``q[g]`` for species group ``g``; ``sp_group`` maps
    each species to its group (0-based)."""

    def __init__(self, cov_group, sp_group, q):
        self.cov_group = np.atleast_1d(np.asarray(cov_group, dtype=int))
        self.sp_group = np.asarray(sp_group, dtype=int)
        self.q = np.atleast_1d(np.asarray(q, dtype=float))
        if self.sp_group.ndim != 1:
            raise ValueError("Hmsc.setData: spGroup for XSelect must be a vector with one entry per species")
        if self.sp_group.min(initial=0) < 0 or self.sp_group.max(initial=0) >= len(self.q):
            raise ValueError("Hmsc.setData: spGroup for XSelect must index into q")


class Hmsc:
    """Hierarchical model of species communities: full model specification.

    Mirrors the reference constructor's capability surface: Y (+NAs), X as a
    data frame + formula, a plain matrix, or a per-species list; XSelect
    variable-selection groups; reduced-rank covariates XRRR; traits; phylogeny
    (correlation matrix C); study design with random levels; per-species
    observation models; and X/Tr/Y scaling with recorded back-transforms.
    """

    def __init__(self, Y, x_formula="~.", x_data=None, X=None, x_scale=True,
                 x_select=None,
                 xrrr_data=None, xrrr_formula="~.-1", XRRR=None, nc_rrr=2,
                 xrrr_scale=True,
                 y_scale=False,
                 study_design=None, ran_levels=None, ran_levels_used=None,
                 tr_formula=None, tr_data=None, Tr=None, tr_scale=True,
                 C=None, phylo_tree=None,
                 distr="normal", truncate_number_of_factors=True):
        # ---- response ----------------------------------------------------
        if hasattr(Y, "values"):  # pandas
            self.sp_names = [str(c) for c in Y.columns]
            Y = np.asarray(Y.values, dtype=float)
        else:
            Y = np.asarray(Y, dtype=float)
            self.sp_names = None
        if Y.ndim != 2:
            raise ValueError("Hmsc.setData: Y argument must be a matrix of sampling units times species")
        self.Y = Y
        self.ny, self.ns = Y.shape
        if self.sp_names is None:
            width = max(1, int(np.ceil(np.log10(max(self.ns, 2)))))
            self.sp_names = [f"sp{j+1:0{width}d}" for j in range(self.ns)]

        # ---- fixed-effect covariates ------------------------------------
        if x_data is not None and X is not None:
            raise ValueError("Hmsc.setData: only single of XData and X arguments must be specified")
        self.x_formula = None
        self.x_data = None
        self.x_is_list = False
        if x_data is not None:
            if isinstance(x_data, (list, tuple)):
                if len(x_data) != self.ns:
                    raise ValueError("Hmsc.setData: the length of XData list argument must be equal to the number of species")
                mats, names = [], None
                for df in x_data:
                    if len(df) != self.ny:
                        raise ValueError("Hmsc.setData: for each element of XData list the number of rows must be equal to the number of sampling units")
                    if _has_na(df):
                        raise ValueError("Hmsc.setData: all elements of XData list must contain no NA values")
                    m, names = design_matrix(x_formula, df)
                    mats.append(m)
                self.X = np.stack(mats, axis=0)  # (ns, ny, nc)
                self.x_is_list = True
                self.cov_names = names
            else:
                if len(x_data) != self.ny:
                    raise ValueError("Hmsc.setData: the number of rows in XData must be equal to the number of sampling units")
                if _has_na(x_data):
                    raise ValueError("Hmsc.setData: XData must contain no NA values")
                self.X, self.cov_names = design_matrix(x_formula, x_data)
            self.x_data = x_data
            self.x_formula = x_formula
        elif X is not None:
            if isinstance(X, (list, tuple)):
                if len(X) != self.ns:
                    raise ValueError("Hmsc.setData: the length of X list argument must be equal to the number of species")
                for m in X:
                    m = np.asarray(m, dtype=float)
                    if m.shape[0] != self.ny:
                        raise ValueError("Hmsc.setData: for each element of X list the number of rows must be equal to the number of sampling units")
                    if np.isnan(m).any():
                        raise ValueError("Hmsc.setData: all elements of X list must contain no NA values")
                self.X = np.stack([np.asarray(m, dtype=float) for m in X], axis=0)
                self.x_is_list = True
                self.cov_names = None
            else:
                Xm = np.asarray(X, dtype=float)
                if Xm.shape[0] != self.ny:
                    raise ValueError("Hmsc.setData: the number of rows in X must be equal to the number of sampling units")
                if np.isnan(Xm).any():
                    raise ValueError("Hmsc.setData: X must contain no NA values")
                self.X = Xm
                self.cov_names = None
        else:
            self.X = np.empty((self.ny, 0))
            self.cov_names = []
        self.nc = self.X.shape[-1]
        if self.cov_names is None:
            width = max(1, int(np.ceil(np.log10(max(self.nc, 2)))))
            self.cov_names = [f"cov{k+1:0{width}d}" for k in range(self.nc)]

        # ---- X scaling (reference Hmsc.R:281-330) ------------------------
        x_stack = self.X.reshape(-1, self.nc) if self.x_is_list else self.X
        self.x_intercept_ind = _find_intercept(x_stack, self.cov_names, "X")
        self.x_scale_par, x_scaled_stack = _scale_columns(
            x_stack, x_scale, self.x_intercept_ind)
        self.XScaled = (x_scaled_stack.reshape(self.X.shape)
                        if self.x_is_list else x_scaled_stack)

        # ---- variable selection -----------------------------------------
        x_select = list(x_select) if x_select else []
        self.ncsel = len(x_select)
        self.x_select = x_select
        for sel in x_select:
            if sel.cov_group.max(initial=0) >= self.nc:
                raise ValueError("Hmsc.setData: covGroup for XSelect cannot have values greater than number of columns in X")
            if sel.sp_group.shape != (self.ns,):
                raise ValueError("Hmsc.setData: spGroup for XSelect must be a vector with one entry per species")

        # ---- reduced-rank regression covariates -------------------------
        self.nc_nrrr = self.nc
        self.XRRR = None
        self.nc_orrr = 0
        self.nc_rrr = 0
        if xrrr_data is not None:
            if len(xrrr_data) != self.ny:
                raise ValueError("Hmsc.setData: the number of rows in XRRRData must be equal to the number of sampling units")
            if _has_na(xrrr_data):
                raise ValueError("Hmsc.setData: XRRRData must contain no NA values")
            self.XRRR, self.xrrr_names = design_matrix(xrrr_formula, xrrr_data)
            self.nc_orrr = self.XRRR.shape[1]
            self.nc_rrr = int(nc_rrr)
        elif XRRR is not None:
            XRRR = np.asarray(XRRR, dtype=float)
            if XRRR.ndim != 2:
                raise ValueError("Hmsc.setData: XRRR must be a matrix")
            if XRRR.shape[0] != self.ny:
                raise ValueError("Hmsc.setData: the number of rows in XRRR must be equal to the number of sampling units")
            if np.isnan(XRRR).any():
                raise ValueError("Hmsc.setData: XRRR must contain no NA values")
            self.XRRR = XRRR
            self.nc_orrr = XRRR.shape[1]
            self.nc_rrr = int(nc_rrr)
        if self.nc_rrr > 0:
            self.cov_names = self.cov_names + [f"XRRR_{k+1}" for k in range(self.nc_rrr)]
            self.nc = self.nc_nrrr + self.nc_rrr
            if xrrr_scale is False:
                self.xrrr_scale_par = np.vstack([np.zeros(self.nc_orrr), np.ones(self.nc_orrr)])
                self.XRRRScaled = self.XRRR
            else:
                if x_scale is False:
                    raise ValueError("Hmsc.setData: XRRR can't be scaled if X is not scaled")
                self.xrrr_scale_par, self.XRRRScaled = _scale_columns(
                    self.XRRR, xrrr_scale, None,
                    center=self.x_intercept_ind is not None)
        else:
            self.xrrr_scale_par = None
            self.XRRRScaled = None

        # ---- traits ------------------------------------------------------
        if tr_data is not None and Tr is not None:
            raise ValueError("Hmsc.setData: at maximum one of TrData and Tr arguments can be specified")
        if tr_data is not None:
            if tr_formula is None:
                raise ValueError("Hmsc.setData: TrFormula argument must be specified if TrData is provided")
            if len(tr_data) != self.ns:
                raise ValueError("Hmsc.setData: the number of rows in TrData should be equal to number of columns in Y")
            if _has_na(tr_data):
                raise ValueError("Hmsc.setData: TrData parameter must not contain any NA values")
            self.Tr, self.tr_names = design_matrix(tr_formula, tr_data)
        elif Tr is not None:
            Tr = np.asarray(Tr, dtype=float)
            if Tr.ndim != 2:
                raise ValueError("Hmsc.setData: Tr must be a matrix")
            if Tr.shape[0] != self.ns:
                raise ValueError("Hmsc.setData: the number of rows in Tr should be equal to number of columns in Y")
            if np.isnan(Tr).any():
                raise ValueError("Hmsc.setData: Tr parameter must not contain any NA values")
            self.Tr = Tr
            self.tr_names = None
        else:
            self.Tr = np.ones((self.ns, 1))
            self.tr_names = ["(Intercept)"]
        self.nt = self.Tr.shape[1]
        if self.tr_names is None:
            width = max(1, int(np.ceil(np.log10(max(self.nt, 2)))))
            self.tr_names = [f"tr{k+1:0{width}d}" for k in range(self.nt)]

        self.tr_intercept_ind = _find_intercept(self.Tr, self.tr_names, "Tr") \
            if tr_scale is not False else None
        self.tr_scale_par, self.TrScaled = _scale_columns(
            self.Tr, tr_scale, self.tr_intercept_ind)

        # ---- phylogeny ---------------------------------------------------
        # either a correlation matrix C, or a tree converted to its Brownian
        # correlation like the reference's ape::vcv.phylo path
        # (R/Hmsc.R:501-509; trees arrive as Newick strings here)
        self.C = None
        self.phylo_tree = None
        if C is not None and phylo_tree is not None:
            raise ValueError("Hmsc.setData: at maximum one of phyloTree and C arguments can be specified")
        if phylo_tree is not None:
            raise NotImplementedError(
                "phylogenetic trees are not ported yet (ROADMAP A5)")
        if C is not None:
            C = np.asarray(C, dtype=float)
            if C.shape != (self.ns, self.ns):
                raise ValueError("Hmsc.setData: the size of square matrix C must be equal to number of species")
            self.C = C

        # ---- study design / random levels -------------------------------
        if study_design is None:
            self.Pi = np.empty((self.ny, 0), dtype=np.int32)
            self.np_ = np.empty(0, dtype=int)
            self.nr = 0
            self.rl_names = []
            self.ranLevels = []
            self.df_pi = None
            self.pi_names = []
            if ran_levels:
                raise ValueError("Hmsc.setData: studyDesign is empty, but ranLevels is not")
        else:
            if len(study_design) != self.ny:
                raise ValueError("Hmsc.setData: the number of rows in studyDesign must be equal to number of rows in Y")
            ran_levels = dict(ran_levels or {})
            if ran_levels_used is None:
                ran_levels_used = list(ran_levels.keys())
            if any(n not in ran_levels for n in ran_levels_used):
                raise ValueError("Hmsc.setData: ranLevels must contain named elements corresponding to all levels listed in ranLevelsUsed")
            sd_cols = ([str(c) for c in study_design.columns]
                       if hasattr(study_design, "columns") else None)
            if sd_cols is not None and any(n not in sd_cols for n in ran_levels_used):
                raise ValueError("Hmsc.setData: studyDesign must contain named columns corresponding to all levels listed in ranLevelsUsed")
            self.study_design = study_design
            self.rl_names = list(ran_levels_used)
            self.ranLevels = [ran_levels[n] for n in self.rl_names]
            # Pi: per-level integer unit index per row; unit order = sorted
            # unique labels (R factor level order, Hmsc.R:547-551)
            self.Pi = np.empty((self.ny, len(self.rl_names)), dtype=np.int32)
            self.pi_names = []
            self.df_pi = []
            for r, name in enumerate(self.rl_names):
                col = (study_design[name] if sd_cols is not None
                       else np.asarray(study_design)[:, r])
                labels = [str(v) for v in np.asarray(col)]
                uniq = sorted(set(labels))
                lut = {u: i for i, u in enumerate(uniq)}
                self.Pi[:, r] = np.array([lut[v] for v in labels], dtype=np.int32)
                self.pi_names.append(uniq)
                self.df_pi.append(labels)
            self.np_ = np.array([len(u) for u in self.pi_names], dtype=int)
            self.nr = len(self.rl_names)
            if truncate_number_of_factors:
                for rL in self.ranLevels:
                    rL.nf_max = min(rL.nf_max, self.ns)
                    rL.nf_min = min(rL.nf_min, rL.nf_max)

        # ---- observation models -----------------------------------------
        self.distr = _encode_distr(distr, self.ns)

        # ---- Y scaling (normal species only; reference Hmsc.R:614-629) --
        if y_scale is False:
            self.y_scale_par = np.vstack([np.zeros(self.ns), np.ones(self.ns)])
            self.YScaled = self.Y
        else:
            y_scale_par = np.vstack([np.zeros(self.ns), np.ones(self.ns)])
            YScaled = self.Y.copy()
            ind = self.distr[:, 0] == 1
            if ind.any():
                mu = np.nanmean(self.Y[:, ind], axis=0)
                sd = np.nanstd(self.Y[:, ind], axis=0, ddof=1)
                y_scale_par[0, ind] = mu
                y_scale_par[1, ind] = sd
                YScaled[:, ind] = (self.Y[:, ind] - mu) / sd
            self.y_scale_par = y_scale_par
            self.YScaled = YScaled

        # ---- priors ------------------------------------------------------
        self.V0 = None
        self.f0 = None
        self.mGamma = None
        self.UGamma = None
        self.aSigma = None
        self.bSigma = None
        self.rhopw = None
        self.nuRRR = self.a1RRR = self.b1RRR = self.a2RRR = self.b2RRR = None
        set_priors(self, set_default=True)

        # posterior fields populated by sample_mcmc
        self.postList = None
        self.samples = None
        self.transient = None
        self.thin = None
        self.adaptNf = None

    # aliases matching the reference's field names
    @property
    def np(self):
        return self.np_

    def __repr__(self):
        return (f"Hmsc(ny={self.ny}, ns={self.ns}, nc={self.nc}, nt={self.nt}, "
                f"nr={self.nr}, phylo={self.C is not None})")


def set_priors(hM: Hmsc, V0=None, f0=None, mGamma=None, UGamma=None,
               aSigma=None, bSigma=None, nuRRR=None, a1RRR=None, b1RRR=None,
               a2RRR=None, b2RRR=None, rhopw=None, set_default: bool = False) -> Hmsc:
    """Default priors (reference ``setPriors.Hmsc.R:20-104``): Wishart on iV
    (V0=I, f0=nc+1), Gaussian on Gamma (0, I), gamma on iSigma (1, 5), and the
    101-point rho grid with P(rho=0)=0.5."""
    if V0 is not None:
        V0 = np.asarray(V0, dtype=float)
        if V0.shape != (hM.nc, hM.nc) or not np.allclose(V0, V0.T):
            raise ValueError("HMSC.setPriors: V0 must be a positive definite matrix of size equal to number of covariates nc")
        hM.V0 = V0
    elif set_default:
        hM.V0 = np.eye(hM.nc)
    if f0 is not None:
        if f0 < hM.nc:
            raise ValueError("HMSC.setPriors: f0 must be greater than number of covariates in the model nc")
        hM.f0 = float(f0)
    elif set_default:
        hM.f0 = float(hM.nc + 1)
    if mGamma is not None:
        mGamma = np.asarray(mGamma, dtype=float).ravel()
        if mGamma.size != hM.nc * hM.nt:
            raise ValueError("HMSC.setPriors: mGamma must be a vector of length equal to number of covariates times traits: nc x nt")
        hM.mGamma = mGamma
    elif set_default:
        hM.mGamma = np.zeros(hM.nc * hM.nt)
    if UGamma is not None:
        UGamma = np.asarray(UGamma, dtype=float)
        if UGamma.shape != (hM.nc * hM.nt,) * 2 or not np.allclose(UGamma, UGamma.T):
            raise ValueError("HMSC.setPriors: UGamma must be a positive definite matrix of size equal to nc x nt")
        hM.UGamma = UGamma
    elif set_default:
        hM.UGamma = np.eye(hM.nc * hM.nt)
    if aSigma is not None:
        hM.aSigma = np.broadcast_to(np.asarray(aSigma, dtype=float), (hM.ns,)).copy()
    elif set_default:
        hM.aSigma = np.ones(hM.ns)
    if bSigma is not None:
        hM.bSigma = np.broadcast_to(np.asarray(bSigma, dtype=float), (hM.ns,)).copy()
    elif set_default:
        hM.bSigma = np.full(hM.ns, 5.0)
    if rhopw is not None:
        if hM.C is None:
            raise ValueError("HMSC.setPriors: prior for phylogeny given, but no phylogenic relationship matrix was specified")
        rhopw = np.asarray(rhopw, dtype=float)
        if rhopw.ndim != 2 or rhopw.shape[1] != 2:
            raise ValueError("HMSC.setPriors: rhopw must be a matrix with two columns")
        hM.rhopw = rhopw
    elif set_default:
        rho_n = 100
        grid = np.arange(rho_n + 1) / rho_n
        w = np.concatenate([[0.5], np.full(rho_n, 0.5 / rho_n)])
        hM.rhopw = np.column_stack([grid, w])
    for name, val, dflt in (("nuRRR", nuRRR, 3.0), ("a1RRR", a1RRR, 1.0),
                            ("b1RRR", b1RRR, 1.0), ("a2RRR", a2RRR, 50.0),
                            ("b2RRR", b2RRR, 1.0)):
        if val is not None:
            setattr(hM, name, float(val))
        elif set_default:
            setattr(hM, name, dflt)
    return hM


# ---------------------------------------------------------------------------

def _has_na(df) -> bool:
    if hasattr(df, "isna"):
        return bool(df.isna().to_numpy().any())
    arr = np.asarray(df)
    return arr.dtype.kind == "f" and bool(np.isnan(arr).any())


def _find_intercept(M: np.ndarray, names, what: str):
    idx = [i for i, n in enumerate(names or []) if n in ("Intercept", "(Intercept)")]
    if len(idx) > 1:
        raise ValueError(f"Hmsc.setData: only one column of {what} matrix could be named Intercept or (Intercept)")
    if len(idx) == 1:
        if not np.all(M[:, idx[0]] == 1):
            raise ValueError(f"Hmsc.setData: intercept column in {what} matrix must be a column of ones")
        return idx[0]
    return None


def _scale_columns(M: np.ndarray, scale_arg, intercept_ind, center=None):
    """Center+scale non-binary columns; intercept-aware (reference
    ``Hmsc.R:281-330``).  Returns (scale_par (2,k), scaled copy)."""
    k = M.shape[1]
    scale_par = np.vstack([np.zeros(k), np.ones(k)])
    if scale_arg is False:
        return scale_par, M
    if scale_arg is True:
        scale_ind = np.array([not np.all(np.isin(M[:, j], (0.0, 1.0))) for j in range(k)])
    else:
        scale_ind = np.asarray(scale_arg, dtype=bool)
    if intercept_ind is not None:
        scale_ind = scale_ind.copy()
        scale_ind[intercept_ind] = False
    do_center = intercept_ind is not None if center is None else center
    out = M.astype(float).copy()
    for j in np.where(scale_ind)[0]:
        col = M[:, j]
        mu = col.mean() if do_center else 0.0
        sd = col.std(ddof=1) if do_center else np.sqrt(np.sum(col**2) / (len(col) - 1))
        scale_par[0, j] = mu
        scale_par[1, j] = sd
        out[:, j] = (col - mu) / sd
    return scale_par, out


def _encode_distr(distr, ns: int) -> np.ndarray:
    """Observation-model table: (ns, 2) [family, dispersion-estimated]
    (reference ``Hmsc.R:560-612``; the reference's dead columns 3-4 dropped)."""
    if isinstance(distr, str):
        distr = [distr] * ns
    distr_arr = np.asarray(distr)
    if distr_arr.dtype.kind in "OUS":
        out = np.zeros((ns, 2), dtype=np.int32)
        for j, name in enumerate(distr_arr.ravel()):
            if str(name) not in _DISTR_CODES:
                raise ValueError("Hmsc.setData: some of the distributions ill defined")
            out[j] = _DISTR_CODES[str(name)]
        return out
    distr_arr = np.asarray(distr_arr, dtype=np.int32)
    if distr_arr.ndim != 2 or distr_arr.shape[0] != ns:
        raise ValueError("Hmsc.setData: some of the distributions ill defined")
    out = distr_arr[:, :2].copy()
    if np.any((out[:, 0] < 1) | (out[:, 0] > 3)):
        raise ValueError("Hmsc.setData: some of the distributions ill defined")
    return out
