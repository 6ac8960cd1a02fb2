"""Core structures of the Gibbs engine (port of ``hmsc_tpu/mcmc/structs.py``).

- ``ModelSpec`` / ``LevelSpec``: static, hashable metadata (shapes, flags),
  copied from the JAX package.
- ``ModelData`` / ``LevelData``: constant tensors on the device (data and
  priors), shared by every chain.
- ``GibbsState`` / ``LevelState``: the Markov-chain state, one tensor per
  field with a LEADING CHAIN AXIS (the JAX package vmaps a chainless state
  instead).  Factor blocks are allocated at the static ``nf_max`` with an
  active-factor mask, exactly as in the JAX package.

``data_from_numpy`` / ``state_from_numpy`` take the JAX package's
``ModelData`` / ``GibbsState`` flattened to numpy arrays (keyed by field
name, per-level fields as ``levels.<r>.<field>``), so the tests can start
both engines from byte-identical inputs.  For an NNGP level they also build
the reverse-neighbour lists of the Vecchia kernel
(:func:`reverse_neighbours`); a GPP level's knot grids load as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..model import FIXED_SIGMA2, Hmsc
from ..precompute import DataParams, compute_initial_parameters

__all__ = ["LevelSpec", "ModelSpec", "LevelData", "ModelData", "LevelState",
           "GibbsState", "build_spec", "build_model_data", "build_state",
           "stack_states", "data_from_numpy", "state_from_numpy",
           "check_supported", "reverse_neighbours", "site_slice_data",
           "site_slice_level", "site_slice_state", "site_gather_state",
           "DEFAULT_NF_CAP"]

# static cap on latent factors per level (reference grows nf up to ns,
# updateNf.R:26; the preallocated factor blocks need a concrete bound)
DEFAULT_NF_CAP = 16


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    name: str
    n_units: int
    nf_max: int
    nf_min: int
    ncr: int                      # max(x_dim, 1)
    x_dim: int
    spatial: str | None           # None | 'Full' | 'NNGP' | 'GPP'
    n_alpha: int                  # alpha-grid size (0 if non-spatial)
    n_neighbours: int = 0
    n_knots: int = 0
    # True when nf_max was cut below the user's prior bound min(rL.nf_max,
    # ns) by the static nf_cap — only then is blocked factor growth a cap
    # artifact worth warning about (a deliberate nf_min=nf_max freeze is not)
    nf_capped: bool = False


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    ny: int
    ns: int
    nc: int
    nt: int
    nr: int
    n_rho: int
    has_phylo: bool
    has_na: bool
    x_is_list: bool
    any_normal: bool
    any_probit: bool
    any_poisson: bool
    any_estimated_sigma: bool
    homoskedastic_fixed: bool
    f0: float
    ncsel: int
    nc_rrr: int
    nc_orrr: int
    nc_nrrr: int
    levels: tuple[LevelSpec, ...]

    @property
    def nf_total(self) -> int:
        """Total stacked factor columns across levels: sum nf_max * ncr."""
        return sum(l.nf_max * l.ncr for l in self.levels)


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class LevelData(_Replace):
    pi_row: Any                  # (ny,) int64 unit index per row
    unit_count: Any              # (np,) rows per unit
    x_row: Any                   # (ny, ncr) ones (x_dim = 0)
    x_unit: Any                  # (np, ncr)
    nu: Any                      # (ncr,) shrinkage hyperparams
    a1: Any
    b1: Any
    a2: Any
    b2: Any
    alphapw: Any = None          # (G, 2) alpha grid and prior weights
    # spatial 'Full'
    iWg: Any = None              # (G, np, np)
    detWg: Any = None            # (G,) log det W
    # spatial 'NNGP'
    nn_idx: Any = None           # (np, k) int32, pads index 0
    nn_coef: Any = None          # (G, np, k), pads 0
    nn_D: Any = None             # (G, np)
    # the lists and the coefficient grid with the unit last: B8b's grid
    # mode takes a unit a thread, so a warp's loads of a slot are 128 bytes
    # in a row
    nn_idx_u: Any = None         # (k, np) int32
    nn_coef_u: Any = None        # (G, k, np)
    nn_n: Any = None             # (np,) int32 real neighbours per unit
    # reverse-neighbour CSR: unit j is neighbour slot rev_pos[e] % k of
    # unit rev_pos[e] // k for e in rev_ptr[j]:rev_ptr[j+1]
    rev_ptr: Any = None          # (np + 1,) int32
    rev_pos: Any = None          # (nnz,) int32
    # spatial 'GPP'
    idDg: Any = None             # (G, np)
    idDW12g: Any = None          # (G, np, nK) float64 (see _F64_FIELDS)
    Fg: Any = None               # (G, nK, nK) float64
    iFg: Any = None              # (G, nK, nK) float64
    detDg: Any = None            # (G,)
    # a rank's block of an NNGP level on a site mesh (site_slice_data): the
    # level's whole neighbour structure (nn_idx, nn_n, rev_ptr, rev_pos),
    # which the dense draw reads after gathering the grids at alpha
    nn_full: Any = None


@dataclasses.dataclass
class ModelData(_Replace):
    Y: Any                       # (ny, ns)
    Ymask: Any                   # (ny, ns) 1.0 observed
    X: Any                       # (ny, nc)
    Tr: Any                      # (ns, nt)
    distr_family: Any            # (ns,) int32
    distr_estsig: Any            # (ns,) 1.0 where dispersion estimated
    sigma_fixed: Any             # (ns,) fixed sigma^2 values for the rest
    mGamma: Any                  # (nc*nt,)
    iUGamma: Any                 # (nc*nt, nc*nt)
    UGamma: Any                  # (nc*nt, nc*nt)
    V0: Any                      # (nc, nc)
    aSigma: Any                  # (ns,)
    bSigma: Any                  # (ns,)
    levels: tuple = ()
    x_scale_par: Any = None      # (2, nc)
    tr_scale_par: Any = None     # (2, nt)
    y_scale_par: Any = None      # (2, ns)
    x_intercept_ind: int | None = None
    tr_intercept_ind: int | None = None
    # first all-ones column of the scaled design (the named intercept when
    # present, else detected by value): the column the location interweave
    # shifts.  Without the by-value detection the move silently turns off
    # for raw-matrix designs whose first column is ones.
    x_ones_ind: int | None = None
    # constants of the GammaV block, formed once from the fields above by
    # data_from_numpy: Tr'Tr and iUGamma mGamma
    TtT: Any = None              # (nt, nt)
    iUGmG: Any = None            # (nc*nt,)


@dataclasses.dataclass
class LevelState(_Replace):
    Eta: Any                     # (C, np, nf_max)
    Lambda: Any                  # (C, nf_max, ns, ncr)
    Psi: Any                     # (C, nf_max, ns, ncr)
    Delta: Any                   # (C, nf_max, ncr); 1.0 on inactive slots
    alpha_idx: Any               # (C, nf_max) int32
    nf_mask: Any                 # (C, nf_max) 1.0 active
    nf_sat: Any                  # (C,) int32 blocked factor-growth attempts


@dataclasses.dataclass
class GibbsState(_Replace):
    Z: Any                       # (C, ny, ns) latent response
    Beta: Any                    # (C, nc, ns)
    Gamma: Any                   # (C, nc, nt)
    iV: Any                      # (C, nc, nc)
    rho_idx: Any                 # (C,) int32
    iSigma: Any                  # (C, ns) residual precisions
    levels: tuple                # tuple[LevelState]
    it: Any                      # (C,) int32 sweep counter (1-based)

    @property
    def n_chains(self) -> int:
        return int(self.Z.shape[0])

    def float_tensors(self):
        """Every floating-point field (the divergence tracker's scope)."""
        out = [self.Z, self.Beta, self.Gamma, self.iV, self.iSigma]
        for lv in self.levels:
            out += [lv.Eta, lv.Lambda, lv.Psi, lv.Delta, lv.nf_mask]
        return out


# ---------------------------------------------------------------------------

def check_supported(hM: Hmsc, spec: ModelSpec) -> None:
    """Raise NotImplementedError for a model feature this slice of the port
    does not sample, naming the ROADMAP item that brings it.  Nothing falls
    back to another path."""
    checks = (
        (spec.has_phylo, "phylogeny (ROADMAP A5)"),
        (spec.x_is_list, "per-species X lists (ROADMAP A5)"),
        (any(ls.x_dim > 0 for ls in spec.levels),
         "covariate-dependent random levels, x_dim > 0 (ROADMAP A5)"),
        (spec.ncsel > 0, "variable selection (ROADMAP A7)"),
        (spec.nc_rrr > 0, "reduced-rank regression (ROADMAP A7)"),
    )
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")


def build_spec(hM: Hmsc, nf_cap: int = DEFAULT_NF_CAP) -> ModelSpec:
    level_specs = []
    for r in range(hM.nr):
        rL = hM.ranLevels[r]
        nf_max = int(min(rL.nf_max, hM.ns, nf_cap))
        nf_min = int(min(rL.nf_min, nf_max))
        spatial = rL.spatial_method if rL.s_dim != 0 else None
        level_specs.append(LevelSpec(
            name=hM.rl_names[r], n_units=int(hM.np_[r]), nf_max=nf_max,
            nf_min=nf_min, ncr=max(rL.x_dim, 1), x_dim=rL.x_dim,
            nf_capped=nf_max < min(rL.nf_max, hM.ns),
            spatial=spatial,
            n_alpha=0 if spatial is None else rL.alphapw.shape[0],
            n_neighbours=int(rL.n_neighbours or 10) if spatial == "NNGP" else 0,
            n_knots=0 if rL.s_knot is None else int(np.asarray(rL.s_knot).shape[0]),
        ))
    est = hM.distr[:, 1] == 1
    fixed_vals = np.array([FIXED_SIGMA2[int(f)] for f in hM.distr[:, 0]])
    homo = (not est.any()) and bool(np.all(fixed_vals == fixed_vals[0]))
    return ModelSpec(
        ny=hM.ny, ns=hM.ns, nc=hM.nc, nt=hM.nt, nr=hM.nr,
        n_rho=0 if hM.C is None else hM.rhopw.shape[0],
        has_phylo=hM.C is not None,
        has_na=bool(np.isnan(hM.Y).any()),
        x_is_list=hM.x_is_list,
        any_normal=bool((hM.distr[:, 0] == 1).any()),
        any_probit=bool((hM.distr[:, 0] == 2).any()),
        any_poisson=bool((hM.distr[:, 0] == 3).any()),
        any_estimated_sigma=bool(est.any()),
        homoskedastic_fixed=homo,
        f0=float(hM.f0),
        ncsel=hM.ncsel, nc_rrr=hM.nc_rrr, nc_orrr=hM.nc_orrr,
        nc_nrrr=hM.nc_nrrr,
        levels=tuple(level_specs),
    )


def _find_ones_column(hM) -> int | None:
    """First all-ones column of the scaled design the sampler runs on (the
    shiftable direction the interweaving moves need).  Prefers the named
    intercept; otherwise detects by value.  None for per-species X lists."""
    if hM.x_intercept_ind is not None:
        return int(hM.x_intercept_ind)
    Xs = np.asarray(hM.XScaled)
    if Xs.ndim != 2:
        return None
    ones = np.nonzero(np.all(Xs == 1.0, axis=0))[0]
    return int(ones[0]) if ones.size else None


def build_model_data(hM: Hmsc, data_par: DataParams, spec: ModelSpec,
                     device, dtype=torch.float32) -> ModelData:
    """Assemble the constant tensors from the host spec, on ``device``."""
    d = {}
    Y = np.asarray(hM.YScaled, dtype=float)
    d["Y"] = np.nan_to_num(Y, nan=0.0)
    d["Ymask"] = (~np.isnan(Y)).astype(float)
    d["X"], d["Tr"] = hM.XScaled, hM.TrScaled
    d["distr_family"] = np.asarray(hM.distr[:, 0], dtype=np.int32)
    d["distr_estsig"] = (hM.distr[:, 1] == 1).astype(float)
    d["sigma_fixed"] = np.array([FIXED_SIGMA2[int(f)] for f in hM.distr[:, 0]])
    d["mGamma"], d["UGamma"] = hM.mGamma, hM.UGamma
    d["iUGamma"] = np.linalg.inv(hM.UGamma)
    d["V0"], d["aSigma"], d["bSigma"] = hM.V0, hM.aSigma, hM.bSigma
    d["x_scale_par"], d["tr_scale_par"] = hM.x_scale_par, hM.tr_scale_par
    d["y_scale_par"] = hM.y_scale_par
    d["x_intercept_ind"] = hM.x_intercept_ind
    d["tr_intercept_ind"] = hM.tr_intercept_ind
    d["x_ones_ind"] = _find_ones_column(hM)
    for r in range(hM.nr):
        rL, ls = hM.ranLevels[r], spec.levels[r]
        pi = hM.Pi[:, r]
        pre = f"levels.{r}."
        d[pre + "pi_row"] = pi
        d[pre + "unit_count"] = np.bincount(pi, minlength=ls.n_units)
        d[pre + "x_row"] = np.ones((hM.ny, 1))
        d[pre + "x_unit"] = np.ones((ls.n_units, 1))
        for k in ("nu", "a1", "b1", "a2", "b2"):
            d[pre + k] = getattr(rL, k)
        lp = data_par.rL_par[r] if data_par.rL_par else None
        if ls.spatial is not None:
            d[pre + "alphapw"] = rL.alphapw
            if ls.spatial == "Full":
                keys = ("iWg", "detWg")
            elif ls.spatial == "NNGP":
                keys = ("nn_idx", "nn_coef", "nn_D", "nn_n", "detWg")
            else:
                keys = ("idDg", "idDW12g", "Fg", "iFg", "detDg")
            for k in keys:
                d[pre + k] = getattr(lp, k)
    return data_from_numpy(d, device, dtype)


def build_state(hM: Hmsc, spec: ModelSpec, seed: int, device,
                dtype=torch.float32) -> GibbsState:
    """One chain's initial state (a chain axis of length 1), drawn from the
    same numpy stream as the JAX package's ``build_state`` — Z starts at
    the linear predictor; the sampler runs update_z once before sweeping."""
    rng = np.random.default_rng(seed)
    nf_max = [ls.nf_max for ls in spec.levels]
    p = compute_initial_parameters(hM, nf_max, rng)

    Beta = np.asarray(p["Beta"], dtype=float)
    L = np.asarray(hM.XScaled) @ Beta
    s = {}
    for r in range(spec.nr):
        lv = p["levels"][r]
        lam = lv["Lambda"] * lv["nf_mask"][:, None, None]
        eta_rows = lv["Eta"][hM.Pi[:, r]]
        L = L + np.einsum("yf,yk,fjk->yj", eta_rows, np.ones((hM.ny, 1)), lam)
        for k in ("Eta", "Lambda", "Psi", "Delta", "alpha_idx", "nf_mask"):
            s[f"levels.{r}.{k}"] = np.asarray(lv[k])[None]
        s[f"levels.{r}.nf_sat"] = np.zeros(1, dtype=np.int32)
    s.update(Z=L[None], Beta=Beta[None], Gamma=np.asarray(p["Gamma"])[None],
             iV=np.linalg.inv(p["V"])[None],
             rho_idx=np.asarray([p["rho_idx"]], dtype=np.int32),
             iSigma=(1.0 / np.asarray(p["sigma"], dtype=float))[None],
             it=np.zeros(1, dtype=np.int32))
    return state_from_numpy(s, device, dtype)


def stack_states(states) -> GibbsState:
    """Concatenate single- or multi-chain states along the chain axis."""
    def cat(getter):
        return torch.cat([getter(s) for s in states], dim=0)

    first = states[0]
    levels = tuple(
        LevelState(**{f.name: cat(lambda s, r=r, n=f.name:
                                  getattr(s.levels[r], n))
                      for f in dataclasses.fields(LevelState)})
        for r in range(len(first.levels)))
    return GibbsState(**{f.name: (levels if f.name == "levels" else
                                  cat(lambda s, n=f.name: getattr(s, n)))
                         for f in dataclasses.fields(GibbsState)})


# ---------------------------------------------------------------------------
# numpy <-> tensors
# ---------------------------------------------------------------------------

_INT_FIELDS = {"pi_row": torch.int64, "distr_family": torch.int32,
               "alpha_idx": torch.int32, "nf_sat": torch.int32,
               "rho_idx": torch.int32, "it": torch.int32,
               "nn_idx": torch.int32, "nn_idx_u": torch.int32,
               "nn_n": torch.int32,
               "rev_ptr": torch.int32, "rev_pos": torch.int32}
_INDEX_FIELDS = {"x_intercept_ind", "tr_intercept_ind", "x_ones_ind"}
# held in float64 whatever the working type: the GPP grid's F^-1 reaches
# cond(F) ~ 3e7 at large alpha, where its float32 rounding alone moves the
# prior quadratic Et' F^-1 Et by up to its own size (csrc/gpp_quad.cu); F
# rounded to float32 moves the Eta draw's knot correction H = F - M' iA M
# by 4.6% of the draw's sd at config 3c's largest alpha, and idD W12 the
# location move's 1' iW 1 by 2e-5 of itself (csrc/gpp_knot.cu; idDg in
# float32 moves neither by more than 1e-6)
_F64_FIELDS = {"iFg", "Fg", "idDW12g"}


def _tensor(name, a, device, dtype):
    # a copy: the port's tensors never alias the caller's arrays
    dt = torch.float64 if name in _F64_FIELDS else _INT_FIELDS.get(name,
                                                                    dtype)
    return torch.tensor(np.asarray(a), dtype=dt, device=device)


def _split_levels(d: dict):
    top, levels = {}, {}
    for k, v in d.items():
        if k.startswith("levels."):
            _, r, field = k.split(".", 2)
            levels.setdefault(int(r), {})[field] = v
        else:
            top[k] = v
    return top, [levels[r] for r in sorted(levels)]


def _neighbour_counts(nn_idx, nn_coef):
    """Real neighbours per unit of an NNGP level given without them (a JAX
    ``ModelData``).  The lists are ascending and distinct, so a 0 after
    slot 0 is a pad; a 0 in slot 0 counts when its coefficient is non-zero
    somewhere on the grid (one that is zero everywhere adds exact zeros
    either way)."""
    nn_idx = np.asarray(nn_idx)
    n = (nn_idx[:, 1:] != 0).sum(axis=1)
    first = (nn_idx[:, 0] != 0) | (np.asarray(nn_coef)[:, :, 0] != 0).any(0)
    return n + first


def reverse_neighbours(nn_idx, nn_n, n_units: int | None = None):
    """The reverse-neighbour CSR of an NNGP level, built on the host:
    ``(rev_ptr, rev_pos)`` such that the entries ``e`` in
    ``rev_ptr[j]:rev_ptr[j+1]`` are the positions ``i k + slot`` of the
    (unit ``i``, slot) pairs that list unit ``j`` as a real neighbour, in
    ascending order.  Pads (slots at or past ``nn_n``) are left out, so the
    transpose of the Vecchia factor gives every output one owner and a
    fixed order of summation, and unit 0 does not collect every pad.
    ``n_units`` (default: the rows of ``nn_idx``) is the number of units
    the lists index: a site mesh's rank passes its block of rows and the
    level's global unit count, and gets its local reverse CSR (``i`` a row
    of the block, ``j`` any unit of the level)."""
    nn_idx = np.asarray(nn_idx, dtype=np.int64)
    npr, k = nn_idx.shape
    n_out = npr if n_units is None else int(n_units)
    real = np.arange(k)[None, :] < np.asarray(nn_n)[:, None]
    pos = np.nonzero(real.ravel())[0]                   # ascending i*k + kk
    col = nn_idx.ravel()[pos]
    order = np.argsort(col, kind="stable")
    ptr = np.zeros(n_out + 1, dtype=np.int64)
    np.cumsum(np.bincount(col, minlength=n_out), out=ptr[1:])
    return ptr, pos[order]


def unit_last_grids(nn_idx, nn_coef):
    """An NNGP level's lists (np, k) and coefficient grid (G, np, k) with
    the unit last: (k, np) and (G, k, np), contiguous."""
    return (np.ascontiguousarray(np.asarray(nn_idx).T),
            np.ascontiguousarray(np.asarray(nn_coef).transpose(0, 2, 1)))


def data_from_numpy(d: dict, device, dtype=torch.float32) -> ModelData:
    """``ModelData`` from numpy arrays keyed by field name (per-level fields
    as ``levels.<r>.<field>``).  Fields the port does not use are ignored;
    intercept indices may be None or integer scalars.  The GammaV block's
    constants ``TtT`` and ``iUGmG`` are formed here.  An NNGP level's
    ``nn_n`` is derived when absent, and its reverse-neighbour lists and
    its lists and grid with the unit last (:func:`unit_last_grids`) are
    built here."""
    d = dict(d)
    for key in [k for k in d if k.endswith(".nn_idx")]:
        pre = key[:-len("nn_idx")]
        if pre + "nn_n" not in d:
            d[pre + "nn_n"] = _neighbour_counts(d[key], d[pre + "nn_coef"])
        d[pre + "rev_ptr"], d[pre + "rev_pos"] = reverse_neighbours(
            d[key], d[pre + "nn_n"])
        d[pre + "nn_idx_u"], d[pre + "nn_coef_u"] = unit_last_grids(
            d[key], d[pre + "nn_coef"])
    top, lvls = _split_levels(d)
    names = {f.name for f in dataclasses.fields(LevelData)}
    levels = tuple(LevelData(**{k: _tensor(k, v, device, dtype)
                                for k, v in lv.items() if k in names})
                   for lv in lvls)
    kw = {}
    for f in dataclasses.fields(ModelData):
        if f.name == "levels" or f.name not in top:
            continue
        v = top[f.name]
        if f.name in _INDEX_FIELDS:
            kw[f.name] = None if v is None else int(np.asarray(v))
        else:
            kw[f.name] = None if v is None else _tensor(f.name, v, device,
                                                        dtype)
    # the GammaV block's constants (they never change during a fit)
    kw["TtT"] = kw["Tr"].T @ kw["Tr"]
    kw["iUGmG"] = kw["iUGamma"] @ kw["mGamma"]
    return ModelData(levels=levels, **kw)


def state_from_numpy(s: dict, device, dtype=torch.float32) -> GibbsState:
    """``GibbsState`` from numpy arrays with a leading chain axis, keyed by
    field name (per-level fields as ``levels.<r>.<field>``)."""
    top, lvls = _split_levels(s)
    lnames = {f.name for f in dataclasses.fields(LevelState)}
    levels = tuple(LevelState(**{k: _tensor(k, v, device, dtype)
                                 for k, v in lv.items() if k in lnames})
                   for lv in lvls)
    names = {f.name for f in dataclasses.fields(GibbsState)} - {"levels"}
    return GibbsState(levels=levels,
                      **{k: _tensor(k, top[k], device, dtype) for k in names})


# ---------------------------------------------------------------------------
# a rank's block on a site mesh (the JAX package's place_on_mesh with the
# site tables, hmsc_tpu/mcmc/partition.py:302-320)
# ---------------------------------------------------------------------------

def site_slice_data(data: ModelData, ctx) -> ModelData:
    """The rank's block of ``data`` by :data:`partition.DATA_SITE_DIMS` and
    :data:`partition.PORT_SITE_DIMS`: its rows of Y, Ymask, X and each
    level's ``pi_row`` / ``x_row`` (which keep GLOBAL unit indices), and
    its units of an NNGP level's grids (the lists keep GLOBAL neighbour
    indices).  An NNGP level's reverse-neighbour CSR becomes the rank's
    local one (:func:`reverse_neighbours` of its rows over the level's
    units: B8e's adjoint), and ``nn_full`` keeps the level's whole
    structure for the dense draw.  The identity when ``ctx`` has no site
    axis."""
    if ctx is None or not ctx.has_sites:
        return data
    from .partition import DATA_SITE_DIMS
    top = {k: ctx.slice_site(getattr(data, k), DATA_SITE_DIMS[k])
           for k in ("Y", "Ymask", "X")}
    return data.replace(levels=tuple(site_slice_level(lvd, ctx)
                                     for lvd in data.levels), **top)


def site_slice_level(lvd: LevelData, ctx) -> LevelData:
    """One level of :func:`site_slice_data`: the rank's rows of ``pi_row``
    and ``x_row``, and of an NNGP level its units of the grids, its local
    reverse-neighbour CSR and the whole structure in ``nn_full``."""
    from .partition import DATA_SITE_DIMS, PORT_SITE_DIMS
    dims = {**DATA_SITE_DIMS, **PORT_SITE_DIMS}
    kw = {}
    for f in dataclasses.fields(LevelData):
        v = getattr(lvd, f.name)
        if v is not None and f.name in dims:
            kw[f.name] = ctx.slice_site(v, dims[f.name])
    if lvd.nn_idx is not None:
        npr = lvd.nn_idx.shape[0]
        ptr, pos = reverse_neighbours(kw["nn_idx"].cpu().numpy(),
                                      kw["nn_n"].cpu().numpy(), npr)
        dev = lvd.nn_idx.device
        kw["rev_ptr"] = torch.tensor(ptr, dtype=torch.int32, device=dev)
        kw["rev_pos"] = torch.tensor(pos, dtype=torch.int32, device=dev)
        kw["nn_full"] = (lvd.nn_idx, lvd.nn_n, lvd.rev_ptr, lvd.rev_pos)
    return lvd.replace(**kw)


def site_slice_state(state: GibbsState, ctx) -> GibbsState:
    """The rank's block of a chain-stacked state by
    :data:`partition.STATE_SITE_DIMS`: its rows of Z and units of each
    level's Eta (the chain axis leads)."""
    if ctx is None or not ctx.has_sites:
        return state
    levels = tuple(lv.replace(Eta=ctx.slice_site(lv.Eta, 1))
                   for lv in state.levels)
    return state.replace(Z=ctx.slice_site(state.Z, 1), levels=levels)


def site_gather_state(state: GibbsState, ctx) -> GibbsState:
    """The full-width state from each rank's block (every rank gets it)."""
    if ctx is None or not ctx.has_sites:
        return state
    levels = tuple(lv.replace(Eta=ctx.gather_site(lv.Eta, 1))
                   for lv in state.levels)
    return state.replace(Z=ctx.gather_site(state.Z, 1), levels=levels)
