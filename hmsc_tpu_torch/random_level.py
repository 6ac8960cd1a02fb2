"""Random-level specification (reference ``R/HmscRandomLevel.R:38-94``,
``R/setPriors.HmscRandomLevel.R:18-110``).

A random level describes one grouping factor of the study design whose units
carry latent factors: unstructured, spatially structured (``Full`` exact GP,
``GPP`` knot-based predictive process, ``NNGP`` nearest-neighbour GP), built
from a distance matrix, or covariate-dependent (``x_data``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["HmscRandomLevel", "set_priors_random_level"]

_SPATIAL_METHODS = ("Full", "GPP", "NNGP")


class HmscRandomLevel:
    """Specification of one random level.

    Exactly one of ``s_data`` (spatial coordinates), ``dist_mat``, ``units``,
    or ``n_units`` identifies the level's units; ``x_data`` adds
    covariate-dependent associations and may be combined with the others
    (mirroring the reference's argument contract).
    """

    def __init__(self, s_data=None, s_method: str = "Full", dist_mat=None,
                 x_data=None, units=None, n_units=None, n_neighbours=None,
                 s_knot=None, priors: bool = True):
        if all(a is None for a in (s_data, dist_mat, x_data, units, n_units)):
            raise ValueError("HmscRandomLevel: At least one argument must be specified")
        if s_data is not None and dist_mat is not None:
            raise ValueError("HmscRandomLevel: sData and distMat cannot both be specified")
        if s_method not in _SPATIAL_METHODS:
            raise ValueError(f"HmscRandomLevel: sMethod must be one of {_SPATIAL_METHODS}")

        self.pi: list[str] | None = None   # unit names
        self.s = None                      # (N, sDim) coordinates
        self.s_dim = 0
        self.spatial_method = None
        self.x = None                      # (N, xDim) covariate values
        self.x_dim = 0
        self.N: int | None = None
        self.dist_mat = None
        self.n_neighbours = n_neighbours
        self.s_knot = None

        if s_data is not None:
            s_arr, s_names = _as_named_matrix(s_data, "sData")
            self.s = s_arr
            self.N = s_arr.shape[0]
            self.pi = sorted(s_names)
            # keep coordinate rows addressable by unit name
            self._s_index = {n: i for i, n in enumerate(s_names)}
            self.s_dim = s_arr.shape[1]
            self.spatial_method = s_method
            self.s_knot = None if s_knot is None else np.asarray(s_knot, dtype=float)
        if dist_mat is not None:
            dm, dm_names = _as_named_matrix(dist_mat, "distMat")
            if dm.shape[0] != dm.shape[1]:
                raise ValueError("HmscRandomLevel: distMat must be a square matrix")
            self.dist_mat = dm
            self._dist_names = dm_names
            self.N = dm.shape[0]
            self.pi = sorted(dm_names)
            self.spatial_method = s_method
            self.s_dim = np.inf
        if x_data is not None:
            x_arr, x_names = _as_named_matrix(x_data, "xData")
            if self.pi is not None:
                if any(n not in self.pi for n in x_names):
                    raise ValueError("HmscRandomLevel: duplicated specification of unit names")
            else:
                self.pi = sorted(x_names)
                self.N = x_arr.shape[0]
            self.x_dim = x_arr.shape[1]
            self.x = x_arr
            self._x_index = {n: i for i, n in enumerate(x_names)}
        if units is not None:
            if self.pi is not None:
                raise ValueError("HmscRandomLevel: duplicated specification of unit names")
            self.pi = [str(u) for u in dict.fromkeys(units)]
            self.N = len(self.pi)
            self.s_dim = 0
        if n_units is not None:
            if self.pi is not None:
                raise ValueError("HmscRandomLevel: duplicated specification of the number of units")
            self.N = int(n_units)
            self.pi = [str(i + 1) for i in range(self.N)]
            self.s_dim = 0

        # shrinkage-prior fields filled by set_priors_random_level
        self.nu = self.a1 = self.b1 = self.a2 = self.b2 = None
        self.alphapw = None
        self.nf_max: float = np.inf
        self.nf_min: int = 2
        if priors:
            set_priors_random_level(self, set_default=True)

    # -- conveniences -------------------------------------------------------
    def coords_for(self, unit_names) -> np.ndarray:
        """Coordinate rows for the given unit names (reference indexes ``s``
        by ``levels(dfPi)``, ``computeDataParameters.R:62``)."""
        return self.s[[self._s_index[str(n)] for n in unit_names], :]

    def dist_for(self, unit_names) -> np.ndarray:
        idx = [self._dist_names.index(str(n)) for n in unit_names]
        return self.dist_mat[np.ix_(idx, idx)]

    def x_for(self, unit_names) -> np.ndarray:
        return self.x[[self._x_index[str(n)] for n in unit_names], :]

    def __repr__(self):
        kind = ("spatial" if self.s_dim not in (0,) else
                ("covariate-dependent" if self.x_dim > 0 else "unstructured"))
        return (f"HmscRandomLevel({kind}, N={self.N}"
                + (f", method={self.spatial_method}" if self.spatial_method else "")
                + ")")


def _as_named_matrix(data, what: str) -> tuple[np.ndarray, list[str]]:
    """Accept a pandas DataFrame (row-name aware) or ndarray."""
    if hasattr(data, "values") and hasattr(data, "index"):
        return np.asarray(data.values, dtype=float), [str(i) for i in data.index]
    arr = np.asarray(data, dtype=float)
    if arr.ndim == 1:
        arr = arr[:, None]
    return arr, [str(i + 1) for i in range(arr.shape[0])]


def set_priors_random_level(rL: HmscRandomLevel, nu=None, a1=None, b1=None,
                            a2=None, b2=None, alphapw=None, nf_max=None,
                            nf_min=None, set_default: bool = False) -> HmscRandomLevel:
    """Multiplicative-gamma shrinkage prior (Bhattacharya-Dunson) and the
    discrete spatial-range grid (reference ``setPriors.HmscRandomLevel.R``)."""
    x_dim = max(rL.x_dim, 1)

    def _vec(val, default, name):
        if val is None:
            return np.full(x_dim, float(default)) if set_default else getattr(rL, name)
        val = np.atleast_1d(np.asarray(val, dtype=float))
        if val.size == 1:
            return np.full(x_dim, float(val[0]))
        if val.size != x_dim:
            raise ValueError(
                f"HmscRandomLevel.setPriors: length of {name} argument must be either 1 or rL$xDim")
        return val

    rL.nu = _vec(nu, 3, "nu")
    rL.a1 = _vec(a1, 50, "a1")
    rL.b1 = _vec(b1, 1, "b1")
    rL.a2 = _vec(a2, 50, "a2")
    rL.b2 = _vec(b2, 1, "b2")

    if alphapw is not None:
        if rL.s_dim == 0:
            raise ValueError("HmscRandomLevel.setPriors: prior for spatial scale was given, "
                             "but not spatial coordinates were specified")
        alphapw = np.asarray(alphapw, dtype=float)
        if alphapw.ndim != 2 or alphapw.shape[1] != 2:
            raise ValueError("HmscRandomLevel.setPriors: alphapw must be a matrix with two columns")
        rL.alphapw = alphapw
    elif set_default and rL.s_dim != 0:
        # 101-point grid: 0 .. bounding-box diagonal (or max distance),
        # P(alpha=0)=0.5, the rest uniform
        alpha_n = 100
        if rL.dist_mat is None:
            diag = float(np.sqrt(np.sum((rL.s.max(axis=0) - rL.s.min(axis=0)) ** 2)))
        else:
            diag = float(rL.dist_mat.max())
        grid = diag * np.arange(alpha_n + 1) / alpha_n
        w = np.concatenate([[0.5], np.full(alpha_n, 0.5 / alpha_n)])
        rL.alphapw = np.column_stack([grid, w])

    if nf_max is not None:
        rL.nf_max = nf_max
    elif set_default:
        rL.nf_max = np.inf
    if nf_min is not None:
        if nf_min > rL.nf_max:
            raise ValueError("HmscRandomLevel.setPriors: nfMin must be not greater than nfMax")
        rL.nf_min = int(nf_min)
    elif set_default:
        rL.nf_min = 2
    return rL
