"""The NNGP (Vecchia) and GPP (predictive-process) operators of the spatial
Eta and alpha updates, with the hand-written kernels B8a-B8d behind their
wrappers:

- B8a :func:`vecchia_riw`, :func:`vecchia_riw_t`, :func:`vecchia_pmv` —
  ``RiW x``, ``RiW' u`` and the CG sampler's ``P x = RiW'(RiW x) + LiSL x``
  (``csrc/vecchia_apply.cu``; the JAX package's ``vecchia_ops``), and
  :func:`vecchia_cg`, the CG Eta draw's whole solve in one launch (the JAX
  package's ``vecchia_cg_draw``, its loop on the device);
- B8e :func:`vecchia_site_riw_t`, :func:`vecchia_site_pmv` — one site
  mesh rank's partials of ``RiW' u`` and ``P x`` from its block of the
  level's rows (``csrc/vecchia_site.cu``; the JAX package's
  ``vecchia_ops_site`` before its psum);
- B8b :func:`nngp_quad_grid`, :func:`nngp_quad_at` — the prior quadratics
  over the alpha grid, or at each factor's alpha with the location move's
  ones-forms (``csrc/nngp_quad.cu``; ``eta_quad_grid``, ``eta_quad_at``,
  ``eta_ones_forms_at``);
- B8c :func:`nngp_riw_dense` — the dense precision ``iW = RiW' RiW`` below
  the dense/CG crossover, in one launch (``csrc/nngp_riw.cu``;
  ``_nngp_dense_iW``);
- B8d-1 :func:`gpp_unit` — the per-unit Woodbury blocks ``iA`` and
  ``chol(iA)`` of the GPP Eta draw (``csrc/gpp_unit.cu``; ``gpp_factor``);
- B8d-2 :func:`gpp_knot` — the knot correction ``H = blockdiag(F) - M' iA
  M``, summed and returned in float64 (``csrc/gpp_knot.cu``;
  ``gpp_factor``);
- B8d-3 :func:`gpp_quad_grid`, :func:`gpp_quad_at` — the GPP prior
  quadratics over the alpha grid, or at each factor's alpha with the
  ones-forms (``csrc/gpp_quad.cu``; the GPP branches of ``eta_quad_grid``,
  ``eta_quad_at``, ``eta_ones_forms_at``).

``lvd`` is a level's ``LevelData``: for NNGP ``nn_idx`` (np, k),
``nn_coef`` (G, np, k), ``nn_D`` (G, np), the lists and the grid with
the unit last, ``nn_idx_u`` (k, np) and ``nn_coef_u`` (G, k, np) (B8b's
grid mode reads those), ``nn_n`` and the reverse-neighbour CSR (``rev_ptr``,
``rev_pos``); for GPP ``idDg`` (G, np),
``idDW12g`` (G, np, nK), ``Fg`` and ``iFg`` (G, nK, nK; all but ``idDg`` in
float64) and ``alphapw`` (G, 2), whose grid points at alpha 0 switch the
knot algebra off (``W = I``).  ``alpha_idx`` (C, nf) picks each chain's factor's grid point, and
iterates are (C, np, nf).  The kernels read the grids in place at those
indices.  Each wrapper launches its kernel for CUDA tensors (or raises) and
runs the plain PyTorch version beside it only for tensors on the CPU; every
launch is counted in :data:`hmsc_tpu_torch.kernels.launches`.

Under a precision policy (:mod:`hmsc_tpu_torch.ops.mixed`) B8b's at-alpha
mode and B8c take the bfloat16 shadows of ``nn_coef`` and ``nn_D``
(``coef=``, ``D=``) and run their bf16-grid forms, rounding as the JAX
package's mx calls do; the GPP kernels take a level whose ``idDg`` is its
shadow widened back to float32, the values the JAX package's gathered
bf16 slices widen to before any arithmetic.
"""

from __future__ import annotations

import torch

from .. import kernels as K
from .linalg import chol_spd
from .mixed import round_bf16

__all__ = ["vecchia_riw", "vecchia_riw_t", "vecchia_pmv", "vecchia_cg",
           "vecchia_site_riw_t", "vecchia_site_pmv",
           "cg_geometry", "cg_frozen", "nngp_quad_grid",
           "nngp_quad_at", "nngp_riw_dense", "iw_geometry", "gpp_unit",
           "gpp_knot", "gpp_quad_grid", "gpp_quad_at", "gpp_alpha_zero",
           "gpp_m1_at"]

# the per-unit blocks of B8d-1 are held in registers up to this many factors
# (csrc/gpp_unit.cu instantiates 1..16)
_GPP_NF_MAX = 16


def _check(name, lvd, alpha_idx, *tensors):
    """Device, type and layout checks before a launch."""
    dev = lvd.nn_coef.device
    for label, t, dtype in ((("nn_idx", lvd.nn_idx, torch.int32),
                             ("nn_coef", lvd.nn_coef, torch.float32),
                             ("nn_D", lvd.nn_D, torch.float32))
                            + ((("alpha_idx", alpha_idx, torch.int32),)
                               if alpha_idx is not None else ())
                            + tuple(tensors)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous {dtype} "
                             f"tensor on {dev}")


def _grid_at(lvd, alpha_idx, coef=None, D=None):
    """(coef (C, nf, np, k), D (C, nf, np)) at each factor's alpha, from
    the level's grids or the given ones (widened to float32)."""
    a = alpha_idx.long()
    coef = lvd.nn_coef if coef is None else coef
    D = lvd.nn_D if D is None else D
    return coef[a].to(lvd.nn_coef.dtype), D[a].to(lvd.nn_D.dtype)


def _bf16_grids(lvd, coef, D):
    """``(coef, D, bf16)`` for a kernel's grid reads: both bfloat16 shadows
    (the bf16-grid form), or float32 grids where either is not staged (a
    lone shadow widened: the values the JAX package reads)."""
    coef = lvd.nn_coef if coef is None else coef
    D = lvd.nn_D if D is None else D
    if coef.dtype == D.dtype == torch.bfloat16:
        return coef.contiguous(), D.contiguous(), True
    return coef.to(lvd.nn_coef.dtype), D.to(lvd.nn_D.dtype), False


# ---------------------------------------------------------------------------
# B8a: the Vecchia factor and its transpose
# ---------------------------------------------------------------------------

def vecchia_riw(lvd, alpha_idx, x, twice: bool = False):
    """``RiW x`` per (chain, factor): ``(x_i - sum_k A[i,k] x_nn[i,k]) /
    sqrt(D_i)``, divided once more by ``sqrt(D_i)`` when ``twice`` (the
    ``t`` that :func:`vecchia_riw_t` takes with ``scaled=True``)."""
    if not x.is_cuda:
        return _vecchia_riw_plain(lvd, alpha_idx, x, twice)
    C, npr, nf = x.shape
    _check("vecchia_riw", lvd, alpha_idx, ("x", x, torch.float32))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = K.library().hmsc_vecchia_fwd(
            x.data_ptr(), lvd.nn_idx.data_ptr(), lvd.nn_coef.data_ptr(),
            lvd.nn_D.data_ptr(), alpha_idx.data_ptr(), out.data_ptr(), C,
            npr, nf, lvd.nn_idx.shape[1], int(twice), K.stream_of(x))
    K.check(code, "vecchia_apply")
    K.launches["vecchia_apply"] += 1
    return out


def vecchia_riw_t(lvd, alpha_idx, u, LiSL=None, x=None,
                  scaled: bool = False):
    """``RiW' u`` per (chain, factor), plus ``LiSL x`` (per unit, over
    factors) when ``LiSL`` (C, np, nf, nf) and ``x`` are given.  ``u`` is
    divided by ``sqrt(D)`` first unless ``scaled`` says the caller already
    did."""
    if not u.is_cuda:
        return _vecchia_riw_t_plain(lvd, alpha_idx, u, LiSL, x, scaled)
    C, npr, nf = u.shape
    extra = (("u", u, torch.float32), ("rev_ptr", lvd.rev_ptr, torch.int32),
             ("rev_pos", lvd.rev_pos, torch.int32))
    if LiSL is not None:
        if LiSL.shape != (C, npr, nf, nf) or x is None or x.shape != u.shape:
            raise ValueError("vecchia_riw_t: LiSL must be (C, np, nf, nf) "
                             "with x shaped like u")
        extra += (("LiSL", LiSL, torch.float32), ("x", x, torch.float32))
    _check("vecchia_riw_t", lvd, alpha_idx, *extra)
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        code = K.library().hmsc_vecchia_adj(
            u.data_ptr(), lvd.rev_ptr.data_ptr(), lvd.rev_pos.data_ptr(),
            lvd.nn_coef.data_ptr(), lvd.nn_D.data_ptr(), alpha_idx.data_ptr(),
            None if LiSL is None else LiSL.data_ptr(),
            None if LiSL is None else x.data_ptr(), out.data_ptr(), C, npr,
            nf, lvd.nn_idx.shape[1], int(not scaled), K.stream_of(u))
    K.check(code, "vecchia_apply")
    K.launches["vecchia_apply"] += 1
    return out


def vecchia_pmv(lvd, alpha_idx, x, LiSL):
    """The NNGP full-conditional precision applied to ``x``: ``P x =
    RiW'(RiW x) + LiSL x`` (two launches of B8a on the card)."""
    t = vecchia_riw(lvd, alpha_idx, x, twice=True)
    return vecchia_riw_t(lvd, alpha_idx, t, LiSL, x, scaled=True)


# ---------------------------------------------------------------------------
# B8e: a site mesh rank's partial of the Vecchia applies
# ---------------------------------------------------------------------------

def vecchia_site_riw_t(lvd, alpha_idx, u, n_units: int, offset: int):
    """A rank's partial of ``RiW' u``: ``lvd`` is its block of an NNGP
    level's rows (``structs.site_slice_data``: lists with global
    indices, grids, the local reverse-neighbour CSR), ``u`` (C, np_l, nf)
    its rows' values, the block starting at unit ``offset`` of
    ``n_units``.  Returns the full-width (C, n_units, nf) partial; summed
    over the ranks it is :func:`vecchia_riw_t` of the whole ``u``."""
    return _vecchia_site(lvd, alpha_idx, None, u, None, n_units, offset)


def vecchia_site_pmv(lvd, alpha_idx, x, LiSL, offset: int):
    """A rank's partial of ``P x = RiW'(RiW x) + LiSL x``: ``x`` (C, np,
    nf) the full iterate, ``LiSL`` (C, np_l, nf, nf) the rank's block of
    the per-unit gram, ``lvd`` and ``offset`` as for
    :func:`vecchia_site_riw_t`.  Summed over the ranks it is
    :func:`vecchia_pmv`."""
    return _vecchia_site(lvd, alpha_idx, x, None, LiSL, x.shape[1], offset)


def _vecchia_site(lvd, alpha_idx, x, u, LiSL, npr, off):
    """B8e, two launches (the rank's rows' t, then every global row from
    the local reverse CSR); the plain version on the CPU."""
    src = x if x is not None else u
    if not src.is_cuda:
        return _vecchia_site_plain(lvd, alpha_idx, x, u, LiSL, npr, off)
    np_l, k = lvd.nn_idx.shape
    C, nf = alpha_idx.shape
    if not 0 <= off <= npr - np_l or lvd.rev_ptr.shape != (npr + 1,):
        raise ValueError(f"vecchia_site: rows {off} to {off + np_l} of "
                         f"{npr} with a reverse CSR of "
                         f"{tuple(lvd.rev_ptr.shape)}")
    extra = (("rev_ptr", lvd.rev_ptr, torch.int32),
             ("rev_pos", lvd.rev_pos, torch.int32))
    if x is not None:
        if x.shape != (C, npr, nf) or LiSL.shape != (C, np_l, nf, nf):
            raise ValueError("vecchia_site_pmv: x must be (C, np, nf) and "
                             "LiSL (C, np_l, nf, nf)")
        extra += (("x", x, torch.float32), ("LiSL", LiSL, torch.float32))
    elif u.shape != (C, np_l, nf):
        raise ValueError("vecchia_site_riw_t: u must be (C, np_l, nf)")
    else:
        extra += (("u", u, torch.float32),)
    _check("vecchia_site", lvd, alpha_idx, *extra)
    t = src.new_empty((C, np_l, nf))
    out = src.new_empty((C, npr, nf))
    ptr = lambda v: None if v is None else v.data_ptr()
    with torch.cuda.device(src.device):
        code = K.library().hmsc_vecchia_site(
            ptr(x), ptr(u), lvd.nn_idx.data_ptr(), lvd.nn_coef.data_ptr(),
            lvd.nn_D.data_ptr(), alpha_idx.data_ptr(),
            lvd.rev_ptr.data_ptr(), lvd.rev_pos.data_ptr(), ptr(LiSL),
            t.data_ptr(), out.data_ptr(), C, npr, np_l, int(off), nf, k,
            K.stream_of(src))
    K.check(code, "vecchia_site")
    K.launches["vecchia_site"] += 1
    return out


def _vecchia_site_plain(lvd, alpha_idx, x, u, LiSL, npr, off):
    """The JAX ``vecchia_ops_site`` per chain, before its psum: the local
    rows' t (the forward at the global neighbours for ``pmv``), the
    products scattered with a segment sum over the global units, plus the
    rank's own rows' t (+ ``LiSL x``) at their offset."""
    coef, D = _grid_at(lvd, alpha_idx)                   # (C, nf, np_l, k)
    sqD = torch.sqrt(D).transpose(1, 2)                  # (C, np_l, nf)
    C, np_l, nf = sqD.shape
    k = lvd.nn_idx.shape[1]
    nn = lvd.nn_idx.long()
    if x is not None:
        x_l = x[:, off:off + np_l]
        red = torch.einsum("cfik,cikf->cif", coef, x[:, nn])
        t = (x_l - red) / sqD / sqD
    else:
        t = u / sqD
    contrib = -torch.einsum("cfik,cif->cikf", coef, t).reshape(C, np_l * k,
                                                                nf)
    seg = t.new_zeros((C, npr, nf))
    seg.index_add_(1, nn.reshape(-1), contrib)
    own = t if LiSL is None else t + torch.einsum("cufg,cug->cuf", LiSL,
                                                  x_l)
    full = t.new_zeros((C, npr, nf))
    full[:, off:off + np_l] = own
    return seg + full


def _vecchia_riw_plain(lvd, alpha_idx, x, twice):
    """The JAX ``vecchia_ops`` forward (gather, einsum) per chain."""
    coef, D = _grid_at(lvd, alpha_idx)
    sqD = torch.sqrt(D).transpose(1, 2)                  # (C, np, nf)
    xg = x[:, lvd.nn_idx.long()]                         # (C, np, k, nf)
    red = torch.einsum("cfik,cikf->cif", coef, xg)
    r = (x - red) / sqD
    return r / sqD if twice else r


def _vecchia_riw_t_plain(lvd, alpha_idx, u, LiSL, x, scaled):
    """The JAX ``riw_t`` (the products scattered with a segment sum) with
    the pads of short neighbour lists left out, as the kernel leaves them
    out (they add exact zeros to unit 0)."""
    coef, D = _grid_at(lvd, alpha_idx)
    sqD = torch.sqrt(D).transpose(1, 2)
    t = u if scaled else u / sqD
    C, npr, nf = t.shape
    k = lvd.nn_idx.shape[1]
    real = (torch.arange(k, device=t.device)[None, :]
            < lvd.nn_n[:, None]).reshape(-1)
    contrib = -torch.einsum("cfik,cif->cikf", coef, t).reshape(C, npr * k,
                                                                nf)
    seg = t.new_zeros((C, npr, nf))
    seg.index_add_(1, lvd.nn_idx.reshape(-1).long()[real], contrib[:, real])
    out = t + seg
    if LiSL is not None:
        out = out + torch.einsum("cufg,cug->cuf", LiSL, x)
    return out


def cg_frozen(pmv, b, x0, tol, maxiter, first_check=0, every=1):
    """Conjugate gradients for ``P x = b`` per chain (iterates (C, np, nf)),
    from ``x0``: ``jax.scipy.sparse.linalg.cg`` with ``tol`` relative to
    ``|b|``, ``atol = 0`` and ``maxiter``, converged chains frozen (the JAX
    package's ``while_loop`` under ``vmap``).  The host reads the
    convergence at iteration ``first_check`` and every ``every`` after it;
    the solution does not depend on when.  Returns ``(x, relative residual
    (C,), iterations the loop ran, the largest per-chain count, per-chain
    iterations (C,))``.  ``pmv`` is applied ``iterations + 2`` times."""
    def dot(u, v):
        return (u * v).sum(dim=(1, 2))

    atol2 = tol ** 2 * dot(b, b)
    x = x0
    r = b - pmv(x0)
    p = r
    gamma = dot(r, r)
    k = torch.zeros_like(gamma, dtype=torch.int32)
    active = (gamma > atol2) & (k < maxiter)
    it, kmax = 0, -1
    while it < maxiter:
        if it >= first_check and (it - first_check) % every == 0:
            # one read: -1 while a chain runs on, else the largest count
            kmax = int(torch.where(active.any(), -1, k.max()))
            if kmax >= 0:
                break
        Ap = pmv(p)
        a = gamma / dot(p, Ap)
        x_ = x + a[:, None, None] * p
        r_ = r - a[:, None, None] * Ap
        gamma_ = dot(r_, r_)
        p_ = r_ + (gamma_ / gamma)[:, None, None] * p
        on = active[:, None, None]
        x = torch.where(on, x_, x)
        r = torch.where(on, r_, r)
        p = torch.where(on, p_, p)
        gamma = torch.where(active, gamma_, gamma)
        k = k + active.to(torch.int32)
        active = (gamma > atol2) & (k < maxiter)
        it += 1
    if kmax < 0:                          # stopped by maxiter, not a read
        kmax = int(k.max())
    res = torch.linalg.vector_norm(pmv(x) - b, dim=(1, 2)) / torch.clamp_min(
        torch.linalg.vector_norm(b, dim=(1, 2)), 1e-30)
    return x, res, it, kmax, k


# csrc/vecchia_apply.cu · vecchia_cg_kernel: a thread a unit (all its
# factors, nf <= 16), CTAs of up to 256 threads; a chain's cluster takes as
# many CTAs (a power of two up to 8) as keep ~_CG_UNITS_A_CTA units a CTA
# (scripts/vecchia_cg_sweep.py: at np 1000 clusters of 8 a little ahead of
# 4, both well ahead of 1 or 2);
# p and t whole in each CTA and x, r, Ap, b its units' slices in shared
# memory while they fit _CG_SMEM_MAX bytes, else in a global scratch
_CG_THREADS, _CG_UNITS_A_CTA, _CG_MAX_CLUSTER, _CG_MAX_NF = 256, 128, 8, 16
_CG_SMEM_MAX = 227 * 1024
_CG_SCRATCH = 128                       # floats: the dot products' partials


def cg_geometry(npr: int, nf: int):
    """The fused CG draw's launch for a level of ``npr`` units and ``nf``
    factors: ``(G CTAs a chain's cluster, units a CTA, threads a CTA,
    shared-memory bytes a CTA, vectors in global memory)``."""
    G = 1
    while G < _CG_MAX_CLUSTER and npr > G * _CG_UNITS_A_CTA:
        G *= 2
    units = -(-npr // G)
    threads = min(_CG_THREADS, -(-units // 32) * 32)
    smem = 4 * (_CG_SCRATCH + 2 * npr * nf + 4 * units * nf)
    if smem <= _CG_SMEM_MAX:
        return G, units, threads, smem, False
    return G, units, threads, 4 * _CG_SCRATCH, True


def vecchia_cg(lvd, alpha_idx, LiSL, F, eps1, b_like, x0, tol: float,
               maxiter: int):
    """The NNGP CG Eta draw's solve, each chain to its own convergence:
    ``b = F + RiW' eps1 + b_like``, then CG on ``P x = b`` from ``x0``
    (:func:`cg_frozen`'s iterates), then the true relative residual.
    Returns ``(x, res (C,), iterations (C,) int32)``, all on the device: on
    the card one launch, with no host read."""
    if not F.is_cuda:
        return _vecchia_cg_plain(lvd, alpha_idx, LiSL, F, eps1, b_like, x0,
                                 tol, maxiter)
    C, npr, nf = F.shape
    shaped = (("F", F), ("eps1", eps1), ("b_like", b_like), ("x0", x0))
    for label, t in shaped:
        if t.shape != (C, npr, nf):
            raise ValueError(f"vecchia_cg: {label} must be (C, np, nf)")
    if LiSL.shape != (C, npr, nf, nf):
        raise ValueError("vecchia_cg: LiSL must be (C, np, nf, nf)")
    if nf > _CG_MAX_NF:
        raise ValueError(f"vecchia_cg: at most {_CG_MAX_NF} factors, got "
                         f"{nf}")
    _check("vecchia_cg", lvd, alpha_idx,
           ("rev_ptr", lvd.rev_ptr, torch.int32),
           ("rev_pos", lvd.rev_pos, torch.int32),
           ("LiSL", LiSL, torch.float32),
           *((label, t, torch.float32) for label, t in shaped))
    G, units, threads, smem, in_global = cg_geometry(npr, nf)
    x = torch.empty_like(F)
    res = F.new_empty((C,))
    iters = torch.empty((C,), dtype=torch.int32, device=F.device)
    work = F.new_empty((C, 6, npr * nf)) if in_global else None
    with torch.cuda.device(F.device):
        code = K.library().hmsc_vecchia_cg(
            lvd.nn_idx.data_ptr(), lvd.nn_coef.data_ptr(),
            lvd.nn_D.data_ptr(), alpha_idx.data_ptr(),
            lvd.rev_ptr.data_ptr(), lvd.rev_pos.data_ptr(), LiSL.data_ptr(),
            F.data_ptr(), eps1.data_ptr(), b_like.data_ptr(), x0.data_ptr(),
            x.data_ptr(), res.data_ptr(), iters.data_ptr(),
            None if work is None else work.data_ptr(), C, npr, nf,
            lvd.nn_idx.shape[1], G, units, threads, int(maxiter),
            float(tol) ** 2,
            smem, K.stream_of(F))
    K.check(code, "vecchia_apply")
    K.launches["vecchia_apply"] += 1
    return x, res, iters


def _vecchia_cg_plain(lvd, alpha_idx, LiSL, F, eps1, b_like, x0, tol,
                      maxiter):
    """:func:`vecchia_cg` from the plain applies: the loop reads the
    convergence every iteration, so it stops at the largest per-chain
    count."""
    def pmv(x):
        t = _vecchia_riw_plain(lvd, alpha_idx, x, True)
        return _vecchia_riw_t_plain(lvd, alpha_idx, t, LiSL, x, True)

    b = F + _vecchia_riw_t_plain(lvd, alpha_idx, eps1, None, None,
                                 False) + b_like
    x, res, _, _, k = cg_frozen(pmv, b, x0, tol, maxiter)
    return x, res, k


# ---------------------------------------------------------------------------
# B8b: prior quadratics over the alpha grid and at each factor's alpha
# ---------------------------------------------------------------------------

# the shared memory a grid-mode block may take for eta; the largest
# at-alpha cluster (the portable size)
_QUAD_SMEM = 200 * 1024
_CLUSTER_MAX = 8


def quad_geometry(C: int, npr: int, nf: int) -> dict:
    """Grid-mode launch shape of B8b (``csrc/nngp_quad.cu``), which runs a
    block of 512 threads a grid point, a thread a unit at a time: eta whole
    in each block's shared memory (``eta_smem``) when it fits in
    ``_QUAD_SMEM``, else read in place."""
    return dict(eta_smem=4 * C * npr * nf <= _QUAD_SMEM)


def quad_at_geometry(npr: int) -> dict:
    """At-alpha launch shape of B8b: ``S`` blocks a cluster a column, each
    over ``units`` units, a thread a unit (``threads``: 128 or 256)."""
    S = max(1, min(_CLUSTER_MAX, -(-npr // 128)))
    units = -(-npr // S)
    return dict(S=S, units=units, threads=128 if units <= 128 else 256)


def _check_unit_last(name, lvd, eta, u_off=0):
    """:func:`_check` of grid mode's operands: the level's unit-last lists
    and grid, their shapes those of ``nn_idx`` and ``nn_coef`` with the
    unit last, and eta, whose units ``u_off`` on are the grids'."""
    G, npr, k = lvd.nn_coef.shape
    if (tuple(lvd.nn_idx_u.shape) != (k, npr)
            or tuple(lvd.nn_coef_u.shape) != (G, k, npr)
            or eta.dim() != 3 or not 0 <= u_off <= eta.shape[1] - npr):
        raise ValueError(f"{name}: nn_idx_u must be (k, np) = {(k, npr)}, "
                         f"nn_coef_u (G, k, np) = {(G, k, npr)} and eta (C, "
                         f"np, nf), got {tuple(lvd.nn_idx_u.shape)}, "
                         f"{tuple(lvd.nn_coef_u.shape)}, {tuple(eta.shape)}")
    _check(name, lvd, None, ("eta", eta, torch.float32),
           ("nn_idx_u", lvd.nn_idx_u, torch.int32),
           ("nn_coef_u", lvd.nn_coef_u, torch.float32))


def nngp_quad_grid(lvd, eta, u_off: int = 0):
    """``v[c, f, g] = eta_cf' iW_g eta_cf`` for every grid point g: the
    Vecchia residuals' squares over D, summed over units.  (C, nf, G).
    On a site mesh ``lvd`` is a rank's block of the level's units, ``eta``
    the level's whole and ``u_off`` the block's first unit: the sum runs
    over the block (the rank's partial, which the caller sums over the
    ranks)."""
    if not eta.is_cuda:
        return _nngp_quad_grid_plain(lvd, eta, u_off)
    C, np_eta, nf = eta.shape
    G, npr, k = lvd.nn_coef.shape
    _check_unit_last("nngp_quad_grid", lvd, eta, u_off)
    out = eta.new_empty((C, nf, G))
    q = quad_geometry(C, np_eta, nf)
    with torch.cuda.device(eta.device):
        code = K.library().hmsc_nngp_quad_grid(
            eta.data_ptr(), lvd.nn_idx_u.data_ptr(), lvd.nn_coef_u.data_ptr(),
            lvd.nn_D.data_ptr(), out.data_ptr(), C, npr, nf, k, G,
            int(q["eta_smem"]), np_eta, int(u_off), K.stream_of(eta))
    K.check(code, "nngp_quad")
    K.launches["nngp_quad"] += 1
    return out


def nngp_quad_at(lvd, alpha_idx, eta, coef=None, D=None, u_off: int = 0):
    """At each factor's alpha: ``(q, q1, s)`` = (``eta' iW eta``, ``1' iW
    1``, ``1' iW eta``), stacked on the last axis: (C, nf, 3).  ``coef``
    and ``D``, the bfloat16 shadows of the grids, select the bf16-grid
    form (the neighbours' eta rounded to bfloat16 in the prediction,
    ``sqrt(D)`` rounded in the ones-forms).  ``u_off``: a site mesh's
    rank's partial over its block of units, as :func:`nngp_quad_grid`."""
    coef, D, bf16 = _bf16_grids(lvd, coef, D)
    if not eta.is_cuda:
        if bf16:
            return _nngp_quad_at_bf16_plain(lvd, alpha_idx, eta, coef, D)
        return _nngp_quad_at_plain(lvd, alpha_idx, eta, coef, D, u_off)
    C, np_eta, nf = eta.shape
    npr = lvd.nn_idx.shape[0]
    if eta.dim() != 3 or not 0 <= u_off <= np_eta - npr:
        raise ValueError(f"nngp_quad_at: eta must be (C, np, nf) holding "
                         f"units {u_off} to {u_off + npr}, got "
                         f"{tuple(eta.shape)}")
    _check("nngp_quad_at", lvd, alpha_idx, ("eta", eta, torch.float32))
    if coef.shape != lvd.nn_coef.shape or D.shape != lvd.nn_D.shape or (
            coef.device != eta.device or D.device != eta.device):
        raise ValueError("nngp_quad_at: coef and D must have the level's "
                         "grids' shapes, on eta's device")
    out = eta.new_empty((C, nf, 3))
    q = quad_at_geometry(npr)
    with torch.cuda.device(eta.device):
        code = K.library().hmsc_nngp_quad_at(
            eta.data_ptr(), lvd.nn_idx.data_ptr(), coef.data_ptr(),
            D.data_ptr(), alpha_idx.data_ptr(), out.data_ptr(), C,
            npr, nf, lvd.nn_idx.shape[1], q["S"], q["units"], q["threads"],
            int(bf16), np_eta, int(u_off), K.stream_of(eta))
    K.check(code, "nngp_quad")
    K.launches["nngp_quad"] += 1
    return out


def _own_units(lvd, eta, u_off):
    """The units of ``eta`` the level's (or a rank's block's) rows are."""
    return eta[:, u_off:u_off + lvd.nn_idx.shape[0]]


def _nngp_quad_grid_plain(lvd, eta, u_off=0):
    """The NNGP branch of the JAX ``eta_quad_grid``, per chain."""
    eta_nn = eta[:, lvd.nn_idx.long()]                   # (C, np, k, nf)
    pred = torch.einsum("gik,cikh->chgi", lvd.nn_coef, eta_nn)
    res = (_own_units(lvd, eta, u_off).transpose(1, 2)[:, :, None, :]
           - pred)                                       # (C, nf, G, np)
    return (res ** 2 / lvd.nn_D[None, None]).sum(dim=3)


def _nngp_quad_at_bf16_plain(lvd, alpha_idx, eta, coef16, D16):
    """The NNGP branches of the JAX ``eta_quad_at`` and
    ``eta_ones_forms_at`` under a scope, per chain: the staged grids
    widened, the prediction an mx einsum (the neighbours' eta rounded),
    ``sqrt(D)`` in bfloat16."""
    coef, D = _grid_at(lvd, alpha_idx, coef16, D16)      # (C, nf, np, k)
    pred = torch.einsum("chik,cikh->chi", coef,
                        round_bf16(eta[:, lvd.nn_idx.long()]))
    res = eta.transpose(1, 2) - pred                     # (C, nf, np)
    q = (res ** 2 / D).sum(dim=2)
    sqD = round_bf16(torch.sqrt(D))
    r1 = (1.0 - coef.sum(dim=3)) / sqD
    re = res / sqD
    return torch.stack([q, (r1 ** 2).sum(dim=2), (r1 * re).sum(dim=2)],
                       dim=2)


def _nngp_quad_at_plain(lvd, alpha_idx, eta, coef=None, D=None, u_off=0):
    """The NNGP branches of the JAX ``eta_quad_at`` and
    ``eta_ones_forms_at``, per chain."""
    coef, D = _grid_at(lvd, alpha_idx, coef, D)          # (C, nf, np, k)
    pred = torch.einsum("chik,cikh->chi", coef, eta[:, lvd.nn_idx.long()])
    res = _own_units(lvd, eta, u_off).transpose(1, 2) - pred  # (C, nf, np)
    q = (res ** 2 / D).sum(dim=2)
    sqD = torch.sqrt(D)
    r1 = (1.0 - coef.sum(dim=3)) / sqD
    re = res / sqD
    return torch.stack([q, (r1 ** 2).sum(dim=2), (r1 * re).sum(dim=2)],
                       dim=2)


# ---------------------------------------------------------------------------
# B8c: the dense Vecchia precision
# ---------------------------------------------------------------------------

# B8c: rows of iW a block (a warp a row), and the shared memory a block of
# the H100 can use
_IW_ROWS = 8
_IW_SMEM_MAX = 227 * 1024


def iw_geometry(npr: int, k: int, nnz: int) -> dict:
    """B8c's launch shape: ``rows`` rows of iW a block of ``rows`` warps,
    ``tiles`` blocks a factor, and the block's dynamic shared memory in
    bytes: 1 / sqrt(D) and the counts (np each), the lists and scaled
    coefficients (np k each), the tile's slice of the reverse-neighbour
    positions (nnz at most), its rows' offsets there (rows + 1) and its
    rows of iW (rows np)."""
    rows = max(1, min(_IW_ROWS, npr, 32))
    smem = 4 * (2 * npr + 2 * npr * k + nnz + rows + 1 + rows * npr)
    return {"rows": rows, "tiles": -(-npr // rows), "smem": smem}


def nngp_riw_dense(lvd, alpha_idx, coef=None, D=None):
    """The dense Vecchia precision ``iW = RiW' RiW`` of each chain's factors
    at their alpha: (C, nf, np, np), ``RiW`` rows ``(e_i - sum_k A[i,k]
    e_nn[i,k]) / sqrt(D_i)``, in one launch.  ``coef`` and ``D``, the
    bfloat16 shadows of the grids, select the bf16-grid form (the shadows
    read and widened, iW built in float32)."""
    coef, D, bf16 = _bf16_grids(lvd, coef, D)
    if not lvd.nn_coef.is_cuda:
        return _nngp_riw_dense_plain(lvd, alpha_idx, coef, D)
    C, nf = alpha_idx.shape
    npr, k = lvd.nn_idx.shape
    _check("nngp_riw_dense", lvd, alpha_idx,
           ("nn_n", lvd.nn_n, torch.int32),
           ("rev_ptr", lvd.rev_ptr, torch.int32),
           ("rev_pos", lvd.rev_pos, torch.int32))
    nnz = lvd.rev_pos.numel()
    geo = iw_geometry(npr, k, nnz)
    if geo["smem"] > _IW_SMEM_MAX:
        raise ValueError(f"nngp_riw_dense: np {npr} with {k} neighbours "
                         f"needs {geo['smem']} bytes of shared memory a "
                         f"block (at most {_IW_SMEM_MAX})")
    if coef.shape != lvd.nn_coef.shape or D.shape != lvd.nn_D.shape or (
            coef.device != lvd.nn_coef.device
            or D.device != lvd.nn_coef.device):
        raise ValueError("nngp_riw_dense: coef and D must have the level's "
                         "grids' shapes, on its device")
    out = lvd.nn_coef.new_empty((C, nf, npr, npr))
    with torch.cuda.device(out.device):
        code = K.library().hmsc_nngp_iw(
            lvd.nn_idx.data_ptr(), lvd.nn_n.data_ptr(), coef.data_ptr(),
            D.data_ptr(), lvd.rev_ptr.data_ptr(), lvd.rev_pos.data_ptr(),
            alpha_idx.data_ptr(), out.data_ptr(), C, nf, npr, k, nnz,
            geo["rows"], geo["smem"], int(bf16), K.stream_of(out))
    K.check(code, "nngp_riw")
    K.launches["nngp_riw"] += 1
    return out


def _nngp_riw_scatter(lvd, alpha_idx, coef=None, D=None):
    """The JAX ``_nngp_dense_iW`` scatter (before its gram), per chain: the
    dense factor ``RiW`` (C, nf, np, np), from the level's grids or the
    given ones (bfloat16 shadows widened)."""
    coef, D = _grid_at(lvd, alpha_idx, coef, D)          # (C, nf, np, k)
    C, nf, npr, k = coef.shape
    RiW = coef.new_zeros((C, nf, npr, npr))
    ar = lambda n: torch.arange(n, device=coef.device)
    RiW.index_put_((ar(C)[:, None, None, None], ar(nf)[None, :, None, None],
                    ar(npr)[None, None, :, None],
                    lvd.nn_idx.long()[None, None]), -coef, accumulate=True)
    RiW = RiW + torch.eye(npr, dtype=coef.dtype, device=coef.device)
    return RiW / torch.sqrt(D)[..., None]


def _nngp_riw_dense_plain(lvd, alpha_idx, coef=None, D=None):
    """The JAX ``_nngp_dense_iW``, per chain: the scatter, then its gram
    (float32 whatever the grids' type, as under a scope)."""
    RiW = _nngp_riw_scatter(lvd, alpha_idx, coef, D)
    return RiW.transpose(2, 3) @ RiW


# ---------------------------------------------------------------------------
# B8d: the GPP (predictive-process) blocks
# ---------------------------------------------------------------------------

def _check_gpp(name, lvd, alpha_idx, *tensors):
    """Device, type and layout checks of a GPP level before a launch."""
    dev = lvd.idDW12g.device
    for label, t, dtype in ((("idDg", lvd.idDg, torch.float32),
                             ("idDW12g", lvd.idDW12g, torch.float64),
                             ("Fg", lvd.Fg, torch.float64),
                             ("iFg", lvd.iFg, torch.float64),
                             ("alphapw", lvd.alphapw, torch.float32))
                            + ((("alpha_idx", alpha_idx, torch.int32),)
                               if alpha_idx is not None else ())
                            + tuple(tensors)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous {dtype} "
                             f"tensor on {dev}")


def gpp_alpha_zero(lvd, alpha_idx):
    """(C, nf) True where a factor's grid point is alpha = 0 (W = I)."""
    return lvd.alphapw[alpha_idx.long(), 0] == 0


def gpp_m1_at(lvd, alpha_idx):
    """The knot cross terms ``M1 = idD W12`` at each factor's alpha, zero
    at alpha 0: (C, nf, np, nK)."""
    M1 = lvd.idDW12g[alpha_idx.long()]
    return torch.where(gpp_alpha_zero(lvd, alpha_idx)[..., None, None], 0.0,
                       M1)


def gpp_unit(lvd, alpha_idx, LiSL):
    """The per-unit Woodbury blocks of the GPP Eta draw: with ``A_u =
    LiSL_u + diag(idD_u)`` (idD at each factor's alpha, 1 at alpha 0),
    ``iA = A^{-1}`` through ``chol_spd`` and ``LiA = chol(iA)``, each (C,
    np, nf, nf); NaN for a unit whose block is not positive definite."""
    C, npr, nf, _ = LiSL.shape
    if not LiSL.is_cuda:
        return _gpp_unit_plain(lvd, alpha_idx, LiSL)
    if nf > _GPP_NF_MAX or alpha_idx.shape != (C, nf):
        raise ValueError(f"gpp_unit: LiSL {tuple(LiSL.shape)} (nf <= "
                         f"{_GPP_NF_MAX}), alpha_idx {tuple(alpha_idx.shape)}")
    _check_gpp("gpp_unit", lvd, alpha_idx, ("LiSL", LiSL, torch.float32))
    iA, LiA = torch.empty_like(LiSL), torch.empty_like(LiSL)
    with torch.cuda.device(LiSL.device):
        code = K.library().hmsc_gpp_unit(
            LiSL.data_ptr(), lvd.idDg.data_ptr(), lvd.alphapw.data_ptr(),
            alpha_idx.data_ptr(), iA.data_ptr(), LiA.data_ptr(), C, npr, nf,
            K.stream_of(LiSL))
    K.check(code, "gpp_unit")
    K.launches["gpp_unit"] += 1
    return iA, LiA


def _gpp_unit_plain(lvd, alpha_idx, LiSL):
    """The JAX ``gpp_factor``'s per-unit part (``spatial.py:164-185``, the
    default two-triangular-solve path) and ``_eta_gpp``'s alpha-0 override
    of idD, per chain."""
    nf = LiSL.shape[-1]
    idD = lvd.idDg[alpha_idx.long()]                     # (C, nf, np)
    idD = torch.where(gpp_alpha_zero(lvd, alpha_idx)[..., None], 1.0, idD)
    A = LiSL + torch.diag_embed(idD.transpose(1, 2))
    LA = chol_spd(A)
    eye = torch.eye(nf, dtype=A.dtype, device=A.device).expand_as(A)
    iA = torch.linalg.solve_triangular(
        LA.transpose(-1, -2),
        torch.linalg.solve_triangular(LA, eye, upper=False), upper=True)
    return iA, chol_spd(iA, jitter=0.0)


def gpp_knot(lvd, alpha_idx, iA):
    """The knot-space correction of the GPP Eta draw, ``H = blockdiag_h(
    F(alpha_h)) - M' iA M`` with ``M1 = idD W12`` at each factor's alpha
    (zero at alpha 0): ``H[c, h nK + m, g nK + n] = [h = g] F[m, n] - sum_u
    M1[h,u,m] iA[u,h,g] M1[g,u,n]``, (C, nf nK, nf nK) in float64: H's
    condition number reaches ~2e7 at a large alpha, so the sums are taken
    in double from the float64 grids and the knot-space factorisation runs
    in float64 (see ``csrc/gpp_knot.cu``).  The kernel sums the lower
    triangle over the unit ranges of :func:`_knot_splits`, then adds the
    ranges in order and mirrors, so H is exactly symmetric and two runs
    give the same bits; it reads ``iA[u, h, g]`` for ``h >= g`` only (iA is
    symmetric: :func:`gpp_unit`'s kernel writes it so)."""
    C, npr, nf, _ = iA.shape
    nK = lvd.idDW12g.shape[2]
    if not iA.is_cuda:
        return _gpp_knot_plain(lvd, alpha_idx, iA)
    if alpha_idx.shape != (C, nf):
        raise ValueError(f"gpp_knot: iA {tuple(iA.shape)}, alpha_idx "
                         f"{tuple(alpha_idx.shape)}")
    _check_gpp("gpp_knot", lvd, alpha_idx, ("iA", iA, torch.float32))
    S, chunk = _knot_splits(C, npr, nf, nK)
    partial = iA.new_empty((C, S, nf * (nf + 1) // 2, nK, nK),
                           dtype=torch.float64)
    H = iA.new_empty((C, nf * nK, nf * nK), dtype=torch.float64)
    with torch.cuda.device(iA.device):
        code = K.library().hmsc_gpp_knot(
            iA.data_ptr(), lvd.idDW12g.data_ptr(), lvd.Fg.data_ptr(),
            lvd.alphapw.data_ptr(), alpha_idx.data_ptr(), partial.data_ptr(),
            H.data_ptr(), C, npr, nf, nK, S, chunk, K.stream_of(iA))
    K.check(code, "gpp_knot")
    K.launches["gpp_knot"] += 1
    return H


# csrc/gpp_knot.cu's block: one factor pair's band of up to 128 rows x 104
# columns of H, 16 units a stage; launches aim at ~one block an H100 SM
_KNOT_BAND_ROWS, _KNOT_BAND_COLS, _KNOT_UNITS, _KNOT_BLOCKS = 128, 104, 16, 132


def _knot_splits(C, npr, nf, nK):
    """``(S, chunk)``: the unit range B8d-2 splits its sums into, ``S``
    consecutive ranges of ``chunk`` units (a multiple of the 16-unit stage;
    none empty, at least 64 units each), enough that a launch has about
    ``_KNOT_BLOCKS`` blocks.  A function of the shape only, so the order
    of the final sum never changes from run to run."""
    items = (nf * (nf + 1) // 2 * -(-nK // _KNOT_BAND_ROWS)
             * -(-nK // _KNOT_BAND_COLS))
    S = max(1, min(npr // 64, -(-_KNOT_BLOCKS // max(1, C * items))))
    chunk = -(-max(npr, 1) // S)
    chunk = -(-chunk // _KNOT_UNITS) * _KNOT_UNITS
    return -(-max(npr, 1) // chunk), chunk


def _gpp_knot_plain(lvd, alpha_idx, iA):
    """The JAX ``gpp_factor``'s ``H`` (``spatial.py:178-183``), per chain,
    computed in float64 from the given inputs (the kernel's accumulation)."""
    C, _, nf, _ = iA.shape
    M1 = gpp_m1_at(lvd, alpha_idx).double()              # (C, nf, np, nK)
    nK = M1.shape[3]
    H = -torch.einsum("chum,cuhg,cgun->chmgn", M1, iA.double(), M1)
    Fm = lvd.Fg[alpha_idx.long()].double()               # (C, nf, nK, nK)
    for f in range(nf):
        H[:, f, :, f, :] += Fm[:, f]
    return H.reshape(C, nf * nK, nf * nK)


def gpp_quad_grid(lvd, eta):
    """``v[c, f, g] = eta_cf' iW_g eta_cf`` over the whole alpha grid for a
    GPP level: ``sum_u idD_g eta^2 - Et' iF_g Et`` with ``Et = eta' idDW12_g``,
    or ``eta' eta`` where alpha_g = 0.  (C, nf, G).  The kernel sums each
    grid point's units over the ranges of :func:`_quad_splits` and adds the
    ranges in order (see ``csrc/gpp_quad.cu``)."""
    if not eta.is_cuda:
        return _gpp_quad_grid_plain(lvd, eta)
    C, npr, nf = eta.shape
    G, _, nK = lvd.idDW12g.shape
    _check_gpp("gpp_quad_grid", lvd, None, ("eta", eta, torch.float32))
    U, chunk = _quad_splits(_quad_items(G, C * nf, nK), npr,
                            _QUAD_GRID_BLOCKS)
    out = eta.new_empty((C, nf, G))
    scratch = eta.new_empty((G * U * C * nf * (nK + 1),),
                            dtype=torch.float64)
    with torch.cuda.device(eta.device):
        code = K.library().hmsc_gpp_quad_grid(
            eta.data_ptr(), lvd.idDg.data_ptr(), lvd.idDW12g.data_ptr(),
            lvd.iFg.data_ptr(), lvd.alphapw.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), C, npr, nf, nK, G, U, chunk, K.stream_of(eta))
    K.check(code, "gpp_quad")
    K.launches["gpp_quad"] += 1
    return out


def gpp_quad_at(lvd, alpha_idx, eta):
    """At each factor's alpha: ``(q, q1, s)`` = (``eta' iW eta``, ``1' iW
    1``, ``1' iW eta``) of a GPP level, stacked on the last axis: (C, nf,
    3); at alpha 0 (``iW = I``) ``(eta' eta, np, 1' eta)``."""
    if not eta.is_cuda:
        return _gpp_quad_at_plain(lvd, alpha_idx, eta)
    C, npr, nf = eta.shape
    nK = lvd.idDW12g.shape[2]
    _check_gpp("gpp_quad_at", lvd, alpha_idx, ("eta", eta, torch.float32))
    U, chunk = _quad_splits(_quad_items(None, C * nf, nK), npr,
                            _QUAD_AT_BLOCKS)
    out = eta.new_empty((C, nf, 3))
    scratch = eta.new_empty((C * nf * U * (2 * nK + 3),),
                            dtype=torch.float64)
    with torch.cuda.device(eta.device):
        code = K.library().hmsc_gpp_quad_at(
            eta.data_ptr(), lvd.idDg.data_ptr(), lvd.idDW12g.data_ptr(),
            lvd.iFg.data_ptr(), lvd.alphapw.data_ptr(), alpha_idx.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), C, npr, nf, nK, U, chunk,
            K.stream_of(eta))
    K.check(code, "gpp_quad")
    K.launches["gpp_quad"] += 1
    return out


# csrc/gpp_quad.cu's first pass: blocks of 256 threads over (slice, unit
# range, column group x knot group), ~4 resident an H100 SM in grid mode
# (528 blocks for 132 SMs) and ~2 at alpha, whose blocks are short (256:
# at config 3c 32 ranges a column, which the second pass adds in one batch
# of loads); a block stages its units' weights in shared memory, 256 units
# at most; knots ride 32..256 lanes, columns 8 a block
_QUAD_GRID_BLOCKS, _QUAD_AT_BLOCKS = 528, 256
_QUAD_MIN_UNITS, _QUAD_MAX_UNITS = 16, 256


def _quad_items(G, ncol, nK):
    """B8d-3's first-pass blocks before the unit split: (grid points x
    column groups of 8, or columns when ``G`` is None) x knot groups of up
    to 256."""
    lanes = 32
    while lanes < nK and lanes < 256:
        lanes *= 2
    slices = ncol if G is None else G * -(-ncol // 8)
    return slices * -(-nK // lanes)


def _quad_splits(items, npr, target):
    """``(U, chunk)``: B8d-3's first pass cuts each slice's ``npr`` units
    into ``U`` consecutive ranges of ``chunk`` units (the last may be
    shorter, none empty), so that ``items x U`` blocks come near ``target``
    without passing it, each range of at least 16 units where there are 16
    and at most 256.  A function of the shape only, so the order of the
    sums never changes from run to run."""
    n = max(npr, 1)
    U = max(1, min(n // _QUAD_MIN_UNITS, target // max(items, 1)))
    U = max(U, -(-n // _QUAD_MAX_UNITS))
    chunk = -(-n // U)
    return -(-n // chunk), chunk


def _gpp_quad_grid_plain(lvd, eta):
    """The GPP branch of the JAX ``eta_quad_grid`` (``spatial.py:426-437``),
    per chain, computed in float64 from the float32 inputs (the kernel's
    accumulation; see ``csrc/gpp_quad.cu``) and returned in eta's type."""
    e, idD, W = eta.double(), lvd.idDg.double(), lvd.idDW12g.double()
    q_full = (e * e).sum(dim=1)                          # (C, nf)
    t1 = torch.einsum("gu,cuh->chg", idD, e ** 2)
    Et = torch.einsum("cuh,gum->chgm", e, W)
    t2 = torch.einsum("chgm,gmn,chgn->chg", Et, lvd.iFg.double(), Et)
    zero = lvd.alphapw[:, 0] == 0
    return torch.where(zero, q_full[..., None], t1 - t2).to(eta.dtype)


def _gpp_quad_at_plain(lvd, alpha_idx, eta):
    """The GPP branches of the JAX ``eta_quad_at`` (``spatial.py:463-478``)
    and ``eta_ones_forms_at`` (``:519-540``), per chain, in float64 as
    :func:`_gpp_quad_grid_plain`."""
    out_dtype, eta = eta.dtype, eta.double()
    a = alpha_idx.long()
    idD, W12 = lvd.idDg[a].double(), lvd.idDW12g[a].double()
    iF = lvd.iFg[a].double()
    t1 = torch.einsum("chu,cuh->ch", idD, eta ** 2)
    Et = torch.einsum("cuh,chum->chm", eta, W12)
    t2 = torch.einsum("chm,chmn,chn->ch", Et, iF, Et)
    q_full = (eta * eta).sum(dim=1)
    E1 = W12.sum(dim=2)                                  # 1' idDW12
    q1 = idD.sum(dim=2) - torch.einsum("chm,chmn,chn->ch", E1, iF, E1)
    s = (torch.einsum("chu,cuh->ch", idD, eta)
         - torch.einsum("chm,chmn,chn->ch", E1, iF, Et))
    zero = gpp_alpha_zero(lvd, alpha_idx)
    npr = eta.shape[1]
    return torch.stack([torch.where(zero, q_full, t1 - t2),
                        torch.where(zero, float(npr), q1),
                        torch.where(zero, eta.sum(dim=1), s)],
                       dim=2).to(out_dtype)
