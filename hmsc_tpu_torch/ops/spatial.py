"""The NNGP (Vecchia) operators of the spatial Eta and alpha updates, with
the hand-written kernels B8a-B8c behind their wrappers:

- B8a :func:`vecchia_riw`, :func:`vecchia_riw_t`, :func:`vecchia_pmv` —
  ``RiW x``, ``RiW' u`` and the CG sampler's ``P x = RiW'(RiW x) + LiSL x``
  (``csrc/vecchia_apply.cu``; the JAX package's ``vecchia_ops``);
- B8b :func:`nngp_quad_grid`, :func:`nngp_quad_at` — the prior quadratics
  over the alpha grid, or at each factor's alpha with the location move's
  ones-forms (``csrc/nngp_quad.cu``; ``eta_quad_grid``, ``eta_quad_at``,
  ``eta_ones_forms_at``);
- B8c :func:`nngp_riw_dense` — the dense factor ``RiW`` below the dense/CG
  crossover (``csrc/nngp_riw.cu``; ``_nngp_dense_iW``).

``lvd`` is an NNGP level's ``LevelData``: ``nn_idx`` (np, k), ``nn_coef``
(G, np, k), ``nn_D`` (G, np), ``nn_n`` and the reverse-neighbour CSR
(``rev_ptr``, ``rev_pos``).  ``alpha_idx`` (C, nf) picks each
chain's factor's grid point, and iterates are (C, np, nf).  Each wrapper
launches its kernel for CUDA tensors (or raises) and runs the plain PyTorch
version beside it only for tensors on the CPU; every launch is counted in
:data:`hmsc_tpu_torch.kernels.launches`.
"""

from __future__ import annotations

import torch

from .. import kernels as K

__all__ = ["vecchia_riw", "vecchia_riw_t", "vecchia_pmv", "nngp_quad_grid",
           "nngp_quad_at", "nngp_riw_dense"]


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


def _grid_at(lvd, alpha_idx):
    """(coef (C, nf, np, k), D (C, nf, np)) at each factor's alpha."""
    a = alpha_idx.long()
    return lvd.nn_coef[a], lvd.nn_D[a]


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


# ---------------------------------------------------------------------------
# B8b: prior quadratics over the alpha grid and at each factor's alpha
# ---------------------------------------------------------------------------

def nngp_quad_grid(lvd, eta):
    """``v[c, f, g] = eta_cf' iW_g eta_cf`` for every grid point g: the
    Vecchia residuals' squares over D, summed over units.  (C, nf, G)."""
    if not eta.is_cuda:
        return _nngp_quad_grid_plain(lvd, eta)
    C, npr, nf = eta.shape
    G = lvd.nn_coef.shape[0]
    _check("nngp_quad_grid", lvd, None, ("eta", eta, torch.float32))
    out = eta.new_empty((C, nf, G))
    with torch.cuda.device(eta.device):
        code = K.library().hmsc_nngp_quad_grid(
            eta.data_ptr(), lvd.nn_idx.data_ptr(), lvd.nn_coef.data_ptr(),
            lvd.nn_D.data_ptr(), out.data_ptr(), C, npr, nf,
            lvd.nn_idx.shape[1], G, K.stream_of(eta))
    K.check(code, "nngp_quad")
    K.launches["nngp_quad"] += 1
    return out


def nngp_quad_at(lvd, alpha_idx, eta):
    """At each factor's alpha: ``(q, q1, s)`` = (``eta' iW eta``, ``1' iW
    1``, ``1' iW eta``), stacked on the last axis: (C, nf, 3)."""
    if not eta.is_cuda:
        return _nngp_quad_at_plain(lvd, alpha_idx, eta)
    C, npr, nf = eta.shape
    _check("nngp_quad_at", lvd, alpha_idx, ("eta", eta, torch.float32))
    out = eta.new_empty((C, nf, 3))
    with torch.cuda.device(eta.device):
        code = K.library().hmsc_nngp_quad_at(
            eta.data_ptr(), lvd.nn_idx.data_ptr(), lvd.nn_coef.data_ptr(),
            lvd.nn_D.data_ptr(), alpha_idx.data_ptr(), out.data_ptr(), C,
            npr, nf, lvd.nn_idx.shape[1], K.stream_of(eta))
    K.check(code, "nngp_quad")
    K.launches["nngp_quad"] += 1
    return out


def _nngp_quad_grid_plain(lvd, eta):
    """The NNGP branch of the JAX ``eta_quad_grid``, per chain."""
    eta_nn = eta[:, lvd.nn_idx.long()]                   # (C, np, k, nf)
    pred = torch.einsum("gik,cikh->chgi", lvd.nn_coef, eta_nn)
    res = eta.transpose(1, 2)[:, :, None, :] - pred      # (C, nf, G, np)
    return (res ** 2 / lvd.nn_D[None, None]).sum(dim=3)


def _nngp_quad_at_plain(lvd, alpha_idx, eta):
    """The NNGP branches of the JAX ``eta_quad_at`` and
    ``eta_ones_forms_at``, per chain."""
    coef, D = _grid_at(lvd, alpha_idx)                   # (C, nf, np, k)
    pred = torch.einsum("chik,cikh->chi", coef, eta[:, lvd.nn_idx.long()])
    res = eta.transpose(1, 2) - pred                     # (C, nf, np)
    q = (res ** 2 / D).sum(dim=2)
    sqD = torch.sqrt(D)
    r1 = (1.0 - coef.sum(dim=3)) / sqD
    re = res / sqD
    return torch.stack([q, (r1 ** 2).sum(dim=2), (r1 * re).sum(dim=2)],
                       dim=2)


# ---------------------------------------------------------------------------
# B8c: the dense Vecchia factor
# ---------------------------------------------------------------------------

def nngp_riw_dense(lvd, alpha_idx):
    """The dense ``RiW`` of each chain's factors at their alpha: (C, nf, np,
    np), rows ``(e_i - sum_k A[i,k] e_nn[i,k]) / sqrt(D_i)``."""
    if not lvd.nn_coef.is_cuda:
        return _nngp_riw_dense_plain(lvd, alpha_idx)
    C, nf = alpha_idx.shape
    npr, k = lvd.nn_idx.shape
    _check("nngp_riw_dense", lvd, alpha_idx)
    out = lvd.nn_coef.new_empty((C, nf, npr, npr))
    with torch.cuda.device(out.device):
        code = K.library().hmsc_nngp_riw(
            lvd.nn_idx.data_ptr(), lvd.nn_coef.data_ptr(),
            lvd.nn_D.data_ptr(), alpha_idx.data_ptr(), out.data_ptr(), C,
            npr, nf, k, K.stream_of(out))
    K.check(code, "nngp_riw")
    K.launches["nngp_riw"] += 1
    return out


def _nngp_riw_dense_plain(lvd, alpha_idx):
    """The JAX ``_nngp_dense_iW`` scatter (before its gram), per chain."""
    coef, D = _grid_at(lvd, alpha_idx)                   # (C, nf, np, k)
    C, nf, npr, k = coef.shape
    RiW = coef.new_zeros((C, nf, npr, npr))
    ar = lambda n: torch.arange(n, device=coef.device)
    RiW.index_put_((ar(C)[:, None, None, None], ar(nf)[None, :, None, None],
                    ar(npr)[None, None, :, None],
                    lvd.nn_idx.long()[None, None]), -coef, accumulate=True)
    RiW = RiW + torch.eye(npr, dtype=coef.dtype, device=coef.device)
    return RiW / torch.sqrt(D)[..., None]
