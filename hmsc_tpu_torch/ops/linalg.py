"""Dense linear-algebra helpers for the Gibbs engine (port of
``hmsc_tpu/ops/linalg.py``).

B2 is a kernel written by hand for Hopper (``csrc/mvn_prec_small.cu``, a
group of P lanes a system) for P <= 16, in three forms that all count
under ``mvn_prec_small``: :func:`sample_mvn_prec_batched`, the JAX op's
own signature (the precisions as given); :func:`sample_mvn_prec_shifted`,
the unstructured Eta draw's ``I + s_b G`` from one gram a chain or one a
unit; and :func:`sample_beta_lambda`, BetaLambda's ``blkdiag(iV, psi tau)
+ iSigma_j G`` with its right-hand side, formed in the kernel from the
gram, the priors and ``Gamma Tr'``.  Each wrapper launches the kernel for
a CUDA tensor and runs the plain version (the assembly as torch ops, then
the unrolled draw) only for a CPU tensor.  Larger systems, like the JAX
op, go through :func:`chol_spd` + :func:`sample_mvn_prec` on either
device, after the same assembly.

Every factorisation returns NaN on an indefinite matrix and never raises:
divergence containment (the sampler's ``first_bad_update``) depends on NaN
reaching the state, and ``torch.linalg.cholesky`` would raise instead, so
:func:`chol_spd` uses ``cholesky_ex`` and writes NaN where ``info > 0``
(``cholesky_ex`` with its default ``check_errors=False`` also keeps the
device from synchronising with the host).
"""

from __future__ import annotations

import torch

from .. import kernels as K
from . import mixed

__all__ = ["chol_spd", "sample_mvn_prec", "sample_mvn_prec_batched",
           "sample_mvn_prec_shifted", "sample_beta_lambda"]

# Relative jitter added to diagonals before cholesky; f32 MCMC insurance.
# csrc/mvn_prec_small.cu hard-codes the same value.
_JITTER = 1e-6
# Above this size the plain factorisation replaces the small-system kernel
_SMALL_P_MAX = 16
# B2's forms (csrc/mvn_prec_small.cu · Form)
_ELEMENT, _IDENTITY, _BETA_LAMBDA = 0, 1, 2


def chol_spd(A, jitter=_JITTER):
    """Cholesky of symmetric PD matrices (..., n, n) with relative diagonal
    jitter ``jitter * mean(diag)``; NaN in full where a matrix is not PD.
    ``jitter=0`` is the plain factorisation, and there a NaN input counts
    as not PD too (cuSOLVER, unlike LAPACK, reports no failure for it).
    Inside a bf16 precision scope the input is symmetrised first, ``(A +
    A') / 2``, as ``jnp.linalg.cholesky`` always does: a gram of two
    operands rounded apart (``(lam iSigma) lam'``) is not symmetric there
    by ~1e-3, where in float32 it is to rounding."""
    if mixed.active():
        A = (A + A.transpose(-1, -2)) / 2
    if jitter:
        scale = torch.diagonal(A, dim1=-2, dim2=-1).mean(dim=-1)
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        A = A + (jitter * scale)[..., None, None] * eye
    L, info = torch.linalg.cholesky_ex(A)
    bad = info > 0
    if not jitter:
        bad = bad | torch.isnan(L).flatten(-2).any(-1)
    return torch.where(bad[..., None, None], torch.full_like(L, float("nan")),
                       L)


def sample_mvn_prec(L, rhs, eps):
    """Draw from N(P^{-1} rhs, P^{-1}) given L = chol(P) and eps ~ N(0, I),
    vectors on the last axis: mean = P^{-1} rhs (cho_solve), noise =
    L^{-T} eps.  Under a bf16 precision scope with batched layouts
    (``mixed.layouts_active``) the mean and noise fold into one solve pair,
    ``x = L^{-T} (L^{-1} rhs + eps)``, as the JAX package's does there (the
    same law; the solves stay in L's type)."""
    Lt = L.transpose(-1, -2)
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    if mixed.layouts_active():
        return torch.linalg.solve_triangular(Lt, y + eps[..., None],
                                             upper=True)[..., 0]
    mean = torch.linalg.solve_triangular(Lt, y, upper=True)
    noise = torch.linalg.solve_triangular(Lt, eps[..., None], upper=True)
    return (mean + noise)[..., 0]


def sample_mvn_prec_batched(prec, rhs, eps):
    """Fused Cholesky + N(P^{-1} rhs, P^{-1}) draw for a batch of small SPD
    precisions ``prec`` (..., P, P) with ``rhs``, ``eps`` (..., P): B2's
    element form."""
    P = prec.shape[-1]
    if P > _SMALL_P_MAX:
        return sample_mvn_prec(chol_spd(prec), rhs, eps)
    if not prec.is_cuda:
        return _sample_mvn_prec_small_plain(prec, rhs, eps)
    batch_shape = prec.shape[:-2]
    if rhs.shape != batch_shape + (P,) or eps.shape != rhs.shape:
        raise ValueError(f"mvn_prec_small: prec {tuple(prec.shape)}, rhs "
                         f"{tuple(rhs.shape)}, eps {tuple(eps.shape)}")
    batch = rhs.numel() // P
    if batch == 0:
        return torch.empty_like(rhs)
    out = _launch(_ELEMENT, prec.reshape(1, batch, P, P),
                  rhs.reshape(1, batch, P), eps.reshape(1, batch, P))
    return out.reshape(rhs.shape)


def sample_mvn_prec_shifted(G, rhs, scale=None, eps=None, rng=None,
                            unit_off: int = 0, n_global=None):
    """The unstructured Eta draw's systems: x_b ~ N(prec_b^{-1} rhs_b,
    prec_b^{-1}) with ``prec_b = I + scale_b G_b``.  ``rhs`` (C, n, P);
    ``G`` (C, 1, P, P), one gram a chain (stride 0 over its systems), or
    (C, n, P, P); ``scale`` (n,) or None for 1.  ``eps`` (C, n, P), or None
    to draw it (``rng.normal``; in the kernel, Philox keyed by
    ``rng.philox()``).  On a site mesh the n systems are a rank's block of
    the level's ``n_global`` units, from ``unit_off``: the drawn eps is the
    replicated run's (the kernel's counters count the global unit, the
    plain version slices a global-width draw).  B2's identity form; the
    plain version is ``scale G + I`` then
    :func:`sample_mvn_prec_batched`."""
    C, n, P = rhs.shape
    if not rhs.is_cuda or P > _SMALL_P_MAX:
        LiSL = G if scale is None else scale[:, None, None] * G
        prec = LiSL + torch.eye(P, dtype=rhs.dtype, device=rhs.device)
        if eps is None:
            eps = rng.normal((C, n if n_global is None else n_global, P),
                             rhs.dtype)[:, unit_off:unit_off + n]
        return sample_mvn_prec_batched(prec, rhs, eps)
    return _launch(_IDENTITY, G, rhs, eps, rng, scale=scale,
                   sys_off=unit_off, nsys_g=n_global)


def _beta_lambda_system(G, rhs_lik, iSigma, iV, prior, Gamma, Tr):
    """BetaLambda's per-species precisions and right-hand sides as torch
    ops (the plain version of B2's BetaLambda form): ``blkdiag(iV,
    diag(prior_j)) + iSigma_j G`` and ``P0 mu0 + iSigma_j rhs_lik``."""
    C, ns, P = rhs_lik.shape
    nc = iV.shape[-1]
    Mu_beta = Gamma @ Tr.T                               # (C, nc, ns)
    eyeP = torch.eye(P, dtype=G.dtype, device=G.device)
    prior_diag = torch.cat([G.new_zeros((C, nc, ns)), prior],
                           dim=1)                        # (C, P, ns)
    P0 = G.new_zeros((C, ns, P, P))
    P0[:, :, :nc, :nc] = iV[:, None]
    P0 = P0 + eyeP * prior_diag.transpose(1, 2)[..., None]
    prec = P0 + iSigma[:, :, None, None] * G
    mu0 = torch.cat([Mu_beta, G.new_zeros((C, P - nc, ns))],
                    dim=1)                               # (C, P, ns)
    rhs = torch.einsum("cjpq,cqj->cjp", P0, mu0) \
        + iSigma[:, :, None] * rhs_lik
    return prec, rhs


def sample_beta_lambda(G, rhs_lik, iSigma, iV, prior, Gamma, Tr, eps=None,
                       rng=None):
    """The joint (Beta, Lambda) draw of every species: (C, ns, P) with
    species j's precision ``blkdiag(iV, diag(prior[:, :, j])) + iSigma_j
    G_j`` and right-hand side ``blkdiag(...) [Gamma Tr'_j; 0] + iSigma_j
    rhs_lik_j``.  ``G`` (C, 1, P, P), the chain's gram ``XE'XE``, or (C,
    ns, P, P) with missing values; ``rhs_lik`` (C, ns, P); ``iSigma`` (C,
    ns); ``iV`` (C, nc, nc); ``prior`` (C, P - nc, ns); ``Gamma`` (C, nc,
    nt); ``Tr`` (ns, nt).  ``eps`` (C, ns, P) or None, as for
    :func:`sample_mvn_prec_shifted`.  B2's BetaLambda form; the plain
    version is :func:`_beta_lambda_system` then
    :func:`sample_mvn_prec_batched`."""
    C, ns, P = rhs_lik.shape
    if not rhs_lik.is_cuda or P > _SMALL_P_MAX:
        prec, rhs = _beta_lambda_system(G, rhs_lik, iSigma, iV, prior,
                                        Gamma, Tr)
        if eps is None:
            eps = rng.normal((C, ns, P), rhs.dtype)
        return sample_mvn_prec_batched(prec, rhs, eps)
    return _launch(_BETA_LAMBDA, G, rhs_lik, eps, rng, scale=iSigma,
                   iV=iV, prior=prior, Gamma=Gamma, Tr=Tr)


def _launch(form, G, rhs, eps, rng=None, scale=None, iV=None, prior=None,
            Gamma=None, Tr=None, sys_off: int = 0, nsys_g=None):
    """One launch of B2 over ``rhs``'s (C, n) systems of size P (Philox
    counters of systems ``sys_off`` on of ``nsys_g``, default n)."""
    C, n, P = rhs.shape
    dev = rhs.device
    shapes = {"G": (G, ((C, 1, P, P), (C, n, P, P)) if form != _ELEMENT
                    else ((C, n, P, P),)),
              "eps": (eps, ((C, n, P),))}
    if scale is not None:
        shapes["scale"] = (scale, ((C, n),) if form == _BETA_LAMBDA
                           else ((n,),))
    if form == _BETA_LAMBDA:
        nc, nt = iV.shape[-1], Gamma.shape[-1]
        shapes.update(iV=(iV, ((C, nc, nc),)),
                      prior=(prior, ((C, P - nc, n),)),
                      Gamma=(Gamma, ((C, nc, nt),)), Tr=(Tr, ((n, nt),)))
    else:
        nc = nt = 0
    args = {"rhs": rhs.contiguous()}
    for name, (t, allowed) in shapes.items():
        if t is None:
            args[name] = None
            continue
        if tuple(t.shape) not in allowed or t.device != dev \
                or t.dtype != torch.float32:
            raise ValueError(f"mvn_prec_small: {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}; expected float32 "
                             f"{' or '.join(map(str, allowed))} on {dev}")
        args[name] = t.contiguous()
    if rhs.dtype != torch.float32:
        raise ValueError("mvn_prec_small: rhs must be float32")
    out = torch.empty_like(args["rhs"])
    if C * n == 0:
        return out
    seed, offset = (0, 0) if eps is not None else rng.philox()
    ptr = lambda name: None if args.get(name) is None \
        else args[name].data_ptr()
    with torch.cuda.device(dev):
        code = K.library().hmsc_mvn_prec_small(
            ptr("G"), int(form != _ELEMENT and G.shape[1] == 1), ptr("scale"),
            int(form == _BETA_LAMBDA), ptr("rhs"), ptr("iV"), ptr("prior"),
            ptr("Gamma"), ptr("Tr"), nc, nt, ptr("eps"), out.data_ptr(),
            C * n, n, P, form, n if nsys_g is None else int(nsys_g),
            int(sys_off), seed, offset, K.stream_of(rhs))
    K.check(code, "mvn_prec_small")
    K.launches["mvn_prec_small"] += 1
    return out


def _sample_mvn_prec_small_plain(prec, rhs, eps):
    """The JAX op's unrolled algorithm (``hmsc_tpu/ops/linalg.py:80-116``)
    with the batch as the vector dimension: the same order of operations
    as the kernel, entry by entry."""
    P = prec.shape[-1]
    A = [[prec[..., i, j] for j in range(P)] for i in range(P)]
    scale = A[0][0]
    for j in range(1, P):
        scale = scale + A[j][j]
    bump = (_JITTER / P) * scale
    L = [[None] * P for _ in range(P)]
    inv = [None] * P
    for j in range(P):
        s = A[j][j] + bump
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(s)                     # NaN if indefinite, like chol
        inv[j] = 1.0 / d
        L[j][j] = d
        for i in range(j + 1, P):
            s2 = A[i][j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 * inv[j]
    # forward solve L y = rhs, then back solve L' x = y + eps
    y = [None] * P
    for i in range(P):
        s = rhs[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * inv[i]
    x = [None] * P
    for i in reversed(range(P)):
        s = y[i] + eps[..., i]
        for k in range(i + 1, P):
            s = s - L[k][i] * x[k]
        x[i] = s * inv[i]
    return torch.stack(x, dim=-1)
