"""Dense linear-algebra helpers for the Gibbs engine (port of
``hmsc_tpu/ops/linalg.py``).

B2 :func:`sample_mvn_prec_batched` is a kernel written by hand for Hopper
(``csrc/mvn_prec_small.cu``, one small system per thread) for P <= 16; the
wrapper launches it for a CUDA tensor and runs the plain unrolled version
only for a CPU tensor.  Larger systems, like the JAX op, go through
:func:`chol_spd` + :func:`sample_mvn_prec` on either device.

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

__all__ = ["chol_spd", "sample_mvn_prec", "sample_mvn_prec_batched"]

# Relative jitter added to diagonals before cholesky; f32 MCMC insurance.
# csrc/mvn_prec_small.cu hard-codes the same value.
_JITTER = 1e-6
# Above this size the plain factorisation replaces the small-system kernel
_SMALL_P_MAX = 16


def chol_spd(A, jitter=_JITTER):
    """Cholesky of symmetric PD matrices (..., n, n) with relative diagonal
    jitter ``jitter * mean(diag)``; NaN in full where a matrix is not PD.
    ``jitter=0`` is the plain factorisation, and there a NaN input counts
    as not PD too (cuSOLVER, unlike LAPACK, reports no failure for it)."""
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
    L^{-T} eps."""
    Lt = L.transpose(-1, -2)
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    mean = torch.linalg.solve_triangular(Lt, y, upper=True)
    noise = torch.linalg.solve_triangular(Lt, eps[..., None], upper=True)
    return (mean + noise)[..., 0]


def sample_mvn_prec_batched(prec, rhs, eps):
    """Fused Cholesky + N(P^{-1} rhs, P^{-1}) draw for a batch of small SPD
    precisions ``prec`` (..., P, P) with ``rhs``, ``eps`` (..., P)."""
    P = prec.shape[-1]
    if P > _SMALL_P_MAX:
        return sample_mvn_prec(chol_spd(prec), rhs, eps)
    if not prec.is_cuda:
        return _sample_mvn_prec_small_plain(prec, rhs, eps)
    batch_shape = prec.shape[:-2]
    if rhs.shape != batch_shape + (P,) or eps.shape != rhs.shape:
        raise ValueError(f"mvn_prec_small: prec {tuple(prec.shape)}, rhs "
                         f"{tuple(rhs.shape)}, eps {tuple(eps.shape)}")
    for name, t in (("prec", prec), ("rhs", rhs), ("eps", eps)):
        if t.device != prec.device or t.dtype != torch.float32:
            raise ValueError(f"mvn_prec_small: {name} must be float32 on "
                             "prec's device")
    prec, rhs, eps = prec.contiguous(), rhs.contiguous(), eps.contiguous()
    out = torch.empty_like(rhs)
    batch = rhs.numel() // P
    if batch == 0:
        return out
    with torch.cuda.device(prec.device):
        code = K.library().hmsc_mvn_prec_small(
            prec.data_ptr(), rhs.data_ptr(), eps.data_ptr(), out.data_ptr(),
            batch, P, K.stream_of(prec))
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
