"""Masked grams and right-hand sides (B6, ``csrc/masked_gram.cu``).

When Y has missing values every species (and every row of a level) sees
its own subset of the data, so the shared ``X'X`` of the complete-data
path becomes one weighted gram per species or per row.  The JAX package
writes these as einsums (``hmsc_tpu/mcmc/updaters.py:246-250, 278-279,
618-623``); here they are one kernel written by hand for Hopper, with the
einsum pair beside it as the plain version.  The wrapper launches the
kernel for a CUDA tensor (or raises) and runs the plain version only for a
tensor on the CPU.
"""

from __future__ import annotations

import torch

from .. import kernels as K

__all__ = ["masked_gram"]

# the kernel stages a 16-row tile of v in shared memory (48 KB with its
# static tiles); no sampler design comes near this width
_P_MAX = 512


def masked_gram(v, w, s, a=None):
    """``G[c,o] = sum_k w[o,k] a[c,k] v[c,k] v[c,k]'`` and
    ``R[c,o] = sum_k w[o,k] a[c,k] s[c,o,k] v[c,k]``.

    ``v`` (C, K, P), ``w`` (O, K), ``s`` (C, O, K) and ``a`` (C, K) or None
    (all ones) may be any strided views: the per-species form passes
    ``v = XE``, ``w = Ymask.T``, ``s = Z.transpose(1, 2)``; the per-row
    form ``v = Lambda.transpose(1, 2)``, ``w = Ymask``, ``s = S``, ``a =
    iSigma``.  Returns ``G`` (C, O, P, P) and ``R`` (C, O, P)."""
    C, Kd, P = v.shape
    O = w.shape[0]
    if w.shape != (O, Kd) or s.shape != (C, O, Kd) or (
            a is not None and a.shape != (C, Kd)):
        raise ValueError(f"masked_gram: v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, s {tuple(s.shape)}, a "
                         f"{None if a is None else tuple(a.shape)}")
    if not v.is_cuda:
        return _masked_gram_plain(v, w, s, a)
    for name, t in (("v", v), ("w", w), ("s", s)) + (
            (("a", a),) if a is not None else ()):
        if t.device != v.device or t.dtype != torch.float32:
            raise ValueError(f"masked_gram: {name} must be float32 on v's "
                             "device")
    if P > _P_MAX:
        raise ValueError(f"masked_gram: P = {P} exceeds the kernel's "
                         f"{_P_MAX}")
    G = v.new_empty((C, O, P, P))
    R = v.new_empty((C, O, P))
    if G.numel() == 0:
        return G, R
    with torch.cuda.device(v.device):
        code = K.library().hmsc_masked_gram(
            v.data_ptr(), *v.stride(), w.data_ptr(), *w.stride(),
            None if a is None else a.data_ptr(),
            *((0, 0) if a is None else a.stride()), s.data_ptr(),
            *s.stride(), G.data_ptr(), R.data_ptr(), C, O, Kd, P,
            K.stream_of(v))
    K.check(code, "masked_gram")
    K.launches["masked_gram"] += 1
    return G, R


def _masked_gram_plain(v, w, s, a):
    """The JAX package's einsum pair (``updaters.py:246-250, 278-279,
    618-623``) in the kernel's interface."""
    wa = w[None] if a is None else w[None] * a[:, None, :]     # (C|1, O, K)
    G = torch.einsum("cok,ckp,ckq->copq", wa.expand(v.shape[0], -1, -1), v,
                     v)
    R = torch.einsum("cok,ckp->cop", wa * s, v)
    return G, R
