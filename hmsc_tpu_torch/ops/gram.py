"""Masked grams and right-hand sides (B6, ``csrc/masked_gram.cu``).

When Y has missing values every species (and every row of a level) sees
its own subset of the data, so the shared ``X'X`` of the complete-data
path becomes one weighted gram per species or per row.  The JAX package
writes these as einsums (``hmsc_tpu/mcmc/updaters.py:246-250, 278-279,
618-623``); here they are kernels written by hand for Hopper (the column
operand, the partial sums over ranges of k, their sum in order; counted as
one launch), with the einsum pair beside them as the plain version.  The
wrapper launches the kernels for a CUDA tensor (or raises) and runs the
plain version only for a tensor on the CPU.
"""

from __future__ import annotations

import torch

from .. import kernels as K
from .mixed import round_bf16

__all__ = ["masked_gram", "gram_columns", "gram_tiles", "gram_splits"]

# the kernel's column tiles take any P; the column operand it forms is
# C K T (NG + 1) 16 floats, so keep P to what sampler designs reach
_P_MAX = 512
# csrc/masked_gram.cu's block: 64 outputs by one column tile of at most 8
# gram slots of 16 columns and one right-hand-side slot, k tiles of 16
_BO, _BK, _SLOT, _MAX_SLOTS = 64, 16, 16, 8
# blocks a launch aims at: ~8 on each of an H100's 132 SMs
_TARGET_BLOCKS = 8 * 132

_columns = {}


def gram_columns(P):
    """B6's packed columns: the ``P(P+1)/2`` pairs ``(p, q)``, ``p <= q``,
    row by row, then the ``P`` right-hand-side entries as ``(p, -1)``.
    Returns ``(colp, colq)``, int32 tensors of length ``P(P+1)/2 + P``."""
    p, q = torch.triu_indices(P, P)
    ar = torch.arange(P)
    return (torch.cat([p, ar]).to(torch.int32),
            torch.cat([q, torch.full((P,), -1)]).to(torch.int32))


def gram_tiles(P):
    """``(NG, T)``: the gram slots of 16 columns a block carries and the
    column tiles a launch cuts the packed columns into; tile ``t`` holds
    gram slots ``t NG .. (t + 1) NG - 1`` and right-hand-side slot ``t``."""
    gram_slots = -(-(P * (P + 1) // 2) // _SLOT)
    T = max(-(-gram_slots // _MAX_SLOTS), -(-P // _SLOT), 1)
    return max(1, -(-gram_slots // T)), T


def gram_splits(C, O, Kd, P):
    """``(S, chunk)``: the reduction range ``K`` cut into ``S`` consecutive
    ranges of ``chunk`` (a multiple of the 16-row k tile; none empty),
    enough that a launch has about ``_TARGET_BLOCKS`` blocks.  A function of
    the shape only, so the order of the final sum never changes from run to
    run."""
    base = C * -(-O // _BO) * gram_tiles(P)[1]
    k_tiles = max(1, -(-Kd // _BK))
    S = min(k_tiles, max(1, -(-_TARGET_BLOCKS // max(base, 1))))
    per = -(-k_tiles // S)
    return -(-k_tiles // per), per * _BK


def masked_gram(v, w, s, a=None, bf16: bool = False):
    """``G[c,o] = sum_k w[o,k] a[c,k] v[c,k] v[c,k]'`` and
    ``R[c,o] = sum_k w[o,k] a[c,k] s[c,o,k] v[c,k]``.

    ``v`` (C, K, P), ``w`` (O, K), ``s`` (C, O, K) and ``a`` (C, K) or None
    (all ones) may be any strided views: the per-species form passes
    ``v = XE``, ``w = Ymask.T``, ``s = Z.transpose(1, 2)``; the per-row
    form ``v = Lambda.transpose(1, 2)``, ``w = Ymask``, ``s = S``, ``a =
    iSigma``.  Returns ``G`` (C, O, P, P) and ``R`` (C, O, P).

    ``bf16``: the bf16 form (a policy'd block's masked mx einsums, ``w`` a
    0/1 mask): ``a`` and ``v`` rounded to bfloat16 for G, ``s a`` formed in
    float32 and rounded, and ``v`` rounded, for R; float32 accumulation."""
    C, Kd, P = v.shape
    O = w.shape[0]
    if w.shape != (O, Kd) or s.shape != (C, O, Kd) or (
            a is not None and a.shape != (C, Kd)):
        raise ValueError(f"masked_gram: v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, s {tuple(s.shape)}, a "
                         f"{None if a is None else tuple(a.shape)}")
    if bf16 and a is not None:
        s = s * a[:, None, :]          # the JAX package's S * iSigma
    if not v.is_cuda:
        if bf16:
            return _masked_gram_bf16_plain(v, w, s, a)
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
    key = (P, v.device)
    if key not in _columns:
        _columns[key] = tuple(t.to(v.device) for t in gram_columns(P))
    colp, colq = _columns[key]
    NG, T = gram_tiles(P)
    S, chunk = gram_splits(C, O, Kd, P)
    kB = (NG + 1) * _SLOT
    B = v.new_empty((C, T, Kd, kB))
    partial = v.new_empty((S, C, O, T * kB))
    with torch.cuda.device(v.device):
        code = K.library().hmsc_masked_gram(
            v.data_ptr(), *v.stride(), w.data_ptr(), *w.stride(),
            None if a is None else a.data_ptr(),
            *((0, 0) if a is None else a.stride()), s.data_ptr(),
            *s.stride(), colp.data_ptr(), colq.data_ptr(), B.data_ptr(),
            partial.data_ptr(), G.data_ptr(), R.data_ptr(), C, O, Kd, P, NG,
            T, S, chunk, int(bf16), K.stream_of(v))
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


def _masked_gram_bf16_plain(v, w, sa, a):
    """The bf16 form's plain version: the JAX package's masked mx einsums
    (``updaters.py:246-250, 278-279, 618-623`` under a scope), ``sa`` the
    right-hand side's ``s a`` already formed in float32."""
    rv = round_bf16(v)
    wa = w[None] if a is None else w[None] * round_bf16(a)[:, None, :]
    G = torch.einsum("cok,ckp,ckq->copq", wa.expand(v.shape[0], -1, -1), rv,
                     rv)
    R = torch.einsum("cok,ckp->cop", round_bf16(sa) * w[None], rv)
    return G, R
