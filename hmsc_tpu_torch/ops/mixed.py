"""Mixed-precision scopes and the routed contractions (port of
``hmsc_tpu/ops/mixed.py``), with kernel B10 (``csrc/mixed_gemm.cu``).

The per-block precision policy (:mod:`hmsc_tpu_torch.mcmc.precision`)
decides which schedule blocks compute their heavy products in bfloat16;
this module is the mechanism: a scope the sweep enters around a policy'd
block, a table of staged shadows entered once around the sweep, and
``matmul`` / ``einsum`` wrappers the updaters route their products
through.

- **No active scope: the plain call.**  Outside a bf16 scope every wrapper
  is the torch call it replaces (``a @ b``, ``torch.einsum``), so the
  default path's draws do not change by one bit.
- **bf16 operands, float32 accumulation and output.**  Inside a scope a
  routed product rounds its float operands to bfloat16 (round to nearest
  even, as XLA's convert) and sums the exact products in float32: on the
  card kernel B10, a batched strided GEMM on the tensor cores
  (``mma.sync`` m16n8k16 bf16 with float32 accumulators, the operands read
  in place through their strides, rounded at load where they are float32,
  split over K with a deterministic ordered second pass); on the CPU its
  plain version, the rounded operands widened and multiplied in float32.
- **Staged operands.**  :func:`staged` resolves a model-data name to the
  policy's bf16 shadow inside a bf16 scope (``x`` itself outside one, or
  where the policy does not stage the name); B10 reads a shadow as it is.

Reductions outside these wrappers, Cholesky factorisations and triangular
solves never come here: their pivots stay float32.  The scopes are plain
Python stacks: the sweep runs on the host, block by block.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from .. import kernels as K

__all__ = ["scope", "staged_scope", "active_dtype", "active",
           "layouts_active", "staged", "staged_level", "matmul", "einsum",
           "round_bf16", "mixed_gemm", "gemm_splits"]


@dataclasses.dataclass(frozen=True)
class _Scope:
    dtype: object          # torch.bfloat16, or None: pass-through
    layouts: bool          # the fused solve layouts (bf16 scopes only)


_SCOPES: list = []
_STAGED: list = []


@contextlib.contextmanager
def scope(dtype, layouts: bool = True):
    """Enter a mixed-precision compute scope for one schedule block:
    ``dtype`` ``"bfloat16"``, or ``None`` / ``"float32"`` for a layout-only
    scope (exact float32 compute)."""
    if dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"mixed.scope: dtype must be 'bfloat16' or "
                         f"'float32', got {dtype!r}")
    dt = torch.bfloat16 if dtype == "bfloat16" else None
    _SCOPES.append(_Scope(dtype=dt, layouts=bool(layouts)))
    try:
        yield
    finally:
        _SCOPES.pop()


@contextlib.contextmanager
def staged_scope(staged: dict | None):
    """Provide the staged shadow table for a sweep (entered once around the
    block chain; each block's :func:`scope` decides whether lookups
    resolve)."""
    _STAGED.append(staged or {})
    try:
        yield
    finally:
        _STAGED.pop()


def active_dtype():
    """The current compute dtype, or ``None`` outside any scope (or in a
    layout-only scope)."""
    return _SCOPES[-1].dtype if _SCOPES else None


def active() -> bool:
    """Whether a bf16 compute scope is active."""
    return active_dtype() is not None


def layouts_active() -> bool:
    """Whether the JAX package's fused batched layouts apply: a bf16 scope
    with ``layouts`` (``ops/linalg.py · sample_mvn_prec`` folds its mean
    and noise into one solve pair there, as the JAX package's does).  A
    layout-only scope (float32) keeps the exact engine's arithmetic."""
    return active() and _SCOPES[-1].layouts


def staged(name: str, x):
    """The policy's bf16 shadow of model-data array ``name`` inside an
    active bf16 scope; ``x`` itself otherwise."""
    if active() and _STAGED:
        shadow = _STAGED[-1].get(name)
        if shadow is not None:
            return shadow
    return x


def staged_level(name: str, r: int, x):
    """Per-level variant: level arrays stage under ``"<name>_<r>"``."""
    return staged(f"{name}_{r}", x)


def round_bf16(x):
    """``x`` rounded to bfloat16 (round to nearest even) and widened back to
    float32: the value a routed product reads."""
    return x.to(torch.bfloat16).float()


def matmul(a, b):
    """``a @ b``; bf16 operands, float32 accumulation and output inside an
    active scope (B10 on the card)."""
    if not active():
        return a @ b
    return mixed_gemm(a, b)


def _pair_einsum(eq: str, a, b):
    """A two-operand einsum as one :func:`mixed_gemm` by permute and
    reshape: batch indices (in both and in the output), contracted (in
    both, not in the output), then each side's own."""
    ins, out = eq.split("->")
    la, lb = ins.split(",")
    if len(set(la)) != len(la) or len(set(lb)) != len(lb) or any(
            i not in la + lb for i in out):
        raise ValueError(f"mixed.einsum: unsupported equation {eq!r}")
    size = {**dict(zip(la, a.shape)), **dict(zip(lb, b.shape))}
    batch = [i for i in out if i in la and i in lb]
    contr = [i for i in la if i in lb and i not in out]
    left = [i for i in la if i not in lb]
    right = [i for i in lb if i not in la]
    if any(i not in out for i in left + right):
        raise ValueError(f"mixed.einsum: {eq!r} sums an index of one "
                         "operand alone")
    nb = math.prod(size[i] for i in batch)
    M = math.prod(size[i] for i in left)
    N = math.prod(size[i] for i in right)
    Kd = math.prod(size[i] for i in contr)
    A = a.permute([la.index(i) for i in batch + left + contr]).reshape(
        nb, M, Kd)
    B = b.permute([lb.index(i) for i in batch + contr + right]).reshape(
        nb, Kd, N)
    y = mixed_gemm(A, B).reshape([size[i] for i in batch + left + right])
    have = batch + left + right
    return y.permute([have.index(i) for i in out])


def einsum(eq: str, *operands):
    """``torch.einsum``; inside an active scope bf16 operands with float32
    accumulation.  Two operands are one B10 call; with three, the first
    pair is one B10 call to a float32 intermediate and the third operand,
    rounded, meets it in float32, as XLA contracts the JAX package's
    three-operand einsums (the intermediate stays float32)."""
    if not active():
        return torch.einsum(eq, *operands)
    eq = eq.replace(" ", "")
    ins, out = eq.split("->")
    terms = ins.split(",")
    if len(terms) == 2:
        return _pair_einsum(eq, *operands)
    if len(terms) != 3:
        raise ValueError(f"mixed.einsum: unsupported equation {eq!r}")
    la, lb, lc = terms
    keep = "".join(i for i in dict.fromkeys(la + lb) if i in lc + out)
    t = _pair_einsum(f"{la},{lb}->{keep}", operands[0], operands[1])
    c = operands[2]
    if c.is_floating_point():
        c = round_bf16(c)
    return torch.einsum(f"{keep},{lc}->{out}", t, c)


# ---------------------------------------------------------------------------
# B10: the bf16 GEMM with float32 accumulation and output
# ---------------------------------------------------------------------------

# csrc/mixed_gemm.cu's tiles: 64 x 64 outputs a block, k tiles of 32
_BM, _BN, _BK = 64, 64, 32
# blocks a launch aims at: two on each of an H100's 132 SMs
_TARGET_BLOCKS = 2 * 132


def gemm_splits(nb: int, M: int, N: int, Kd: int):
    """``(S, chunk)``: K cut into ``S`` consecutive ranges of ``chunk`` (a
    multiple of the 32-deep k tile; none empty), enough that a launch has
    about ``_TARGET_BLOCKS`` blocks.  A function of the shape only, so the
    order of the final sum never changes from run to run."""
    base = nb * -(-M // _BM) * -(-N // _BN)
    k_tiles = max(1, -(-Kd // _BK))
    S = min(k_tiles, max(1, -(-_TARGET_BLOCKS // max(base, 1))))
    per = -(-k_tiles // S)
    return -(-k_tiles // per), per * _BK


def _as3(x, batch, nb):
    """``x`` as (nb, rows, cols) with its batch stride 0 where it has no
    batch of its own (a view where the strides allow)."""
    if x.dim() == 2:
        return x.unsqueeze(0), 0
    x = x.expand(*batch, *x.shape[-2:]).reshape(nb, *x.shape[-2:])
    return x, (x.stride(0) if nb > 1 else 0)


def mixed_gemm(a, b):
    """``round(a) @ round(b)`` in float32: ``a`` (..., M, K), ``b`` (..., K,
    N), each float32 (rounded to bfloat16) or bfloat16 (read as it is),
    batch dimensions broadcast; returns float32 (..., M, N).  On a CUDA
    tensor kernel B10, any strides; on the CPU the plain version."""
    if a.dim() < 2 or b.dim() < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"mixed_gemm: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if not a.is_cuda:
        return _mixed_gemm_plain(a, b)
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device or t.dtype not in (torch.float32,
                                                   torch.bfloat16):
            raise ValueError(f"mixed_gemm: {name} must be float32 or "
                             "bfloat16 on a's device")
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    nb = math.prod(batch)
    M, Kd, N = a.shape[-2], a.shape[-1], b.shape[-1]
    A, sa = _as3(a, batch, nb)
    B, sb = _as3(b, batch, nb)
    out = torch.empty((nb, M, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out.reshape(*batch, M, N)
    if Kd == 0:
        return out.zero_().reshape(*batch, M, N)
    S, chunk = gemm_splits(nb, M, N, Kd)
    partial = (torch.empty((S, nb, M, N), dtype=torch.float32,
                           device=a.device) if S > 1 else out)
    with torch.cuda.device(a.device):
        code = K.library().hmsc_mixed_gemm(
            A.data_ptr(), int(A.dtype == torch.bfloat16), sa, A.stride(1),
            A.stride(2), B.data_ptr(), int(B.dtype == torch.bfloat16), sb,
            B.stride(1), B.stride(2), out.data_ptr(), partial.data_ptr(),
            nb, M, N, Kd, S, chunk, K.stream_of(out))
    K.check(code, "mixed_gemm")
    K.launches["mixed_gemm"] += 1
    return out.reshape(*batch, M, N)


def _mixed_gemm_plain(a, b):
    """The JAX op (``preferred_element_type=float32`` on bf16 operands):
    the operands rounded to bfloat16, widened, multiplied in float32."""
    return round_bf16(a) @ round_bf16(b)
