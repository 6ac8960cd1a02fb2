"""The serving kernels (port of the compute in ``hmsc_tpu/serve/kernels.py``),
each written by hand for Hopper (``csrc/``) with its plain PyTorch version
beside it:

- B9a :func:`serve_predict` — the fused marginal prediction: linear
  predictor, link (expected or sampled), back-scaling, then the mean and
  population sd over the draws, or the (n, B, ns) draws themselves
  (``csrc/serve_predict.cu``);
- B9c :func:`draw_quantiles` — full-draw quantiles with ``jnp.quantile``'s
  linear interpolation, by an exact radix select of the ranks each
  quantile needs, at any draw count (``csrc/serve_quantile.cu``);
- B9b :func:`serve_conditional` — the per-draw Gibbs refinement of each
  query row's latent factors against its observed cells, the link and the
  moments (``csrc/serve_conditional.cu``).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version only for tensors on the CPU.  The posterior draws (Beta,
sigma, each level's Lambda and Eta, the last Eta row all zero for the
mean-field new unit) are float32 or bfloat16; the kernels widen them in
registers, the plain versions at entry.  Sampled draws come from Philox
keyed by ``seed`` / ``offset`` in the kernels, from a ``torch.Generator``
seeded with ``seed`` in the plain versions: the two streams differ, so the
card compares them by distribution and the tests inject noise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels as K
from .rand import _TINY, _ndtr, _truncated_normal_onesided_plain

__all__ = ["serve_predict", "draw_quantiles", "serve_conditional",
           "poisson_plain", "predict_geometry", "conditional_geometry",
           "quantile_layout"]

FAM_NORMAL, FAM_PROBIT, FAM_POISSON = 1, 2, 3
# csrc/serve_predict.cu: a block owns 64 species (two a lane) and up to 64
# query rows; its (at most 8) warps take the rows RB at a time and, below
# 64 rows, the draws of a ring stage in turn; 4 ring stages of draws.
# Blocks: two resident on each of an H100's 132 SMs, within ~112 KB of
# shared memory each
_PREDICT_TJ, _PREDICT_WARPS, _PREDICT_MAX_ROWS = 64, 8, 64
_PREDICT_ROWS_A_WARP = 8
_PREDICT_STAGES = 4
_PREDICT_TARGET_BLOCKS = 264
_PREDICT_SMEM_BUDGET, _PREDICT_SMEM_MAX = 112 * 1024, 227 * 1024
# csrc/serve_conditional.cu: a block of up to 16 warps (8 at nf 16), a warp
# a (query row, draw slot); up to 2 shared-memory stages of a draw's
# operands a slot; the draws cut into chunks for _COND_WAVES waves of the
# blocks resident on an H100's 132 SMs, within its 65536 registers (~128 a
# thread, ~255 at nf 16)
_COND_WARPS, _COND_MAX_STAGES, _COND_WAVES = 16, 2, 1
_COND_SMS, _SM_REGISTERS = 132, 65536
_SMEM_SM = 228 * 1024              # an SM's shared memory, 1 KB a block kept
# csrc/serve_predict.cu / serve_conditional.cu limits
_MAX_LEVELS, _MAX_NC, _MAX_NF_TOTAL = 8, 64, 64
_COND_NF = (4, 8, 16)
# one warp's row state (18 bytes a species) within a block's 227 KB
_COND_MAX_SPECIES = 10240
# csrc/serve_quantile.cu: a block of 8 columns, a warp each; up to
# QUANTILE_STAGED_MAX draws its tile is staged in shared memory ([draw][9]
# words); each warp keeps a histogram of 2^QUANTILE_DIGIT_BITS bins (a pad
# word every 32), QUANTILE_FEW ranked keys, six words a rank (two ranks a
# quantile) and a buffer of QUANTILE_BUFFER keys of the wanted bins; a
# launch takes up to QUANTILE_MAX_Q quantiles; a bin of QUANTILE_FEW keys
# or fewer is ranked exactly
_QUANTILE_COLS = 8
QUANTILE_STAGED_MAX = 2048
QUANTILE_DIGIT_BITS = 8
QUANTILE_FEW = 64
QUANTILE_BUFFER = 320
QUANTILE_MAX_Q = 16


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------

class PredictGeometry(NamedTuple):
    """B9a's launch: ``rb`` rows a warp, ``wr`` warps over rows and ``wd``
    over the draws of a stage (a block of ``32 wr wd`` threads owns ``rt =
    wr rb`` rows), the draws cut into ``S`` chunks of ``D``; ``smem`` bytes
    of dynamic shared memory a block."""
    rb: int
    wr: int
    wd: int
    D: int
    S: int
    smem: int

    @property
    def rt(self):
        return self.wr * self.rb


def _round_up(x, m):
    return -(-x // m) * m


def _predict_smem(nc, nft, rt, wd, bf16=False):
    """Dynamic shared memory of a B9a block (``csrc/serve_predict.cu ·
    make_layout``): 4 ring stages of ``wd`` draw slots, each the rt x RP
    row block, the RP + 1 slab rows of 64 species (bfloat16: 34 words,
    plus the Eta words and the halves' offsets), then the tables."""
    RP, K = _round_up(nc + nft, 4), nc + nft + 1
    TW = _PREDICT_TJ // 2 + 2 if bf16 else _PREDICT_TJ
    slot = 4 * rt * RP + 4 * (RP + 1) * TW
    if bf16:
        slot += 4 * rt * nft + _round_up(rt * nft, 4) + _round_up(RP + 1, 4)
    ring = _PREDICT_STAGES * wd * _round_up(slot, 16)
    comb = 4 * 2 * (wd // 2) * rt * _PREDICT_TJ
    return _round_up(max(ring, comb), 16) + 16 * K + 8 * rt * nft + 16 * 8


def predict_geometry(n: int, B: int, ns: int, nc: int, nft: int,
                     bf16: bool = False) -> PredictGeometry:
    """B9a's launch geometry, a function of the shape alone: the row tile
    is the power of two >= B up to 64 (rb = min(8, tile) rows a warp), the
    warps left over take draw slots, fewer where shared memory would pass
    ~112 KB; where even one slot passes it, a smaller row tile, or the
    largest that fits a block at all; the draws are cut into as many
    chunks as keep the blocks within two an SM, each slot with two draws
    at least."""
    top = min(_PREDICT_MAX_ROWS, 1 << max(0, (max(B, 1) - 1).bit_length()))
    fits = []                       # (rt, wd) within a block's maximum
    rt = top
    while rt >= 1:
        wd = _PREDICT_WARPS // (rt // min(_PREDICT_ROWS_A_WARP, rt))
        while wd > 1 and _predict_smem(nc, nft, rt, wd, bf16) \
                > _PREDICT_SMEM_BUDGET:
            wd //= 2
        smem = _predict_smem(nc, nft, rt, wd, bf16)
        if smem <= _PREDICT_SMEM_BUDGET:
            fits.insert(0, (rt, wd))
            break
        if smem <= _PREDICT_SMEM_MAX:
            fits.append((rt, wd))
        rt //= 2
    if not fits:
        raise ValueError(f"serve_predict: {nc} covariates and {nft} factors "
                         "need more shared memory than a block has")
    rt, wd = fits[0]
    rb = min(_PREDICT_ROWS_A_WARP, rt)
    smem = _predict_smem(nc, nft, rt, wd, bf16)
    tiles = -(-ns // _PREDICT_TJ) * -(-max(B, 1) // rt)
    S = max(1, min(_PREDICT_TARGET_BLOCKS // tiles, n // (2 * wd)))
    D = -(-n // S)
    return PredictGeometry(rb, rt // rb, wd, D, -(-n // D), smem)


class ConditionalGeometry(NamedTuple):
    """B9b's launch: a block of ``warps = rows x slots`` warps owns
    ``rows`` query rows, each of its ``slots`` draw slots a chunk of ``D``
    draws (``S`` chunks in all), with ``stages`` (0, 1 or 2) shared-memory
    copies of a draw's operands a slot; ``smem`` bytes of dynamic shared
    memory a block."""
    rows: int
    slots: int
    stages: int
    D: int
    S: int
    smem: int

    @property
    def warps(self):
        return self.rows * self.slots


def _conditional_smem(ns, nc, nfs, nfm, bf16, warps, slots, stages):
    """Dynamic shared memory of a B9b block (``csrc/serve_conditional.cu ·
    make_layout``): ``slots x stages`` copies of a draw's Lambda_r, Beta and
    sigma (each with 16 bytes of slack to align its copies) plus 1 / sigma
    and its square root, then each warp's row state: the observed species'
    entries and bits, E, z (with more than one level) and its small tables
    (the moments live in the chunks' scratch)."""
    ws = 2 if bf16 else 4
    r16 = lambda b: _round_up(b, 16)                     # noqa: E731
    stage = (sum(r16(nf * ns * ws + 16) for nf in nfs)
             + r16(nc * ns * ws + 16) + r16(ns * ws + 16) + 2 * r16(4 * ns))
    nr, nft = len(nfs), sum(nfs)
    warp = (r16(4 * ns) + r16(4 * -(-ns // 32))
            + r16(4 * ns) * (1 + int(nr > 1))
            + r16(4 * (nc + nr * nfm * nfm + nfm * (nfm + 1) // 2 + 2 * nft
                       + nfm)))
    return slots * stages * stage + warps * warp


def conditional_geometry(n: int, B: int, ns: int, nc: int, nfs,
                         bf16: bool = False) -> ConditionalGeometry:
    """B9b's launch geometry, a function of the shape alone: a warp a query
    row, ``rows`` the power of two >= B up to the block's warps (16, or 8
    at nf 16), the warps
    left over on draw slots; two stages of each slot's draws in shared
    memory where they fit, else one, else none (the warps read the draws
    from L2; so too with one row a block, which shares nothing); fewer
    warps where even the rows' state does not fit; the draws cut into as
    many chunks as keep the resident blocks busy for ``_COND_WAVES``
    waves."""
    nfs = [int(f) for f in nfs] or [1]
    nfm = next((m for m in _COND_NF if m >= max(nfs)), None)
    if nfm is None:
        raise ValueError(f"serve_conditional: at most {_COND_NF[-1]} factors "
                         f"a level, got {max(nfs)}")
    warps = _COND_WARPS if nfm < 16 else _COND_WARPS // 2
    regs = 128 if nfm < 16 else 255
    while True:
        rows = min(warps, 1 << max(0, (max(B, 1) - 1).bit_length()))
        slots = warps // rows
        for stages in range(min(2, _COND_MAX_STAGES), -1, -1):
            if stages and rows == 1:
                continue
            smem = _conditional_smem(ns, nc, nfs, nfm, bf16, warps, slots,
                                     stages)
            if smem <= _PREDICT_SMEM_MAX:
                break
        else:
            if warps == 1:
                raise ValueError(
                    f"serve_conditional: {ns} species need more shared "
                    "memory than a block has")
            warps //= 2
            continue
        break
    resident = max(1, min(_SMEM_SM // (smem + 1024),
                          _SM_REGISTERS // (regs * 32 * warps)))
    groups = -(-max(B, 1) // rows)
    per_group = max(1, _COND_WAVES * _COND_SMS * resident // groups)
    S = min(n, per_group * slots)
    D = -(-n // S)
    return ConditionalGeometry(rows, slots, stages, D, -(-n // D), smem)


def quantile_layout(n: int):
    """B9c's launch shape for ``n`` draws: ``(staged, shared memory bytes a
    block)``.  Up to ``QUANTILE_STAGED_MAX`` draws a block stages its 8
    columns in shared memory; above it each pass reads its column from
    global memory.  Any ``n >= 1`` is served."""
    if n < 1:
        raise ValueError("draw_quantiles: no draws")
    bins = 1 << QUANTILE_DIGIT_BITS
    warp = ((bins + bins // 32) + QUANTILE_FEW + 12 * QUANTILE_MAX_Q
            + QUANTILE_BUFFER)
    staged = n <= QUANTILE_STAGED_MAX
    words = _QUANTILE_COLS * warp + (n * (_QUANTILE_COLS + 1) if staged
                                     else 0)
    return staged, 4 * words


# ---------------------------------------------------------------------------
# shared argument checks
# ---------------------------------------------------------------------------

def _draw_dtype(Beta, sigma, lams, etas):
    dt = Beta.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"posterior draws must be float32 or bfloat16, got "
                         f"{dt}")
    for t in (sigma, *lams, *etas):
        if t.dtype != dt:
            raise ValueError("Beta, sigma, Lambda and Eta must share one "
                             "dtype")
    return dt


def _check_cuda(name, dev, tensors):
    for label, t in tensors:
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous tensor "
                             f"on {dev}")


def _level_args(lams, etas):
    nr = len(lams)
    if nr > _MAX_LEVELS:
        raise ValueError(f"the serving kernels take at most {_MAX_LEVELS} "
                         f"random levels, got {nr}")
    lam_p = (ctypes.c_ulonglong * max(nr, 1))(*[t.data_ptr() for t in lams])
    eta_p = (ctypes.c_ulonglong * max(nr, 1))(*[t.data_ptr() for t in etas])
    nf = (ctypes.c_int * max(nr, 1))(*[int(t.shape[1]) for t in lams])
    npr = (ctypes.c_int * max(nr, 1))(*[int(t.shape[1]) for t in etas])
    return (lam_p, eta_p, nf, npr), nr


def _factor_map(lams):
    """B9a's flat factor map: for each factor f of a query row's
    concatenated factors (the levels in order), its level and its column
    within the level, as two ctypes int arrays (resolved here so the
    kernel's staging loop does no search)."""
    pairs = [(r, c) for r, lam in enumerate(lams)
             for c in range(int(lam.shape[1]))]
    m = max(len(pairs), 1)
    return ((ctypes.c_int * m)(*[r for r, _ in pairs]),
            (ctypes.c_int * m)(*[c for _, c in pairs]))


def _check_shapes(name, X, uidx, Beta, sigma, lams, etas, fam, ym, ys):
    n, nc, ns = Beta.shape
    B = X.shape[0]
    if X.shape != (B, nc) or sigma.shape != (n, ns) or fam.shape != (ns,) \
            or ym.shape != (ns,) or ys.shape != (ns,) \
            or uidx.shape != (len(lams), B) or len(etas) != len(lams):
        raise ValueError(f"{name}: shapes X {tuple(X.shape)}, uidx "
                         f"{tuple(uidx.shape)}, Beta {tuple(Beta.shape)}, "
                         f"sigma {tuple(sigma.shape)}, fam {tuple(fam.shape)}")
    for lam, eta in zip(lams, etas):
        if lam.shape[0] != n or lam.shape[2] != ns or eta.shape[0] != n \
                or eta.shape[2] != lam.shape[1]:
            raise ValueError(f"{name}: Lambda {tuple(lam.shape)} and Eta "
                             f"{tuple(eta.shape)} do not match the draws")
    if nc > _MAX_NC or sum(int(l.shape[1]) for l in lams) > _MAX_NF_TOTAL:
        raise ValueError(f"{name}: at most {_MAX_NC} covariates and "
                         f"{_MAX_NF_TOTAL} factors over all levels")
    return n, B, ns, nc


# ---------------------------------------------------------------------------
# B9a: fused marginal prediction
# ---------------------------------------------------------------------------

def serve_predict(X, uidx, Beta, sigma, lams, etas, fam, ym, ys, *,
                  expected: bool, moments: bool = True, draws: bool = False,
                  seed: int = 0, offset: int = 0, out=None):
    """Predicted responses at query rows ``X`` (B, nc) with unit rows
    ``uidx`` (nr, B) int32 into each level's Eta.

    Returns ``(mean, sd, y)``: the (B, ns) mean and population sd over the
    draws when ``moments`` (else None), and the (n, B, ns) responses when
    ``draws`` (else None).  ``expected`` returns each family's location
    (ndtr for probit, exp(L + sigma / 2) for Poisson), else sampled
    responses.  ``out`` optionally holds preallocated (mean, sd) tensors."""
    if not (moments or draws):
        raise ValueError("serve_predict: ask for moments, draws or both")
    _draw_dtype(Beta, sigma, lams, etas)
    n, B, ns, nc = _check_shapes("serve_predict", X, uidx, Beta, sigma,
                                 lams, etas, fam, ym, ys)
    if not Beta.is_cuda:
        gen = torch.Generator().manual_seed(int(seed) ^ int(offset))
        y = _serve_predict_plain(X, uidx, Beta, sigma, lams, etas, fam, ym,
                                 ys, expected, gen)
        mean = sd = None
        if moments:
            mean, sd = y.mean(dim=0), y.std(dim=0, correction=0)
            if out is not None:
                out[0].copy_(mean)
                out[1].copy_(sd)
                mean, sd = out
        return mean, sd, (y if draws else None)
    dev = Beta.device
    _check_cuda("serve_predict", dev, [
        ("X", X), ("uidx", uidx), ("Beta", Beta), ("sigma", sigma),
        ("fam", fam), ("ym", ym), ("ys", ys)]
        + [("Lambda", t) for t in lams] + [("Eta", t) for t in etas])
    if X.dtype != torch.float32 or uidx.dtype != torch.int32 \
            or fam.dtype != torch.int32 or ym.dtype != torch.float32 \
            or ys.dtype != torch.float32:
        raise ValueError("serve_predict: X, ym, ys float32; uidx, fam int32")
    bf16 = Beta.dtype == torch.bfloat16
    nft = sum(int(l.shape[1]) for l in lams)
    geo = predict_geometry(n, B, ns, nc, nft, bf16)
    for label, t in [("Beta", Beta), ("sigma", sigma)] + [
            ("Lambda", t) for t in lams] + [("Eta", t) for t in etas]:
        if t.data_ptr() % 4:
            raise ValueError(f"serve_predict: {label}'s storage must be "
                             "4-byte aligned")
    f32 = dict(device=dev, dtype=torch.float32)
    y = torch.empty((n, B, ns), **f32) if draws else None
    mean = sd = pmean = pm2 = None
    if moments:
        mean, sd = out if out is not None else (
            torch.empty((B, ns), **f32), torch.empty((B, ns), **f32))
        _check_cuda("serve_predict", dev, [("out mean", mean),
                                           ("out sd", sd)])
        pmean = torch.empty((geo.S, B, ns), **f32)
        pm2 = torch.empty((geo.S, B, ns), **f32)
    lv, nr = _level_args(lams, etas)
    fl, fc = _factor_map(lams)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    with torch.cuda.device(dev):
        code = K.library().hmsc_serve_predict(
            X.data_ptr(), uidx.data_ptr(), Beta.data_ptr(), sigma.data_ptr(),
            *(ctypes.addressof(a) for a in lv), nr, ctypes.addressof(fl),
            ctypes.addressof(fc), fam.data_ptr(), ym.data_ptr(),
            ys.data_ptr(), ptr(y), ptr(pmean), ptr(pm2), ptr(mean), ptr(sd),
            n, B, ns, nc, geo.rb, geo.wr, geo.wd, geo.D, geo.S, geo.smem,
            int(bf16),
            int(bool(expected)), int(seed), int(offset) & 0xFFFFFFFF,
            K.stream_of(Beta))
    K.check(code, "serve_predict")
    K.launches["serve_predict"] += 1
    return mean, sd, y


def _widen(*ts):
    return [t.float() for t in ts]


def _serve_predict_plain(X, uidx, Beta, sigma, lams, etas, fam, ym, ys,
                         expected, gen):
    """The JAX kernel (``hmsc_tpu/serve/kernels.py:160-183``) step by step:
    the (n, B, ns) linear predictor, the link, the back-scaling."""
    Beta, sigma = _widen(Beta, sigma)
    L = torch.einsum("yc,ncj->nyj", X, Beta)
    for r, (lam, eta) in enumerate(zip(lams, etas)):
        rows = eta.float()[:, uidx[r].long(), :]
        L = L + torch.einsum("nyf,nfj->nyj", rows, lam.float())
    if expected:
        out = torch.where(fam == FAM_PROBIT, _ndtr(L), L)
        out = torch.where(fam == FAM_POISSON,
                          torch.exp(L + sigma[:, None, :] / 2), out)
    else:
        eps = torch.randn(L.shape, generator=gen, dtype=L.dtype,
                          device=L.device)
        Z = L + torch.sqrt(sigma)[:, None, :] * eps
        out = torch.where(fam == FAM_PROBIT, (Z > 0).to(Z.dtype), Z)
        pois = fam == FAM_POISSON
        if bool(pois.any()):
            draws = poisson_plain(torch.exp(torch.clamp(Z[..., pois],
                                                        max=30.0)), gen)
            out[..., pois] = draws.to(out.dtype)
    return out * ys + ym


def poisson_plain(lam, gen):
    """Poisson draws at rates ``lam`` (any shape, float64 arithmetic) by
    the kernel's algorithm: Knuth's product of uniforms below a rate of 10,
    Hormann's transformed rejection with squeeze (PTRS, numpy's
    ``random_poisson_ptrs``) above; NaN where the rate is NaN, 0 at 0."""
    flat = lam.reshape(-1).double()
    out = torch.zeros_like(flat)
    out[torch.isnan(flat)] = float("nan")

    def uniform(m):
        return torch.rand(m, generator=gen, dtype=torch.float64,
                          device=flat.device).clamp_min_(
            _TINY)

    small = torch.nonzero((flat > 0) & (flat < 10)).flatten()
    if small.numel():
        floor_p = torch.exp(-flat[small])
        p = torch.ones_like(floor_p)
        k = torch.zeros_like(floor_p)
        live = torch.arange(small.numel())
        while live.numel():
            p[live] *= uniform(live.numel())
            done = p[live] <= floor_p[live]
            live = live[~done]
            k[live] += 1
        out[small] = k
    big = torch.nonzero(flat >= 10).flatten()
    if big.numel():
        L = flat[big]
        slam, loglam = torch.sqrt(L), torch.log(L)
        b = 0.931 + 2.53 * slam
        a = -0.059 + 0.02483 * b
        invalpha = 1.1239 + 1.1328 / (b - 3.4)
        vr = 0.9277 - 3.6224 / (b - 2.0)
        res = torch.empty_like(L)
        live = torch.arange(L.numel())
        while live.numel():
            m = live.numel()
            U = uniform(m) - 0.5
            V = uniform(m)
            us = 0.5 - U.abs()
            al, bl = a[live], b[live]
            k = torch.floor((2.0 * al / us + bl) * U + L[live] + 0.43)
            quick = (us >= 0.07) & (V <= vr[live])
            reject = (k < 0) | ((us < 0.013) & (V > us))
            slow = (torch.log(V) + torch.log(invalpha[live])
                    - torch.log(al / (us * us) + bl)
                    <= -L[live] + k * loglam[live]
                    - torch.lgamma(k.clamp_min(0) + 1.0))
            acc = quick | (~reject & slow)
            res[live[acc]] = k[acc]
            live = live[~acc]
        out[big] = res
    return out.reshape(lam.shape)


# ---------------------------------------------------------------------------
# B9c: full-draw quantiles
# ---------------------------------------------------------------------------

def draw_quantiles(y, q, out=None):
    """Quantiles over the leading (draw) axis of ``y`` (n, ...) at the
    probabilities ``q`` (nq,), ``jnp.quantile``'s linear interpolation;
    returns (nq, ...).  NaN for a column holding a NaN.  The kernel takes
    ``QUANTILE_MAX_Q`` quantiles a launch (one launch at the serving
    engine's few)."""
    n = y.shape[0]
    q = torch.as_tensor(q, dtype=torch.float32, device=y.device)
    if not y.is_cuda:
        res = _draw_quantiles_plain(y, q)
        return res if out is None else out.copy_(res)
    if y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError("draw_quantiles: y must be a contiguous float32 "
                         "tensor")
    staged, _ = quantile_layout(n)
    cols = y[0].numel()
    q = q.contiguous()
    res = out if out is not None else torch.empty(
        (q.numel(),) + tuple(y.shape[1:]), device=y.device,
        dtype=torch.float32)
    _check_cuda("draw_quantiles", y.device, [("out", res)])
    for s in range(0, q.numel(), QUANTILE_MAX_Q):
        nq = min(QUANTILE_MAX_Q, q.numel() - s)
        with torch.cuda.device(y.device):
            code = K.library().hmsc_serve_quantile(
                y.data_ptr(), cols, n, int(staged), q[s:].data_ptr(), nq,
                res[s:].data_ptr(), K.stream_of(y))
        K.check(code, "serve_quantile")
        K.launches["serve_quantile"] += 1
    return res


def _draw_quantiles_plain(y, q):
    """``jnp.quantile(y, q, axis=0)`` (method "linear") step by step in
    float32: sort, position q (n - 1), the two neighbours weighted."""
    n = y.shape[0]
    srt = torch.sort(y.float(), dim=0).values
    pos = q * (float(n) - 1.0)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1.0 - w_hi
    shape = (-1,) + (1,) * (y.dim() - 1)
    lo_i = lo.long().clamp(0, n - 1)
    hi_i = hi.long().clamp(0, n - 1)
    res = srt[lo_i] * w_lo.reshape(shape) + srt[hi_i] * w_hi.reshape(shape)
    return torch.where(torch.isnan(y).any(dim=0), float("nan"), res)


# ---------------------------------------------------------------------------
# B9b: conditional prediction
# ---------------------------------------------------------------------------

def serve_conditional(X, uidx, Yc, mask, Beta, sigma, lams, etas, fam, ym,
                      ys, *, mcmc_step: int, expected: bool, seed: int = 0,
                      offset: int = 0, noise=None, out=None):
    """Conditional prediction (the JAX ``make_conditional_kernel``): each
    query row is its own unit, its factors start from the gathered Eta rows
    and are refreshed by ``mcmc_step`` Gibbs iterations of (Eta, Z) against
    its observed cells (``mask`` 1, ``Yc`` on the model's y-scaled Z scale,
    0 where unobserved), under the N(0, 1) prior.  Returns the (B, ns) mean
    and population sd of the responses over the draws.

    ``noise`` injects every draw: a dict with ``eps_z`` and ``u_z`` (n,
    mcmc_step + 1, B, ns), ``eps_rows`` (n, mcmc_step, B, nf_total) and, when
    sampled, ``eps_out`` (n, B, ns)."""
    _draw_dtype(Beta, sigma, lams, etas)
    n, B, ns, nc = _check_shapes("serve_conditional", X, uidx, Beta, sigma,
                                 lams, etas, fam, ym, ys)
    if Yc.shape != (B, ns) or mask.shape != (B, ns):
        raise ValueError("serve_conditional: Yc and mask must be (B, ns)")
    steps = int(mcmc_step)
    if steps < 0:
        raise ValueError("serve_conditional: mcmc_step must be >= 0")
    nft = sum(int(l.shape[1]) for l in lams)
    if noise is not None:
        want = {"eps_z": (n, steps + 1, B, ns), "u_z": (n, steps + 1, B, ns),
                "eps_rows": (n, steps, B, nft)}
        if not expected:
            want["eps_out"] = (n, B, ns)
        for k, shape in want.items():
            if k not in noise or tuple(noise[k].shape) != shape:
                raise ValueError(f"serve_conditional: noise[{k!r}] must be "
                                 f"{shape}")
    if not Beta.is_cuda:
        gen = torch.Generator().manual_seed(int(seed) ^ int(offset))
        mean, sd = _serve_conditional_plain(X, uidx, Yc, mask, Beta, sigma,
                                            lams, etas, fam, ym, ys, steps,
                                            expected, noise, gen)
        if out is not None:
            out[0].copy_(mean)
            out[1].copy_(sd)
            return out
        return mean, sd
    dev = Beta.device
    nz = noise or {}
    _check_cuda("serve_conditional", dev, [
        ("X", X), ("uidx", uidx), ("Yc", Yc), ("mask", mask),
        ("Beta", Beta), ("sigma", sigma), ("fam", fam), ("ym", ym),
        ("ys", ys)] + [("Lambda", t) for t in lams]
        + [("Eta", t) for t in etas] + [(k, v) for k, v in nz.items()])
    nf_max = max((int(l.shape[1]) for l in lams), default=1)
    nfm = next((m for m in _COND_NF if m >= nf_max), None)
    if nfm is None:
        raise ValueError(f"serve_conditional: at most {_COND_NF[-1]} factors "
                         f"a level, got {nf_max}")
    if ns > _COND_MAX_SPECIES:
        raise ValueError(f"serve_conditional: at most {_COND_MAX_SPECIES} "
                         "species (a warp's row state in shared memory)")
    geo = conditional_geometry(n, B, ns, nc, [int(l.shape[1]) for l in lams],
                               Beta.dtype == torch.bfloat16)
    D, S = geo.D, geo.S
    f32 = dict(device=dev, dtype=torch.float32)
    mean, sd = out if out is not None else (
        torch.empty((B, ns), **f32), torch.empty((B, ns), **f32))
    pmean = torch.empty((S, B, ns), **f32)
    pm2 = torch.empty((S, B, ns), **f32)
    lv, nr = _level_args(lams, etas)
    ptr = lambda k: None if k not in nz else nz[k].data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        code = K.library().hmsc_serve_conditional(
            X.data_ptr(), uidx.data_ptr(), Yc.data_ptr(), mask.data_ptr(),
            Beta.data_ptr(), sigma.data_ptr(),
            *(ctypes.addressof(a) for a in lv), nr, fam.data_ptr(),
            ym.data_ptr(), ys.data_ptr(), ptr("eps_z"), ptr("u_z"),
            ptr("eps_rows"), ptr("eps_out"), pmean.data_ptr(),
            pm2.data_ptr(), mean.data_ptr(), sd.data_ptr(), n, B, ns, nc,
            steps, nfm, geo.rows, geo.slots, geo.stages, D, S,
            int(Beta.dtype == torch.bfloat16),
            int(bool(expected)), int(seed), int(offset) & 0xFFFFFFFF,
            K.stream_of(Beta))
    K.check(code, "serve_conditional")
    K.launches["serve_conditional"] += 1
    return mean, sd


def _conditional_predictor(X, uidx, Yc, mask, Beta, sigma, lams, etas, fam,
                           steps, noise, gen, dtype=torch.float32):
    """B9b's per-draw linear predictor after ``steps`` sweeps of (each
    level's rows, Z) given the observed cells, computed in ``dtype``:
    ``(E (n, B, ns), LFix (n, B, ns), rows)``, ``rows[r]`` (n, B, nf_r) the
    rows' final latent factors."""
    Beta, sigma, X = Beta.to(dtype), sigma.to(dtype), X.to(dtype)
    Yc, mask = Yc.to(dtype), mask.to(dtype)
    lams = [l.to(dtype) for l in lams]
    LFix = torch.einsum("yc,ncj->nyj", X, Beta)
    isig = 1.0 / sigma
    rows = [eta.to(dtype)[:, uidx[r].long(), :] for r, eta in enumerate(etas)]
    offs = [0]
    for lam in lams:
        offs.append(offs[-1] + lam.shape[1])
    chol = []
    for lam in lams:
        U = torch.einsum("nfj,ngj,nj,yj->nyfg", lam, lam, isig, mask)
        eye = torch.eye(lam.shape[1], dtype=U.dtype, device=U.device)
        Lc, info = torch.linalg.cholesky_ex(U + eye)
        chol.append(torch.where((info != 0)[..., None, None],
                                float("nan"), Lc))

    def loading(skip=None):
        acc = 0.0
        for r, lam in enumerate(lams):
            if r != skip:
                acc = acc + torch.einsum("nyf,nfj->nyj", rows[r], lam)
        return acc

    std = isig ** -0.5

    def z_given_yc(E, t):
        if noise is not None:
            eps = noise["eps_z"][:, t].to(dtype)
            u = noise["u_z"][:, t].to(dtype)
        else:
            eps = torch.randn(E.shape, generator=gen, dtype=E.dtype,
                              device=E.device)
            u = torch.rand(E.shape, generator=gen, dtype=E.dtype,
                           device=E.device).clamp_min_(_TINY)
        z = E + std[:, None, :] * eps
        obs = mask > 0
        z = torch.where((fam == FAM_NORMAL) & obs, Yc, z)
        ztn = _truncated_normal_onesided_plain(E, std, Yc, u)
        return torch.where((fam == FAM_PROBIT) & obs, ztn, z)

    z = z_given_yc(LFix + loading(), 0)
    for s in range(steps):
        for r, lam in enumerate(lams):
            others = loading(skip=r) if len(lams) > 1 else 0.0
            S = z - LFix - others
            F = torch.einsum("nyj,nfj->nyf", S * isig[:, None, :] * mask, lam)
            Lc = chol[r]
            mean = torch.cholesky_solve(F[..., None], Lc)[..., 0]
            if noise is not None:
                eps = noise["eps_rows"][:, s, :, offs[r]:offs[r + 1]].to(
                    dtype)
            else:
                eps = torch.randn(mean.shape, generator=gen,
                                  dtype=mean.dtype, device=mean.device)
            nz = torch.linalg.solve_triangular(Lc.mT, eps[..., None],
                                               upper=True)[..., 0]
            rows[r] = mean + nz
        z = z_given_yc(LFix + loading(), s + 1)
    return LFix + loading(), LFix, rows


def _serve_conditional_plain(X, uidx, Yc, mask, Beta, sigma, lams, etas,
                             fam, ym, ys, steps, expected, noise, gen):
    """``_cond_one_draw`` (``hmsc_tpu/serve/kernels.py:255-328``) batched
    over the draws: the per-level grams and Cholesky factors, the initial
    Z, ``steps`` sweeps of (each level's rows, Z), the link."""
    E, _, _ = _conditional_predictor(X, uidx, Yc, mask, Beta, sigma, lams,
                                     etas, fam, steps, noise, gen)
    sigma = sigma.float()
    if expected:
        out = torch.where(fam == FAM_PROBIT, _ndtr(E), E)
    else:
        eps = (noise["eps_out"].float() if noise is not None else
               torch.randn(E.shape, generator=gen, dtype=E.dtype,
                           device=E.device))
        Z = E + torch.sqrt(sigma)[:, None, :] * eps
        out = torch.where(fam == FAM_PROBIT, (Z > 0).to(Z.dtype), Z)
    y = out * ys + ym
    return y.mean(dim=0), y.std(dim=0, correction=0)
