"""Random-draw primitives (port of ``hmsc_tpu/ops/rand.py``).

Some of them are kernels written by hand for Hopper (``csrc/``):

- B1 :func:`truncated_normal_onesided` and :func:`probit_z_fused` — the
  probit Z draw from the linear predictor E, or with E formed in the
  kernel from X Beta and the level's loadings, a thread a row's four
  columns of four rows (``csrc/probit_z.cu``);
- B3 :func:`standard_gamma` — per-element Marsaglia-Tsang rejection
  (``csrc/standard_gamma.cu``), and its shrinkage form
  :func:`shrinkage_gamma` — a level's whole multiplicative-gamma shrinkage
  update (psi, the species sums, delta's draws and its sequential chain)
  in one launch (``csrc/shrinkage_gamma.cu``; the draw itself is
  ``csrc/gamma.cuh``, shared by both);
- B5 :func:`z_mixed` — the whole Z update of a model with Poisson columns
  (normal, probit and Polya-Gamma Poisson cells, then the imputation of
  missing ones) in one launch, a thread four columns of four rows as in B1
  (``csrc/poisson_z.cu``); :func:`poisson_z`, the Poisson branch alone, is
  the same kernel with the other columns kept;
- B4 :func:`gamma_v` — the whole GammaV block (the species sums, the
  Wishart draw of iV by Bartlett, Gamma | Beta, iV) in one launch, a block
  a chain (``csrc/gamma_v.cu``), where :func:`gamma_v_route` allows; its
  plain version is :func:`gamma_v_plain` on :func:`wishart`;
- B7 :func:`da_intercept_draw` — the probit-DA intercept interweave's
  per-species two-sided truncated normal, with its truncation interval
  reduced over the rows and the ``Z`` shift (``csrc/truncnorm_da.cu``);
  its plain version runs :func:`truncated_normal`, the JAX op.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain PyTorch version beside it only for a tensor on the CPU.  The plain
versions follow the JAX ops step by step; the tests hold them against the
JAX package and ``chip_smoke.py`` holds each kernel against its plain
version on the card.

:class:`Rng` carries a run's random streams: a ``torch.Generator`` on the
tensors' device for the draws made in PyTorch, and a host generator for the
(seed, offset) pairs that key the kernels' in-kernel Philox streams — a host
draw, so seeding a launch never waits for the device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import kernels as K
from .linalg import chol_spd, sample_mvn_prec
from .mixed import mixed_gemm

__all__ = ["Rng", "truncated_normal", "truncated_normal_onesided",
           "probit_z_fused", "probit_z_geometry",
           "standard_gamma", "shrinkage_gamma", "shrinkage_geometry",
           "shrinkage_choose", "shrinkage_launch",
           "shrinkage_shapes", "shrinkage_update", "delta_offset",
           "wishart", "gamma_v", "gamma_v_route", "gamma_v_plain",
           "polya_gamma", "poisson_z", "z_mixed",
           "da_intercept_draw"]

_TINY = 1e-38  # smallest safe f32 normal-ish (JAX package rand.py:18)
# f32 ndtri overflows to -inf below ~1e-33; quantile-space probabilities are
# floored here and the final clip bounds the draw
_P_FLOOR = 1e-30
# 1 - epsneg of f32: the largest float below 1 (ndtri(1) = inf)
_S_CEIL = 1.0 - 2.0 ** -24
# Marsaglia-Tsang candidate rounds of the plain gamma version (JAX default)
_GAMMA_ROUNDS = 8
# Poisson as the r -> inf limit of NB(r) (reference updateZ.R:68);
# csrc/poisson_z.cu hard-codes both
_NB_R = 1e3
_LOG_NB_R = math.log(_NB_R)


class Rng:
    """A run's random streams on ``device`` (see the module docstring)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.host = torch.Generator()
        self.host.manual_seed(int(seed) ^ 0x5DEECE66D)

    def normal(self, shape, dtype=torch.float32):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=dtype)

    def uniform(self, shape, dtype=torch.float32):
        """Uniforms on [1e-38, 1): never 0, so log(u) stays finite."""
        u = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=dtype)
        return u.clamp_min_(_TINY)

    def philox(self):
        """(seed, offset) for one kernel launch's Philox counters."""
        s = torch.randint(0, 2 ** 62, (2,), generator=self.host).tolist()
        return s[0], s[1] & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# two-sided truncated normal (the plain version behind B7)
# ---------------------------------------------------------------------------

def truncated_normal(lower, upper, mean=0.0, std=1.0, *, _u):
    """Truncated normal draw on [lower, upper], elementwise over the
    broadcast shape: the JAX op (``hmsc_tpu/ops/rand.py:25-81``) step by
    step.  Inverse CDF in the survival parameterisation for right-tail
    intervals (left ones are reflected into it), so one-sided truncations
    stay accurate into the tail in float32; the survival probability is
    clipped to [1e-30, 1 - 2^-24] before the inverse CDF; past 9 sigma the
    exponential tail (Robert 1995), truncated to the interval, replaces the
    quantile; the result is clipped to the interval.  ``_u`` are the
    uniforms (on [1e-38, 1)): the JAX op's injection hook, here the only
    source (B7's wrapper draws them)."""
    lower, upper, mean, std = (torch.as_tensor(v) for v in
                               (lower, upper, mean, std))
    shape = torch.broadcast_shapes(lower.shape, upper.shape, mean.shape,
                                   std.shape)
    a = (lower.expand(shape) - mean) / std
    b = (upper.expand(shape) - mean) / std
    u = torch.as_tensor(_u).expand(shape)

    right = (a + torch.clamp(b, -1e30, 1e30)) > 0
    right = torch.where(torch.isinf(b), a > 0, right)
    right = torch.where(torch.isinf(a), b > 0, right)
    a2 = torch.where(right, a, -b)
    b2 = torch.where(right, b, -a)

    sa, sb = _ndtr(-a2), _ndtr(-b2)                   # P(X > a2) >= P(X > b2)
    s = sb + u * (sa - sb)
    x_r = -torch.special.ndtri(torch.clamp(s, _P_FLOOR, _S_CEIL))
    span = torch.clamp(b2 - a2, min=0.0)
    lam_r = torch.clamp_min(a2, 1.0)
    x_far = a2 - torch.log1p(-u * (1.0 - torch.exp(-lam_r * span))) / lam_r
    x = torch.where(a2 > 9.0, x_far, x_r)
    x = torch.minimum(torch.maximum(x, a2), b2)       # clipped-quantile edges
    x = torch.where(right, x, -x)
    return mean + std * x


# ---------------------------------------------------------------------------
# B1: one-sided truncated normal (the probit Z draw)
# ---------------------------------------------------------------------------

def probit_z_geometry(ny: int, ns: int):
    """B1's launch geometry, ``(lg_tcg, grid)``: 256 threads a block, each
    owning 4 consecutive columns of 4 rows; a block spans ``2**lg_tcg``
    column groups (the smallest power of two from 4 to 32 that covers ns)
    and ``256 / 2**lg_tcg * 4`` rows; the grid is (column tiles, row
    tiles) per chain."""
    tcg = 4
    while tcg < 32 and 4 * tcg < ns:
        tcg *= 2
    rows = 256 // tcg * 4
    return tcg.bit_length() - 1, (-(-ns // (4 * tcg)), -(-ny // rows))


def _z_launch_checks(name, tensors):
    """Device, type and layout checks of B1's operands; whether every one
    allows 128-bit accesses."""
    dev = tensors[0][1].device
    aligned = True
    for label, t, dtype, contiguous in tensors:
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or (
                contiguous and not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be a "
                             f"{'contiguous ' if contiguous else ''}{dtype} "
                             f"tensor on {dev}")
        aligned = aligned and t.data_ptr() % 16 == 0
    return aligned


def _row_block_uniform(rng: Rng, C, ny, ns, dtype, row_off, ny_global):
    """Uniforms for the (C, ny, ns) cells of rows ``row_off`` on: on a site
    mesh (``ny_global`` given) drawn at the global width and sliced, so a
    rank's cells get the replicated run's draws."""
    if ny_global is None:
        return rng.uniform((C, ny, ns), dtype=dtype)
    return rng.uniform((C, ny_global, ns),
                       dtype=dtype)[:, row_off:row_off + ny].contiguous()


def truncated_normal_onesided(E, std, Y, rng: Rng | None = None, u=None,
                              row_off: int = 0, ny_global=None):
    """Z ~ N(E, std^2) truncated to Z > 0 where Y > 0.5 and Z < 0 elsewhere.

    ``E`` (C, ny, ns) linear predictors, ``std`` (C, ns) residual standard
    deviations per chain and species, ``Y`` (ny, ns) shared by the chains.
    This is the JAX op ``truncated_normal_onesided`` at bound 0, the only
    bound the sampler uses (B1's E-reading form).  ``u`` (C, ny, ns)
    injects the uniforms (the JAX op's ``_u`` hook); otherwise the kernel
    draws them from Philox keyed by ``rng.philox()``, and the plain version
    from ``rng.uniform``.  On a site mesh the rows are a rank's block of
    ``ny_global`` starting at ``row_off``: the kernel draws each cell from
    its global row's counter and the plain version slices a global-width
    draw, so each cell gets the replicated run's uniform.
    """
    C, ny, ns = E.shape
    if std.shape != (C, ns) or Y.shape != (ny, ns):
        raise ValueError(f"truncated_normal_onesided: E {tuple(E.shape)}, "
                         f"std {tuple(std.shape)}, Y {tuple(Y.shape)}")
    if u is not None and u.shape != E.shape:
        raise ValueError("truncated_normal_onesided: u must match E")
    if not E.is_cuda:
        if u is None:
            u = _row_block_uniform(rng, C, ny, ns, E.dtype, row_off,
                                   ny_global)
        return _truncated_normal_onesided_plain(E, std, Y, u)
    f32 = torch.float32
    Z = torch.empty_like(E)
    aligned = _z_launch_checks("truncated_normal_onesided", (
        ("E", E, f32, True), ("std", std, f32, True), ("Y", Y, f32, True),
        ("u", u, f32, True), ("Z", Z, f32, True)))
    if E.numel() == 0:
        return Z
    lg, _ = probit_z_geometry(ny, ns)
    seed, offset = (0, 0) if u is not None else rng.philox()
    with torch.cuda.device(E.device):
        code = K.library().hmsc_probit_z(
            E.data_ptr(), std.data_ptr(), Y.data_ptr(),
            None if u is None else u.data_ptr(), Z.data_ptr(), C, ny, ns, lg,
            int(aligned and ns % 4 == 0), int(row_off), seed, offset,
            K.stream_of(E))
    K.check(code, "probit_z")
    K.launches["probit_z"] += 1
    return Z


def probit_z_fused(X, Beta, std, Y, rng: Rng | None = None, u=None,
                   level=None, row_off: int = 0, ny_global=None):
    """B1's fused form: the probit Z draw of :func:`truncated_normal_onesided`
    at the linear predictor ``E = X Beta + Eta[:, pi] (Lambda * mask)``,
    formed inside the kernel, so E is never written.

    ``X`` (ny, nc), ``Beta`` (C, nc, ns), ``std`` (C, ns), ``Y`` (ny, ns);
    ``level`` is ``None`` (no random level) or ``(Eta (C, np, nf), pi (ny,)
    int64, Lambda (C, nf, ns), mask (C, nf))``, inactive factors masked by
    0.  ``nc + nf`` is at most 32.  The operands may be strided views.
    ``u`` (C, ny, ns) injects the uniforms.  The plain version forms E as
    ``updaters.total_loading`` does, then runs the plain truncated normal;
    the kernel draws the same uniforms from the same Philox counters as the
    E-reading form.  On a site mesh ``X``, ``Y`` and ``pi`` are a rank's
    block of rows (from ``row_off`` of ``ny_global``) and Eta the level's
    whole, gathered: the uniforms are drawn as
    :func:`truncated_normal_onesided` draws them there."""
    C, nc, ns = Beta.shape
    ny = X.shape[0]
    if X.shape != (ny, nc) or std.shape != (C, ns) or Y.shape != (ny, ns):
        raise ValueError(f"probit_z_fused: X {tuple(X.shape)}, Beta "
                         f"{tuple(Beta.shape)}, std {tuple(std.shape)}, Y "
                         f"{tuple(Y.shape)}")
    if level is not None:
        Eta, pi, Lam, mask = level
        nf = Eta.shape[2]
        if (Eta.shape[0] != C or pi.shape != (ny,)
                or Lam.shape != (C, nf, ns) or mask.shape != (C, nf)):
            raise ValueError("probit_z_fused: level shapes Eta "
                             f"{tuple(Eta.shape)}, pi {tuple(pi.shape)}, "
                             f"Lambda {tuple(Lam.shape)}, mask "
                             f"{tuple(mask.shape)}")
    else:
        nf = 0
    if nc + nf > 32 or nc + nf < 1:
        raise ValueError(f"probit_z_fused: nc + nf = {nc + nf} outside "
                         "[1, 32]")
    if u is not None and u.shape != (C, ny, ns):
        raise ValueError("probit_z_fused: u must be (C, ny, ns)")
    if not Beta.is_cuda:
        if u is None:
            u = _row_block_uniform(rng, C, ny, ns, Beta.dtype, row_off,
                                   ny_global)
        return _probit_z_fused_plain(X, Beta, std, Y, u, level)
    f32 = torch.float32
    Z = Beta.new_empty((C, ny, ns))
    lvl = level if level is not None else (None,) * 4
    aligned = _z_launch_checks("probit_z_fused", (
        ("Beta", Beta, f32, False), ("X", X, f32, False),
        ("Eta", lvl[0], f32, False), ("pi", lvl[1], torch.int64, True),
        ("Lambda", lvl[2], f32, False), ("mask", lvl[3], f32, False),
        ("std", std, f32, True), ("Y", Y, f32, True), ("u", u, f32, True),
        ("Z", Z, f32, True)))
    if Z.numel() == 0:
        return Z
    strides = list(X.stride()) + list(Beta.stride()) + (
        [*lvl[0].stride(), *lvl[2].stride(), *lvl[3].stride()]
        if level is not None else [0] * 8)
    lg, _ = probit_z_geometry(ny, ns)
    seed, offset = (0, 0) if u is not None else rng.philox()
    eta_p, pi_p, lam_p, mask_p, u_p = (
        None if t is None else t.data_ptr() for t in (*lvl, u))
    with torch.cuda.device(Z.device):
        code = K.library().hmsc_probit_z_fused(
            X.data_ptr(), Beta.data_ptr(), eta_p, pi_p, lam_p, mask_p,
            std.data_ptr(), Y.data_ptr(), u_p, Z.data_ptr(),
            (ctypes.c_longlong * 13)(*strides), C, ny, ns, nc, nf, lg,
            int(aligned and ns % 4 == 0), int(row_off), seed, offset,
            K.stream_of(Z))
    K.check(code, "probit_z_fused")
    K.launches["probit_z_fused"] += 1
    return Z


def _probit_z_fused_plain(X, Beta, std, Y, u, level):
    """The linear predictor as ``updaters.total_loading`` forms it, then
    the plain truncated normal."""
    E = X @ Beta
    if level is not None:
        Eta, pi, Lam, mask = level
        E = E + Eta[:, pi] @ (Lam * mask[:, :, None])
    return _truncated_normal_onesided_plain(E, std, Y, u)


def _truncated_normal_onesided_plain(E, std, Y, u):
    """The JAX op (``hmsc_tpu/ops/rand.py:84-121``) step by step."""
    is_lower = Y > 0.5
    sd = std[:, None, :]
    t = (0.0 - E) / sd
    t = torch.where(is_lower, t, -t)
    sa = _ndtr(-t)                                    # P(W > t)
    s = u * sa
    x_r = -torch.special.ndtri(torch.clamp(s, _P_FLOOR, _S_CEIL))
    lam = torch.clamp_min(t, 1.0)
    x_far = t - torch.log1p(-u) / lam                 # Robert (1995) tail
    x = torch.where(t > 9.0, x_far, x_r)
    x = torch.maximum(x, t)                           # clipped-quantile edge
    x = torch.where(is_lower, x, -x)
    return E + sd * x


def _ndtr(x):
    """Phi(x) as ``jax.scipy.special.ndtr`` computes it: erfc in the tails,
    so the lower tail keeps its relative accuracy in float32
    (``torch.special.ndtr`` loses it below about -5).  The kernels'
    ``upper_prob`` (``csrc/truncnorm.cuh``) keeps it too."""
    half_sqrt_2 = 0.5 * math.sqrt(2.0)
    w = x * half_sqrt_2
    z = w.abs()
    y = torch.where(z < half_sqrt_2, 1.0 + torch.erf(w),
                    torch.where(w > 0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


# ---------------------------------------------------------------------------
# B3: standard gamma
# ---------------------------------------------------------------------------

def standard_gamma(a, rng: Rng):
    """Gamma(a, 1) draws, elementwise over ``a`` (float32, any shape)."""
    if not a.is_cuda:
        return _standard_gamma_plain(a, rng)
    if a.dtype != torch.float32:
        raise ValueError("standard_gamma: a must be float32")
    a = a.contiguous()
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    seed, offset = rng.philox()
    with torch.cuda.device(a.device):
        code = K.library().hmsc_standard_gamma(
            a.data_ptr(), out.data_ptr(), a.numel(), seed, offset,
            K.stream_of(a))
    K.check(code, "standard_gamma")
    K.launches["standard_gamma"] += 1
    return out


def _standard_gamma_plain(a, rng: Rng):
    """The JAX op (``hmsc_tpu/ops/rand.py:124-169``): Marsaglia-Tsang with
    ``_GAMMA_ROUNDS`` candidate batches drawn up front, the first accepted
    candidate selected per element, the mode where none accepts, and the
    U^(1/a) boost for a < 1."""
    boost = a < 1.0
    a_eff = torch.where(boost, a + 1.0, torch.maximum(a, torch.ones_like(a)))
    d = a_eff - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    cand = (_GAMMA_ROUNDS,) + tuple(a.shape)
    x = rng.normal(cand, dtype=a.dtype)
    v = (1.0 + c[None] * x) ** 3
    u = rng.uniform(cand, dtype=a.dtype)
    vsafe = torch.where(v > 0, v, torch.ones_like(v))
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x
                    + d[None] * (1.0 - v + torch.log(vsafe)))
    idx = torch.argmax(ok.to(torch.uint8), dim=0)      # first accepting round
    vsel = torch.gather(vsafe, 0, idx[None])[0]
    draw = d * torch.where(ok.any(dim=0), vsel, torch.ones_like(vsel))
    ub = rng.uniform(a.shape, dtype=a.dtype)
    pow_ = ub ** (1.0 / torch.where(boost, a, torch.ones_like(a)))
    return torch.where(boost, draw * pow_, draw)


# ---------------------------------------------------------------------------
# B3, shrinkage form: a level's multiplicative-gamma shrinkage update
# ---------------------------------------------------------------------------

def shrinkage_geometry(nf: int, ns: int, ncr: int,
                       max_cluster: int = 16) -> dict:
    """The shrinkage form's launch shape (``csrc/shrinkage_gamma.cu``): a
    cluster of ``S`` <= ``max_cluster`` <= 16 blocks of ``T`` <= 512
    threads a chain (above 8 blocks, a cluster size the H100 allows but
    does not promise: :func:`shrinkage_launch` asks the card), so a lane
    draws about one psi, with a warp for each of the chain's ``nf ncr``
    rows of ``ns`` species at least; each row is cut into ``P`` pieces of
    ``plen`` species, one warp's item each.  ``P`` and ``plen`` are those
    of 16 blocks whatever ``S``: a piece's sum does not depend on which
    warp takes it, so every cluster size gives the same bits."""
    W, R = nf * ns * ncr, nf * ncr

    def threads(S):
        return min(512, 32 * max(-(-W // (32 * S)), -(-R // S)))

    S16 = max(1, min(16, -(-W // 512)))
    P = max(1, (S16 * threads(S16) // 32) // R)
    plen = -(-ns // P)
    S = min(S16, max(1, max_cluster))
    return {"S": S, "T": threads(S), "P": -(-ns // plen), "plen": plen}


def shrinkage_smem(nf: int, ncr: int, P: int) -> int:
    """The shrinkage form's dynamic shared memory, bytes: the mask, five
    rows' worth a (factor, column) and block 0's piece sums."""
    return 4 * (nf + nf * ncr * (P + 5))


def shrinkage_choose(nf: int, ns: int, ncr: int, schedulable) -> dict:
    """The geometry of the largest cluster, from 16 blocks down, that
    ``schedulable(S, T, smem)`` accepts (one block always is)."""
    cap = 16
    while True:
        geo = shrinkage_geometry(nf, ns, ncr, cap)
        if geo["S"] == 1 or schedulable(
                geo["S"], geo["T"], shrinkage_smem(nf, ncr, geo["P"])):
            return geo
        cap = geo["S"] - 1


_SHRINKAGE_LAUNCH = {}


def shrinkage_launch(device, nf: int, ns: int, ncr: int) -> dict:
    """:func:`shrinkage_choose` on the card: a cluster size is taken only
    where ``cudaOccupancyMaxActiveClusters`` reports such a cluster of the
    kernel, at its block size and shared memory, as schedulable; the
    answer is kept per device and shape."""
    dev = torch.device(device)
    key = (dev.index, nf, ns, ncr)
    if key not in _SHRINKAGE_LAUNCH:
        lib = K.library()

        def schedulable(S, T, smem):
            count = ctypes.c_int(0)
            with torch.cuda.device(dev):
                code = lib.hmsc_shrinkage_clusters(S, T, smem,
                                                   ctypes.byref(count))
            K.check(code, "shrinkage_gamma (cluster query)")
            return count.value > 0

        _SHRINKAGE_LAUNCH[key] = shrinkage_choose(nf, ns, ncr, schedulable)
    return _SHRINKAGE_LAUNCH[key]


def delta_offset(offset: int) -> int:
    """The Philox offset of the shrinkage form's delta draws, from its psi
    draws' (``offset``): the next one."""
    return (offset + 1) & 0xFFFFFFFF


def shrinkage_shapes(mask, nu, a1, a2, ns: int):
    """The unit gamma shapes of one level's shrinkage update: psi's
    ``nu/2 + 1/2`` (ncr,) and delta's (C, nf, ncr), ``a1 + ns nf_act / 2``
    for the first factor and ``a2 + ns n_geq(h) / 2`` after it (``n_geq(h)``:
    active factors from h on).  They depend on the mask alone."""
    nf_act = mask.sum(dim=1)                             # (C,)
    n_geq = torch.flip(torch.cumsum(torch.flip(mask, [1]), dim=1), [1])
    ad = torch.cat([(a1 + 0.5 * ns * nf_act[:, None])[:, None],
                    a2 + 0.5 * ns * n_geq[:, 1:, None]], dim=1)
    return nu / 2 + 0.5, ad


def shrinkage_update(Lambda, mask, Delta, nu, b1, b2, g_psi, delta_gamma):
    """One level's shrinkage update from its unit gamma draws, the JAX
    ``update_lambda_priors`` step by step: psi elementwise, then delta
    sequentially over the factors with tau recomputed each step; inactive
    slots stay at 1.  ``g_psi`` (C, nf, ns, ncr); ``delta_gamma(h)`` gives
    factor h's (C, ncr) draws at :func:`shrinkage_shapes`' shapes.  Returns
    (Psi, Delta)."""
    lam2 = (Lambda * mask[:, :, None, None]) ** 2
    delta = torch.where(mask[:, :, None] > 0, Delta, 1.0)
    tau = torch.cumprod(delta, dim=1)                    # (C, nf, ncr)
    psi = g_psi / (nu / 2 + 0.5 * lam2 * tau[:, :, None, :])
    Msum = (psi * lam2).sum(dim=2)                       # (C, nf, ncr)
    for h in range(Lambda.shape[1]):
        tau = torch.cumprod(delta, dim=1)
        tail = (tau[:, h:] * Msum[:, h:] * mask[:, h:, None]).sum(dim=1)
        bd = (b1 if h == 0 else b2) + 0.5 * tail / delta[:, h]
        draw = delta_gamma(h) / bd
        delta = delta.clone()
        delta[:, h] = torch.where(mask[:, h, None] > 0, draw, 1.0)
    return psi, delta


def shrinkage_gamma(Lambda, mask, Delta, nu, a1, b1, a2, b2, rng: Rng):
    """One level's multiplicative-gamma shrinkage update, its draws
    included, in one launch: (Psi (C, nf, ns, ncr), Delta (C, nf, ncr)).
    ``Lambda`` (C, nf, ns, ncr), ``mask`` (C, nf), ``Delta`` (C, nf, ncr),
    the hyperparameters (ncr,).  psi's unit draws use the Philox counters
    :func:`standard_gamma` gives a (C, nf, ns, ncr) array at the launch's
    (seed, offset), delta's those it gives the (C, nf, ncr) array of
    :func:`shrinkage_shapes` at (seed, :func:`delta_offset`).  The cluster
    size is :func:`shrinkage_launch`'s; the result does not depend on it."""
    if not Lambda.is_cuda:
        return _shrinkage_gamma_plain(Lambda, mask, Delta, nu, a1, b1, a2,
                                      b2, rng)
    C, nf, ns, ncr = Lambda.shape
    args = [Lambda, mask, Delta, nu, a1, b1, a2, b2]
    for n, (label, shape) in enumerate((
            ("Lambda", (C, nf, ns, ncr)), ("mask", (C, nf)),
            ("Delta", (C, nf, ncr)), ("nu", (ncr,)), ("a1", (ncr,)),
            ("b1", (ncr,)), ("a2", (ncr,)), ("b2", (ncr,)))):
        t = args[n]
        if (t.device != Lambda.device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"shrinkage_gamma: {label} must be a float32 "
                             f"{shape} tensor on {Lambda.device}")
        args[n] = t.contiguous()
    Lambda, mask, Delta, nu, a1, b1, a2, b2 = args
    geo = shrinkage_launch(Lambda.device, nf, ns, ncr)
    Psi = torch.empty_like(Lambda)
    Delta_out = torch.empty_like(Delta)
    seed, offset = rng.philox()
    with torch.cuda.device(Lambda.device):
        code = K.library().hmsc_shrinkage_gamma(
            Lambda.data_ptr(), mask.data_ptr(), Delta.data_ptr(),
            nu.data_ptr(), a1.data_ptr(), b1.data_ptr(), a2.data_ptr(),
            b2.data_ptr(), Psi.data_ptr(), Delta_out.data_ptr(), C, nf, ns,
            ncr, geo["S"], geo["T"], geo["P"], geo["plen"], seed, offset,
            delta_offset(offset), K.stream_of(Lambda))
    K.check(code, "shrinkage_gamma")
    K.launches["shrinkage_gamma"] += 1
    return Psi, Delta_out


def _shrinkage_gamma_plain(Lambda, mask, Delta, nu, a1, b1, a2, b2,
                           rng: Rng):
    """:func:`shrinkage_update` on the plain gamma draws of
    :func:`_standard_gamma_plain`, delta's drawn up front."""
    a_psi, ad = shrinkage_shapes(mask, nu, a1, a2, Lambda.shape[2])
    g_psi = _standard_gamma_plain(a_psi.expand(Lambda.shape).contiguous(),
                                  rng)
    g_delta = _standard_gamma_plain(ad, rng)
    return shrinkage_update(Lambda, mask, Delta, nu, b1, b2, g_psi,
                            lambda h: g_delta[:, h])


# ---------------------------------------------------------------------------
# B5: the Polya-Gamma Poisson Z draw
# ---------------------------------------------------------------------------

# Taylor coefficients in u^2 of (tanh u - u sech^2 u) / (16 u^3), the PG
# variance per unit h, and the |z|/2 below which they replace the closed
# form; csrc/poisson_z.cu carries the same numbers
_PG_VAR_SERIES = (1 / 24, -1 / 30, 17 / 840, -31 / 2835, 691 / 124740,
                  -5461 / 2027025, 929569 / 729729000)
_PG_VAR_SERIES_MAX = 0.5


def _pg_moments(h, z):
    """Mean and variance of PG(h, z) from its cumulant generating function
    (JAX package ``rand.py:172-182``).  The mean is the JAX op's, series
    branch for |z|/2 < 1e-3 included.  The variance's closed form
    subtracts two nearly equal numbers for small u = |z|/2 (relative error
    ~1.5e-7 / u^2 in float32, 10% at u = 1e-3 where the JAX op leaves its
    series), so below u = 0.5 it is the Taylor series instead (error below
    1e-7 there)."""
    u = 0.5 * z.abs()
    small = u < 1e-3
    us = torch.where(small, 1.0, u)                   # safe denominator
    t = torch.tanh(us)
    sech2 = 1.0 - t * t
    mean = torch.where(small, h / 4.0 * (1.0 - u * u / 3.0),
                       h * t / (4.0 * us))
    x = u * u
    series = torch.full_like(x, _PG_VAR_SERIES[-1])
    for coef in reversed(_PG_VAR_SERIES[:-1]):
        series = series * x + coef
    var = torch.where(u < _PG_VAR_SERIES_MAX, h * series,
                      h * (t - us * sech2) / (16.0 * (us * us * us)))
    return mean, var


def polya_gamma(h, z, eps):
    """PG(h, z) for h >= 1000 as its moment-matched normal floored at
    1e-38, given standard normals ``eps`` (the JAX op ``polya_gamma`` on its
    default ``n_terms=0`` path, ``rand.py:185-214``)."""
    mean, var = _pg_moments(h, z)
    return torch.clamp_min(mean + torch.sqrt(var) * eps, _TINY)


def poisson_z(Y, Zprev, E, iSigma, fam, rng: Rng | None = None,
              eps_pg=None, eps_z=None):
    """The (lognormal-)Poisson latent draw of ``update_z`` (JAX package
    ``updaters.py:175-197``): in the columns with ``fam == 3``, w ~ PG(Y +
    r, Zprev - log r) with r = 1000, then Z ~ N(s2 ((Y - r)/2 + iSigma (E -
    log r)) + log r, s2) with s2 = 1/(iSigma + w), keeping Zprev where the
    draw is not finite; ``Zprev`` in the other columns.

    ``Y`` (ny, ns), ``Zprev`` and ``E`` (C, ny, ns), ``iSigma`` (C, ns),
    ``fam`` (ns,) int32.  ``eps_pg`` and ``eps_z`` (C, ny, ns) inject the
    two standard normals per cell (both or neither); otherwise the kernel
    draws them from Philox keyed by ``rng.philox()``, and the plain
    version from ``rng.normal``."""
    C, ny, ns = Zprev.shape
    if (E.shape != Zprev.shape or iSigma.shape != (C, ns)
            or Y.shape != (ny, ns) or fam.shape != (ns,)):
        raise ValueError(f"poisson_z: Y {tuple(Y.shape)}, Zprev "
                         f"{tuple(Zprev.shape)}, E {tuple(E.shape)}, iSigma "
                         f"{tuple(iSigma.shape)}, fam {tuple(fam.shape)}")
    if (eps_pg is None) != (eps_z is None):
        raise ValueError("poisson_z: inject both eps_pg and eps_z or neither")
    if eps_pg is not None and (eps_pg.shape != Zprev.shape
                               or eps_z.shape != Zprev.shape):
        raise ValueError("poisson_z: eps_pg and eps_z must match Zprev")
    if not Zprev.is_cuda:
        if eps_pg is None:
            eps_pg = rng.normal(Zprev.shape, Zprev.dtype)
            eps_z = rng.normal(Zprev.shape, Zprev.dtype)
        return _poisson_z_plain(Y, Zprev, E, iSigma, fam, eps_pg, eps_z)
    # the mixed form's kernel, every other column's family 0 (kept)
    kept = torch.where(fam == 3, fam, torch.zeros_like(fam))
    return z_mixed(Y, Zprev, E, iSigma, kept,
                   rng=rng if eps_pg is None else None, eps_pg=eps_pg,
                   eps_z=eps_z)


def _ptr(t):
    return None if t is None else t.data_ptr()


# B5 gives a thread 4 rows of 4 columns from this many cells of a launch,
# 1 row of 2 below it
_B5_LARGE_CELLS = 1 << 21


def z_geometry(C: int, ny: int, ns: int):
    """B5's launch shape, ``(lg_tcg, small)``: on large blocks B1's layout
    (:func:`probit_z_geometry`: column groups of 4, 4 rows a thread); on
    small ones (``small`` 1) a thread 1 row of 2 columns, where more
    threads shorten the launch, column groups of 2 covering ns as B1's
    cover it with groups of 4."""
    small = C * ny * ns < _B5_LARGE_CELLS
    lg, _ = probit_z_geometry(ny, 2 * ns if small else ns)
    return lg, int(small)


def _b5_operands(Y, Zprev, E, iSigma, fam, Z, **noise):
    """B5's operands for :func:`_z_launch_checks`: every float contiguous
    float32, ``fam`` contiguous int32, on Zprev's device."""
    f32 = torch.float32
    return ((("Zprev", Zprev, f32, True), ("Y", Y, f32, True),
             ("E", E, f32, True), ("iSigma", iSigma, f32, True),
             ("fam", fam, torch.int32, True), ("Z", Z, f32, True))
            + tuple((k, v, f32, True) for k, v in noise.items()))


def _poisson_z_plain(Y, Zprev, E, iSigma, fam, eps_pg, eps_z):
    """The JAX op and update_z branch step by step."""
    w = polya_gamma(Y + _NB_R, Zprev - _LOG_NB_R, eps_pg)
    prec = iSigma[:, None, :]
    s2 = 1.0 / (prec + w)
    mu = s2 * ((Y - _NB_R) / 2.0 + prec * (E - _LOG_NB_R)) + _LOG_NB_R
    z = mu + torch.sqrt(s2) * eps_z
    z = torch.where(torch.isfinite(z), z, Zprev)      # reference NaN guard
    return torch.where(fam == 3, z, Zprev)


def z_mixed(Y, Zprev, E, iSigma, fam, Ymask=None, rng: Rng | None = None,
            u=None, eps_pg=None, eps_z=None, eps_na=None):
    """B5's mixed form: the whole Z update of ``update_z`` (JAX package
    ``updaters.py:135-205``) in one launch: normal columns copy Y, probit
    columns draw B1's one-sided truncated normal at sd = iSigma^-1/2,
    Poisson columns the draw of :func:`poisson_z` at Zprev; then, where
    ``Ymask`` is 0, E + sd eps.

    ``Y`` (ny, ns), ``Zprev`` and ``E`` (C, ny, ns), ``iSigma`` (C, ns),
    ``fam`` (ns,) int32, ``Ymask`` (ny, ns) or None without missing
    values.  ``u``, ``eps_pg`` with ``eps_z``, and ``eps_na`` (each (C, ny,
    ns)) inject the draws of their branch (``update_z``'s ``noise``);
    otherwise the kernel draws them from Philox keyed by ``rng.philox()``
    (the Poisson cells at :func:`poisson_z`'s counters), and the plain
    version, on the CPU, from ``rng`` in ``update_z``'s order (the probit
    uniforms, the two Poisson normals, the imputation normals, each where
    a column of its family or a missing cell exists).  Without ``rng``
    every draw the model's families need must be injected."""
    C, ny, ns = Zprev.shape
    if (E.shape != Zprev.shape or iSigma.shape != (C, ns)
            or Y.shape != (ny, ns) or fam.shape != (ns,)
            or (Ymask is not None and Ymask.shape != (ny, ns))):
        raise ValueError(f"z_mixed: Y {tuple(Y.shape)}, Zprev "
                         f"{tuple(Zprev.shape)}, E {tuple(E.shape)}, iSigma "
                         f"{tuple(iSigma.shape)}, fam {tuple(fam.shape)}")
    if (eps_pg is None) != (eps_z is None):
        raise ValueError("z_mixed: inject both eps_pg and eps_z or neither")
    for name, t in (("u", u), ("eps_pg", eps_pg), ("eps_z", eps_z),
                    ("eps_na", eps_na)):
        if t is not None and t.shape != Zprev.shape:
            raise ValueError(f"z_mixed: {name} must match Zprev")
    if not Zprev.is_cuda:
        if u is None and bool((fam == 2).any()):
            u = rng.uniform(E.shape, dtype=E.dtype)
        if eps_pg is None and bool((fam == 3).any()):
            eps_pg = rng.normal(Zprev.shape, Zprev.dtype)
            eps_z = rng.normal(Zprev.shape, Zprev.dtype)
        if eps_na is None and Ymask is not None:
            eps_na = rng.normal(E.shape, E.dtype)
        return _z_mixed_plain(Y, Zprev, E, iSigma, fam, Ymask, u, eps_pg,
                              eps_z, eps_na)
    Z = torch.empty_like(Zprev)
    aligned = _z_launch_checks("z_mixed", _b5_operands(
        Y, Zprev, E, iSigma, fam, Z, Ymask=Ymask, u=u, eps_pg=eps_pg,
        eps_z=eps_z, eps_na=eps_na))
    if Zprev.numel() == 0:
        return Z
    lg, small = z_geometry(C, ny, ns)
    seed, offset = rng.philox() if rng is not None else (0, 0)
    with torch.cuda.device(Zprev.device):
        code = K.library().hmsc_z_mixed(
            Y.data_ptr(), Zprev.data_ptr(), E.data_ptr(), iSigma.data_ptr(),
            fam.data_ptr(), _ptr(Ymask), _ptr(u), _ptr(eps_pg), _ptr(eps_z),
            _ptr(eps_na), Z.data_ptr(), C, ny, ns, lg, small,
            int(aligned and ns % 4 == 0), seed, offset, K.stream_of(Zprev))
    K.check(code, "poisson_z")
    K.launches["poisson_z"] += 1
    return Z


def _z_mixed_plain(Y, Zprev, E, iSigma, fam, Ymask, u, eps_pg, eps_z,
                   eps_na):
    """``update_z``'s body (JAX package ``updaters.py:159-204``) step by
    step on the plain versions: each branch where its draws are given."""
    Z = Zprev
    std = iSigma ** -0.5
    Z = torch.where(fam == 1, Y, Z)
    if u is not None:
        z_tn = _truncated_normal_onesided_plain(E, std, Y, u)
        Z = torch.where(fam == 2, z_tn, Z)
    if eps_pg is not None:
        z_p = _poisson_z_plain(Y, Zprev, E, iSigma, fam, eps_pg, eps_z)
        Z = torch.where(fam == 3, z_p, Z)
    if Ymask is not None:
        Z = torch.where(Ymask > 0, Z, E + std[:, None, :] * eps_na)
    return Z


# ---------------------------------------------------------------------------
# B7: the probit-DA intercept draw
# ---------------------------------------------------------------------------

def da_intercept_draw(Z, Y, Ymask, fam, Beta, ii: int, u_prior, v00,
                      rng: Rng | None = None, u=None):
    """The draw of ``interweave_da_intercept`` (JAX package
    ``updaters.py:906-937``): per chain and probit species, with ``b0 =
    Beta[ii]`` and the residual ``R = Z - b0`` held fixed, a new intercept
    ``t`` from the prior conditional ``N(b0 - u_prior / v00, 1 / v00)``
    truncated to ``(max_{Y=1} -R, min_{Y=0} -R)`` over the observed rows,
    and ``Z = R + t``; non-probit columns keep ``b0`` and ``Z``.

    ``Z`` (C, ny, ns), ``Y`` (ny, ns), ``Ymask`` (ny, ns) or None when no
    cell is missing, ``fam`` (ns,) int32, ``Beta`` (C, nc, ns), ``u_prior``
    (C, ns) = ``iV[ii] (Beta - Mu)``, ``v00`` (C,) = ``iV[ii, ii]``.
    ``u`` (C, ns) injects the uniforms (the JAX op's ``_u``); otherwise the
    kernel draws them from Philox keyed by ``rng.philox()``, and the plain
    version from ``rng.uniform``.  Returns ``(t (C, ns), Z (C, ny, ns))``."""
    C, ny, ns = Z.shape
    nc = Beta.shape[1]
    if (Y.shape != (ny, ns) or fam.shape != (ns,) or Beta.shape != (C, nc, ns)
            or u_prior.shape != (C, ns) or v00.shape != (C,)
            or (Ymask is not None and Ymask.shape != (ny, ns))
            or (u is not None and u.shape != (C, ns))
            or not 0 <= ii < nc):
        raise ValueError(f"da_intercept_draw: Z {tuple(Z.shape)}, Y "
                         f"{tuple(Y.shape)}, fam {tuple(fam.shape)}, Beta "
                         f"{tuple(Beta.shape)}, ii {ii}")
    if not Z.is_cuda:
        if u is None:
            u = rng.uniform((C, ns), Z.dtype)
        return _da_intercept_draw_plain(Z, Y, Ymask, fam, Beta, ii, u_prior,
                                        v00, u)
    floats = (("Z", Z), ("Y", Y), ("Beta", Beta), ("u_prior", u_prior),
              ("v00", v00)) + ((("Ymask", Ymask),) if Ymask is not None
                               else ()) + ((("u", u),) if u is not None
                                           else ())
    for name, t in floats:
        if t.device != Z.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"da_intercept_draw: {name} must be a "
                             "contiguous float32 tensor on Z's device")
    if fam.device != Z.device or fam.dtype != torch.int32 \
            or not fam.is_contiguous():
        raise ValueError("da_intercept_draw: fam must be a contiguous int32 "
                         "tensor on Z's device")
    t_out = Z.new_empty((C, ns))
    Z_out = torch.empty_like(Z)
    if Z.numel() == 0:
        return t_out, Z_out
    seed, offset = (0, 0) if u is not None else rng.philox()
    with torch.cuda.device(Z.device):
        code = K.library().hmsc_truncnorm_da(
            Z.data_ptr(), Y.data_ptr(),
            None if Ymask is None else Ymask.data_ptr(), fam.data_ptr(),
            Beta.data_ptr(), u_prior.data_ptr(), v00.data_ptr(),
            None if u is None else u.data_ptr(), t_out.data_ptr(),
            Z_out.data_ptr(), C, ny, ns, nc, ii, seed, offset,
            K.stream_of(Z))
    K.check(code, "truncnorm_da")
    K.launches["truncnorm_da"] += 1
    return t_out, Z_out


def _da_intercept_draw_plain(Z, Y, Ymask, fam, Beta, ii, u_prior, v00, u):
    """The JAX updater's draw step by step, chains on the leading axis."""
    prob = fam == 2
    b0 = Beta[:, ii]                                  # (C, ns)
    R = Z - b0[:, None, :]
    negR = -R
    if Ymask is not None:
        one = (Y > 0.5) & (Ymask > 0)
        zero = (Y <= 0.5) & (Ymask > 0)
    else:
        one = Y > 0.5
        zero = ~one
    inf = torch.tensor(float("inf"), dtype=R.dtype, device=R.device)
    lo = torch.where(one, negR, -inf).amax(dim=1)     # (C, ns)
    hi = torch.where(zero, negR, inf).amin(dim=1)
    v = v00[:, None]
    t = truncated_normal(lo, hi, mean=b0 - u_prior / v, std=v ** -0.5,
                         _u=u)
    t = torch.where(prob, t, b0)
    return t, torch.where(prob, R + t[:, None, :], Z)


def wishart(df, scale_factor, rng: Rng | None = None, noise=None):
    """W ~ Wishart(df, S) per chain via the Bartlett decomposition, where
    ``scale_factor`` (C, p, p) is any T with T T' = S (JAX package
    ``rand.py:217-229``).  Plain PyTorch on B3.  ``noise`` injects the
    ``normal`` (C, p, p) and unit ``gamma`` (C, p) draws."""
    C, p = scale_factor.shape[0], scale_factor.shape[-1]
    dtype = scale_factor.dtype
    # chi^2_{df-i} = 2 * Gamma((df-i)/2)
    dfs = (df - torch.arange(p, dtype=dtype, device=scale_factor.device)) / 2.0
    g = (noise["gamma"] if noise is not None
         else standard_gamma(dfs.expand(C, p).contiguous(), rng))
    z = noise["normal"] if noise is not None else rng.normal((C, p, p), dtype)
    A = torch.tril(z, -1) + torch.diag_embed(torch.sqrt(2.0 * g))
    TA = scale_factor @ A
    return TA @ TA.transpose(-1, -2)


# ---------------------------------------------------------------------------
# B4: the GammaV block
# ---------------------------------------------------------------------------

# the largest nc and nc nt that csrc/gamma_v.cu takes (its warps' entries,
# and its second factorisation a thread a row on at most two warps)
GAMMA_V_MAX_NC, GAMMA_V_MAX_N = 16, 64


def gamma_v_route(nc: int, nt: int) -> bool:
    """Whether the GammaV block of a model with ``nc`` covariates and ``nt``
    traits runs as kernel B4 on the card: nc <= 16 and nc nt <= 64.  Larger
    models take :func:`gamma_v_plain` on the card too (a route chosen by
    size, as B2's P > 16; not a fallback on failure)."""
    return nc <= GAMMA_V_MAX_NC and nc * nt <= GAMMA_V_MAX_N


def gamma_v_plain(Beta, Gamma, Tr, V0, TtT, iUGamma, iUGmG, df,
                  rng: Rng | None = None, noise=None, Tr16=None):
    """The GammaV block as torch ops (JAX package ``update_gamma_v``,
    ``updaters.py:462-511``, no phylogeny, no tenants): iV ~ Wishart(df,
    (E E' + V0)^{-1}) with E = Beta - Gamma Tr', by :func:`wishart` on
    B3's element form, then Gamma | Beta, iV (``updaters.py:444-459``).
    ``noise`` and ``Tr16`` (the bf16 form: ``E E'`` and ``(iV Beta) Tr``
    as B10 products) as for :func:`gamma_v`.  Returns (iV, Gamma)."""
    noise = noise or {}
    E = Beta - Gamma @ Tr.T
    A = (E @ E.transpose(1, 2) if Tr16 is None
         else mixed_gemm(E, E.transpose(1, 2)))
    Lw = chol_spd(A + V0)
    eye = torch.eye(V0.shape[-1], dtype=A.dtype, device=A.device)
    T = torch.linalg.solve_triangular(Lw.transpose(1, 2), eye.expand_as(Lw),
                                      upper=True)        # T T' = (A+V0)^-1
    iV = wishart(df, T, rng, noise.get("wishart"))
    # Gamma | Beta, iV: precision iUGamma + kron(Tr'Tr, iV), right-hand
    # side iUGamma mGamma + vec((iV Beta Tr)')
    C, nc, nt = iV.shape[0], iV.shape[-1], TtT.shape[0]
    kron = (TtT[None, :, None, :, None] * iV[:, None, :, None, :]
            ).reshape(C, nt * nc, nt * nc)
    if Tr16 is None:
        t2 = (iV @ Beta) @ Tr                            # (C, nc, nt)
    else:
        t2 = mixed_gemm(mixed_gemm(iV, Beta), Tr16)
    rhs = iUGmG + t2.transpose(1, 2).reshape(C, -1)
    eps = (noise["gamma"]["eps"] if "gamma" in noise
           else rng.normal(rhs.shape, rhs.dtype))
    gvec = sample_mvn_prec(chol_spd(iUGamma + kron), rhs, eps)
    return iV, gvec.reshape(C, nt, nc).transpose(1, 2)


def gamma_v(Beta, Gamma, Tr, V0, TtT, iUGamma, iUGmG, df,
            rng: Rng | None = None, noise=None, Tr16=None):
    """One GammaV update for C chains, its draws included: (iV (C, nc, nc),
    Gamma (C, nc, nt)).  ``Beta`` (C, nc, ns), ``Gamma`` (C, nc, nt),
    ``Tr`` (ns, nt), ``V0`` (nc, nc), ``TtT = Tr'Tr`` (nt, nt),
    ``iUGamma`` (n, n) and ``iUGmG = iUGamma mGamma`` (n,), n = nc nt;
    ``df = f0 + ns``.  ``noise`` injects any of ``{"wishart": {"normal":
    (C, nc, nc), "gamma": (C, nc)}, "gamma": {"eps": (C, n)}}``; the
    kernel draws the rest from Philox keyed by ``rng.philox()``: the unit
    gammas at the counters :func:`standard_gamma` gives a (C, nc) array at
    (seed, offset), the normals at offset + 1, eps at offset + 2.  On the
    card, where :func:`gamma_v_route` holds, kernel B4; else, and on the
    CPU, :func:`gamma_v_plain`.  ``Tr16``, the bfloat16 shadow of ``Tr``,
    selects the bf16 form (the block under a precision policy): ``E E'``,
    ``iV Beta`` and ``(iV Beta) Tr`` with bf16 operands and float32
    accumulation, rounded where the JAX package's mx calls round, and
    ``TtT`` the caller's ``Tr'Tr`` of the rounded ``Tr``."""
    C, nc, ns = Beta.shape
    nt = Tr.shape[-1]
    if not Beta.is_cuda or not gamma_v_route(nc, nt):
        return gamma_v_plain(Beta, Gamma, Tr, V0, TtT, iUGamma, iUGmG, df,
                             rng, noise, Tr16)
    n = nc * nt
    noise = noise or {}
    nw = noise.get("wishart") or {}
    draws = {"normal": nw.get("normal"), "gamma": nw.get("gamma"),
             "eps": (noise.get("gamma") or {}).get("eps")}
    args = {"Beta": Beta, "Gamma": Gamma, "Tr": Tr, "V0": V0, "TtT": TtT,
            "iUGamma": iUGamma, "iUGmG": iUGmG, **draws}
    shapes = {"Beta": (C, nc, ns), "Gamma": (C, nc, nt), "Tr": (ns, nt),
              "V0": (nc, nc), "TtT": (nt, nt), "iUGamma": (n, n),
              "iUGmG": (n,), "normal": (C, nc, nc), "gamma": (C, nc),
              "eps": (C, n)}
    for name, t in args.items():
        if t is None:
            continue
        if (tuple(t.shape) != shapes[name] or t.device != Beta.device
                or t.dtype != torch.float32):
            raise ValueError(f"gamma_v: {name} must be a float32 "
                             f"{shapes[name]} tensor on {Beta.device}")
        args[name] = t.contiguous()
    if Tr16 is not None:
        if (tuple(Tr16.shape) != (ns, nt) or Tr16.device != Beta.device
                or Tr16.dtype != torch.bfloat16):
            raise ValueError(f"gamma_v: Tr16 must be a bfloat16 {(ns, nt)} "
                             f"tensor on {Beta.device}")
        Tr16 = Tr16.contiguous()
    iV = Beta.new_empty((C, nc, nc))
    G_out = Beta.new_empty((C, nc, nt))
    if C == 0:
        return iV, G_out
    seed, offset = ((0, 0) if all(v is not None for v in draws.values())
                    else rng.philox())
    ptr = lambda name: None if args[name] is None else args[name].data_ptr()
    with torch.cuda.device(Beta.device):
        code = K.library().hmsc_gamma_v(
            ptr("Beta"), ptr("Gamma"), ptr("Tr"),
            None if Tr16 is None else Tr16.data_ptr(), ptr("V0"), ptr("TtT"),
            ptr("iUGamma"), ptr("iUGmG"), ptr("normal"), ptr("gamma"),
            ptr("eps"), iV.data_ptr(), G_out.data_ptr(), C, nc, nt, ns,
            float(df), seed, offset, (offset + 1) & 0xFFFFFFFF,
            (offset + 2) & 0xFFFFFFFF, K.stream_of(Beta))
    K.check(code, "gamma_v")
    K.launches["gamma_v"] += 1
    return iV, G_out
