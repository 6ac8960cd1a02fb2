"""Kernel B9c's selection (``hmsc_tpu_torch/csrc/serve_quantile.cu``),
replayed in numpy step by step: the order-preserving key, the first pass
(NaN, least and largest key), the 8-bit digits from the first bit where the
column's keys differ, the refinement of the bins that hold a wanted rank
(with a bin of one value found at once) and the exact ranking of a bin of
at most ``QUANTILE_FEW`` keys, each wanted bin's keys gathered first in
one pass.  The replay, and the port's plain version
(``ops.serve._draw_quantiles_plain``, a sort, to whose values
``chip_smoke.py`` holds the kernel on the card: -0.0 as +0.0, the same
bits elsewhere) must give equal quantiles, and the values it selects
must be exactly those ``jnp.quantile`` gathers from its sort
(``jnp.sort``): ties, +-inf, -0.0 beside +0.0 and a NaN column, at 1 to
40000 draws.  Against ``jnp.quantile`` itself the
quantiles agree to 1e-6 relative, not bit for bit: XLA on the CPU
contracts the interpolation's lower product and the sum into one fused
multiply-add, where the kernel and the plain version round each step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmsc_tpu_torch.ops import serve as tserve

pytestmark = pytest.mark.torch

F32 = np.float32
Q = (0.0, 0.05, 0.37, 0.5, 0.95, 1.0)
BITS, FEW = tserve.QUANTILE_DIGIT_BITS, tserve.QUANTILE_FEW
BUFFER = tserve.QUANTILE_BUFFER


def key_of(v):
    """The kernel's key: -0.0 as +0.0, then a positive's sign bit flipped
    and a negative's every bit."""
    b = np.ascontiguousarray(v, F32).view(np.uint32).copy()
    b[b == 0x80000000] = 0
    neg = (b & 0x80000000) != 0
    return np.where(neg, ~b, b | np.uint32(0x80000000)).astype(np.uint32)


def value_of(k):
    k = np.asarray(k, np.uint32)
    b = np.where((k & 0x80000000) != 0, k & np.uint32(0x7FFFFFFF), ~k)
    return b.astype(np.uint32).view(F32)


def _refine(keys, ranks, val, k, prefix, pmask, below, cnt, rem, stats,
            what):
    """``resolve`` of the kernel: the wanted ranks' keys from the set of
    ``cnt`` keys of ``keys`` matching prefix / pmask (ranks [below, below +
    cnt) of the column), refined by digits while large, then ranked."""
    while cnt > FEW and rem > 0:
        wd = min(BITS, rem)
        sh = rem - wd
        sel = keys[(keys & np.uint32(pmask)) == prefix]
        stats[what] += 1
        if sel.min() == sel.max():
            prefix, rem = int(sel.min()), 0
            break
        h = np.bincount((sel >> np.uint32(sh)) & np.uint32((1 << wd) - 1),
                        minlength=1 << BITS)
        b, before, cnt = _find(h, k - below)
        prefix |= b << sh
        pmask |= ((1 << wd) - 1) << sh
        below += before
        rem = sh
    if rem == 0:
        for r in ranks:
            if below <= r < below + cnt:
                val[r] = prefix
        return
    stats[what] += 1
    cand = keys[(keys & np.uint32(pmask)) == prefix]        # in order
    assert cand.size == cnt <= FEW
    order = np.argsort(cand, kind="stable")                 # ties by order
    for r in ranks:
        if below <= r < below + cnt:
            val[r] = int(cand[order[r - below]])


def _find(h, k):
    """The bin holding the k-th key: (bin, keys before it, its count)."""
    cum = np.cumsum(h)
    b = int(np.searchsorted(cum, k, side="right"))
    return b, int(cum[b] - h[b]), int(h[b])


def select(keys, ranks, stats):
    """The keys at ``ranks`` of one column (no NaN), as the kernel finds
    them; ``stats`` counts the passes over the whole column ("column") and
    over the buffer's slices ("slice")."""
    n = keys.size
    lo, hi = int(keys.min()), int(keys.max())
    stats["column"] += 1
    if lo == hi:
        return {r: lo for r in ranks}
    top = int(lo ^ hi).bit_length()              # 32 - clz(lo ^ hi)
    pmask0 = 0 if top == 32 else (~((1 << top) - 1)) & 0xFFFFFFFF
    prefix0 = lo & pmask0
    val = {}
    if n <= FEW:
        _refine(keys, ranks, val, 0, prefix0, pmask0, 0, n, top, stats,
                "column")
        return val
    w1 = min(BITS, top)
    shift1 = top - w1
    digit = (keys >> np.uint32(shift1)) & np.uint32((1 << w1) - 1)
    h1 = np.bincount(digit, minlength=1 << BITS)
    stats["column"] += 1
    bins = [_find(h1, k) for k in ranks]
    pmask = pmask0 | (((1 << w1) - 1) << shift1)
    # rounds: the wanted bins of the ranks not yet found get places in the
    # buffer, in rank order, while they fit; one pass gathers their keys
    while True:
        at, used = {}, 0
        for k, (b, _, c) in zip(ranks, bins):
            if k not in val and b not in at and used + c <= BUFFER:
                at[b] = used
                used += c
        if not used:
            break
        stats["column"] += 1
        for k, (b, below, cnt) in zip(ranks, bins):
            if k not in val and b in at:
                _refine(keys[digit == b], ranks, val, k,
                        prefix0 | (b << shift1), pmask, below, cnt, shift1,
                        stats, "slice")
    # a bin larger than the buffer: refined on the whole column
    for k, (b, below, cnt) in zip(ranks, bins):
        if k not in val:
            _refine(keys, ranks, val, k, prefix0 | (b << shift1), pmask,
                    below, cnt, shift1, stats, "column")
    return val


def replay_quantiles(y, q, stats, picked=None):
    """B9c on (n, ...) draws: the ranks floor / ceil of q (n - 1) in
    float32, the select, the interpolation rounded step by step.
    ``stats`` gets each column's pass counts, ``picked`` (column, rank,
    value) of each column without NaN."""
    n = y.shape[0]
    cols = y.reshape(n, -1)
    last = F32(n) - F32(1)
    out = np.empty((len(q), cols.shape[1]), F32)
    pos = np.asarray(q, F32) * last
    ranks = np.stack([np.floor(pos), np.ceil(pos)], 1).clip(0, n - 1)
    ranks = ranks.astype(np.int64)
    w_hi = pos - np.floor(pos)
    w_lo = F32(1) - w_hi
    for c in range(cols.shape[1]):
        x = cols[:, c]
        if np.isnan(x).any():
            out[:, c] = np.nan
            stats.append(None)
            continue
        st = {"column": 0, "slice": 0}
        stats.append(st)
        v = select(key_of(x), [int(r) for r in ranks.ravel()], st)
        if picked is not None:
            picked += [(c, r, value_of(k)) for r, k in v.items()]
        with np.errstate(invalid="ignore"):        # inf * 0, inf - inf
            for i in range(len(q)):
                a = value_of(v[int(ranks[i, 0])]) * w_lo[i]
                b = value_of(v[int(ranks[i, 1])]) * w_hi[i]
                out[i, c] = a + b
    return out.reshape((len(q),) + y.shape[1:])


def draws_with_specials(n, seed):
    """(n, 3, 4) draws: normal columns at several scales, one constant
    column, one of a few repeated values, one of 0 / 1 (sampled probit
    draws), one with +-inf, one with -0.0 beside +0.0 and one with a NaN
    (where n allows)."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((n, 3, 4)) * np.array([0.01, 5.0, 3e4, 1.0])
         ).astype(F32)
    y[:, 0, 0] = 1.0
    y[:, 0, 1] = rng.integers(-3, 4, n).astype(F32) * F32(0.5)
    y[:, 0, 2] = rng.integers(0, 2, n).astype(F32)
    y[:, 1, 0] = rng.uniform(0.0, 1.0, n).astype(F32)
    y[: max(1, n // 3), 1, 1] = np.inf
    y[n // 2:, 1, 1] = -np.inf
    zeros = rng.uniform(size=n) < 0.5
    y[:, 1, 2] = np.where(zeros, np.where(rng.uniform(size=n) < 0.5,
                                          F32(-0.0), F32(0.0)),
                          y[:, 1, 2])
    y[rng.integers(n), 2, 3] = np.nan
    return y


@pytest.mark.parametrize("n", [1, 2, 37, 800, 1025, 40000])
def test_b9c_select_replay_equals_jnp_quantile(n):
    y = draws_with_specials(n, seed=n)
    q = np.asarray(Q, F32)
    stats, picked = [], []
    got = replay_quantiles(y, q, stats, picked)
    # the selection: exactly the values jnp.quantile gathers from its sort
    srt = np.asarray(jnp.sort(jnp.asarray(y), axis=0)).reshape(n, -1)
    for c, r, v in picked:
        assert v == srt[r, c], (c, r, v, srt[r, c])
    assert {c for c, _, _ in picked} == set(range(y[0].size)) - {11}
    # the interpolation: equal to the plain version's (and the kernel's on
    # the card), -0.0 as +0.0; jnp.quantile's fused multiply-add to 1e-6
    plain = tserve._draw_quantiles_plain(torch.from_numpy(y),
                                         torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, plain)
    want = np.asarray(jnp.quantile(jnp.asarray(y), jnp.asarray(q), axis=0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.isnan(got[:, 2, 3]).all() and np.isnan(want[:, 2, 3]).all()
    # a column of continuous values below 2048 draws: the first pass, the
    # histogram and one to three gathers (twelve ranks here) over the
    # column, the rest on the gathered keys
    if n <= 2048:
        for c in (3, 4, 7, 8, 9, 10):
            assert stats[c]["column"] <= 5, (c, stats[c])
