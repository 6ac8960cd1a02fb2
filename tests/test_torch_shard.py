"""The port's site-sharded sweep (``sample_mcmc(mesh=make_mesh(site_shards=
m))``, SPMD over ``torch.distributed`` with gloo on the CPU) against the JAX
package's site axis and against the port's own replicated sweep.

The chain of agreements: the port's replicated sweep is held against the
JAX package's (``tests/test_torch_spatial.py``,
``tests/test_torch_sampler.py``), and the JAX package's site-sharded sweep
against its replicated one (``tests/test_shard.py``).  Here (a) holds the
plain version of kernel B8e, the site-local Vecchia apply, against the JAX
package's ``vecchia_ops_site`` (in ``shard_map`` over the emulated CPU
devices, and rank by rank), and (c) holds the port's site-sharded sweep
against the port's replicated sweep; together they close the chain.  (b)
holds the port's ``ShardCtx`` slicing to the JAX layout and (d) the
refusals of the model classes whose site branches are not ported, and the
divisibility gate.

(c) runs in one group of 2 gloo ranks (``spawn_ranks``), started once for
the module: each rank runs every case of ``CASES`` and returns its states
and posteriors to this process.
"""

import dataclasses
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import hmsc_tpu_torch as ht
from hmsc_tpu_torch.mcmc import partition as tpart
from hmsc_tpu_torch.mcmc.partition import SHARD_AGREEMENT_TOL, ShardCtx
from hmsc_tpu_torch.mcmc.site_check import run_site_cases
from hmsc_tpu_torch.mcmc.structs import LevelData, reverse_neighbours
from hmsc_tpu_torch.ops.spatial import (vecchia_pmv, vecchia_riw_t,
                                        vecchia_site_pmv, vecchia_site_riw_t)
from hmsc_tpu_torch.utils.mesh import Mesh, make_mesh

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

_RANKS = 2            # the spawned group's site extent
_SWEEPS = 3           # chained sweeps per agreement case


# ---------------------------------------------------------------------------
# the canonical site specs of the JAX package
# (hmsc_tpu/analysis/jaxpr_rules.py · _site_shard_models), built by the port
# ---------------------------------------------------------------------------

_NY, _NS, _NU = 16, 8, 8


def _units():
    return [f"u{i % _NU:02d}" for i in range(_NY)]


def _design(rng):
    return np.column_stack([np.ones(_NY), rng.standard_normal((_NY, 1))])


def base_model(distr="probit", seed=21, Y=None):
    """The canonical ``base`` spec without its phylogeny (the port refuses
    a phylogeny, ROADMAP A5): probit, traits, an unstructured level of 8
    units over 16 rows, nf 2."""
    rng = np.random.default_rng(seed)
    X = _design(rng)
    if Y is None:
        Y = (rng.standard_normal((_NY, _NS)) > 0).astype(float)
    units = np.array(_units())
    rl = ht.HmscRandomLevel(units=sorted(set(units)))
    ht.set_priors_random_level(rl, nf_max=2, nf_min=2)
    Tr = np.column_stack([np.ones(_NS), rng.standard_normal(_NS)])
    return ht.Hmsc(Y=Y, X=X, distr=distr, study_design=units[:, None],
                   ran_levels={"lvl": rl}, Tr=Tr)


def spatial_model(method="NNGP", seed=23, **rl_kw):
    """The canonical spatial specs: normal (so InvSigma runs), 8 units on
    [0, 4]^2 over 16 rows, nf 2; ``nngp`` takes 4 neighbours."""
    rng = np.random.default_rng(seed)
    X = _design(rng)
    Y = rng.standard_normal((_NY, _NS))
    units = _units()
    s_df = pd.DataFrame(rng.uniform(size=(_NU, 2)) * 4,
                        index=sorted(set(units)), columns=["x", "y"])
    if method == "NNGP":
        rl_kw.setdefault("n_neighbours", 4)
    rl = ht.HmscRandomLevel(s_data=s_df, s_method=method, **rl_kw)
    ht.set_priors_random_level(rl, nf_max=2, nf_min=2)
    return ht.Hmsc(Y=Y, X=X, distr="normal",
                   study_design=np.array(units)[:, None],
                   ran_levels={"lvl": rl})


_SAMPLE_KW = dict(samples=3, transient=2, n_chains=2, seed=5, nf_cap=2,
                  device="cpu")
# name -> the case each rank runs; nngp_cg forces the CG draw at 8 units,
# as tests/test_shard.py does with its monkeypatch of _NNGP_DENSE_MAX
CASES = {
    "base": dict(kind="sweeps", hM=base_model(), n_sweeps=_SWEEPS, seed=7,
                 n_chains=2, nf_cap=2),
    "nngp_cg": dict(kind="sweeps", hM=spatial_model(), n_sweeps=_SWEEPS,
                    seed=13, n_chains=2, nf_cap=2, dense_max=0),
    "nngp_dense": dict(kind="sweeps", hM=spatial_model(), n_sweeps=_SWEEPS,
                       seed=13, n_chains=2, nf_cap=2, dense_max=10**9),
    "sample_base": dict(kind="sample", hM=base_model(), kw=_SAMPLE_KW),
    "sample_nngp_cg": dict(kind="sample", hM=spatial_model(), kw=_SAMPLE_KW,
                           dense_max=0),
    "collectives": dict(kind="collectives"),
}


@pytest.fixture(scope="module")
def ranks():
    """{case: [rank 0's result, rank 1's]} from one spawned group."""
    names = list(CASES)
    out = ht.spawn_ranks(run_site_cases, _RANKS, "gloo", "cpu",
                         (_RANKS, "gloo", "cpu", [CASES[n] for n in names]),
                         timeout_s=300)
    return {n: [out[r][i] for r in range(_RANKS)]
            for i, n in enumerate(names)}


def _max_rel(a, b):
    """Max abs error normalised by the array's magnitude (the JAX
    package's tests/test_shard.py measure)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(a))),
                                              1e-6))


# ---------------------------------------------------------------------------
# (a) B8e's plain version against the JAX package's vecchia_ops_site
# ---------------------------------------------------------------------------

_C, _NP, _K, _NF, _G = 2, 64, 6, 2, 3


def _vecchia_inputs(seed=3):
    """An NNGP level's lists (ascending earlier units, short lists padded
    with 0 at coefficient 0), grids and per-unit grams, and an iterate."""
    rng = np.random.default_rng(seed)
    nn = np.zeros((_NP, _K), np.int32)
    nn_n = np.minimum(np.arange(_NP), _K).astype(np.int32)
    coef = rng.standard_normal((_G, _NP, _K)).astype(np.float32) * 0.3
    for i in range(_NP):
        if nn_n[i]:
            nn[i, :nn_n[i]] = np.sort(rng.choice(i, nn_n[i], replace=False))
        coef[:, i, nn_n[i]:] = 0.0
    D = rng.uniform(0.5, 1.5, (_G, _NP)).astype(np.float32)
    alpha = rng.integers(0, _G, (_C, _NF)).astype(np.int32)
    A = rng.standard_normal((_C, _NP, _NF, _NF)).astype(np.float32)
    LiSL = (A @ A.transpose(0, 1, 3, 2) * 0.2).astype(np.float32)
    x = rng.standard_normal((_C, _NP, _NF)).astype(np.float32)
    u = rng.standard_normal((_C, _NP, _NF)).astype(np.float32)
    return nn, nn_n, coef, D, alpha, LiSL, x, u


def _rank_level(nn, nn_n, coef, D, m, r):
    """Rank ``r``'s block of the level, as ``structs.site_slice_data``
    makes it: its rows, grids and local reverse-neighbour CSR."""
    w = _NP // m
    sl = slice(r * w, (r + 1) * w)
    ptr, pos = reverse_neighbours(nn[sl], nn_n[sl], _NP)
    t = lambda a, dt=torch.float32: torch.tensor(np.ascontiguousarray(a),
                                                 dtype=dt)
    return LevelData(pi_row=None, unit_count=None, x_row=None, x_unit=None,
                     nu=None, a1=None, b1=None, a2=None, b2=None,
                     nn_idx=t(nn[sl], torch.int32),
                     nn_coef=t(coef[:, sl]), nn_D=t(D[:, sl]),
                     nn_n=t(nn_n[sl], torch.int32),
                     rev_ptr=t(ptr, torch.int32), rev_pos=t(pos, torch.int32))


class _RankShard:
    """The JAX ``ShardCtx`` surface ``vecchia_ops_site`` reads, for one rank
    outside ``shard_map``: its offset, and no psum (the rank's partial)."""

    def __init__(self, m, r):
        self.m, self.r = m, r

    def site_offset(self, size):
        return self.r * (size // self.m)

    def psum_site(self, x):
        return x


def _jax_site_ops(nn_l, coef, D, alpha, LiSL_l, shard):
    """The JAX ``vecchia_ops_site`` of one chain's rows (its grids at the
    chain's alphas)."""
    import jax.numpy as jnp
    from hmsc_tpu.mcmc.spatial import vecchia_ops_site
    c_a = jnp.asarray(coef)[jnp.asarray(alpha)]          # (nf, np_l, k)
    sqD = jnp.sqrt(jnp.asarray(D)[jnp.asarray(alpha)])   # (nf, np_l)
    return vecchia_ops_site(jnp.asarray(nn_l), c_a, sqD, jnp.asarray(LiSL_l),
                            _NP, shard)


@pytest.mark.parametrize("m", [2, 4])
def test_b8e_plain_matches_jax_vecchia_ops_site(m):
    """Each rank's partial (both forms) against the JAX code's on the same
    rows, and the partials summed in rank order against the JAX package's
    psum'd output in ``shard_map`` over ``m`` emulated devices and against
    B8a's unsharded applies: 1e-5 relative."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh as JMesh, PartitionSpec as P
    from hmsc_tpu.mcmc.partition import ShardCtx as JShardCtx
    from hmsc_tpu.mcmc.spatial import vecchia_ops_site

    nn, nn_n, coef, D, alpha, LiSL, x, u = _vecchia_inputs()
    w = _NP // m
    alpha_t = torch.tensor(alpha)
    sum_pmv = sum_riw = 0.0
    for r in range(m):
        sl = slice(r * w, (r + 1) * w)
        lvd = _rank_level(nn, nn_n, coef, D, m, r)
        got_pmv = vecchia_site_pmv(lvd, alpha_t, torch.tensor(x),
                                   torch.tensor(LiSL[:, sl]), r * w).numpy()
        got_riw = vecchia_site_riw_t(lvd, alpha_t, torch.tensor(u[:, sl]),
                                     _NP, r * w).numpy()
        for c in range(_C):
            riw_t, pmv = _jax_site_ops(nn[sl], coef[:, sl], D[:, sl],
                                       alpha[c], LiSL[c, sl],
                                       _RankShard(m, r))
            np.testing.assert_allclose(got_pmv[c], np.asarray(pmv(x[c])),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got_riw[c],
                                       np.asarray(riw_t(u[c, sl])),
                                       rtol=1e-5, atol=1e-5)
        sum_pmv = sum_pmv + got_pmv                      # rank order
        sum_riw = sum_riw + got_riw

    mesh = JMesh(np.array(jax.devices()[:m]).reshape(1, 1, m),
                 axis_names=("chains", "species", "sites"))
    ctx = JShardCtx(axis="species", n=1, ns=_NS, site_axis="sites", m=m,
                    ny=_NP, np_r=(_NP,))
    for c in range(_C):
        c_a = jnp.asarray(coef)[jnp.asarray(alpha[c])]
        sqD = jnp.sqrt(jnp.asarray(D)[jnp.asarray(alpha[c])])

        def body(nn_l, c_l, sq_l, L_l, u_l, xx):
            riw_t, pmv = vecchia_ops_site(nn_l, c_l, sq_l, L_l, _NP, ctx)
            return riw_t(u_l), pmv(xx)

        want_riw, want_pmv = shard_map(
            body, mesh=mesh,
            in_specs=(P("sites", None), P(None, "sites", None),
                      P(None, "sites"), P("sites", None, None),
                      P("sites", None), P()),
            out_specs=(P(), P()), check_rep=False)(
                jnp.asarray(nn), c_a, sqD, jnp.asarray(LiSL[c]),
                jnp.asarray(u[c]), jnp.asarray(x[c]))
        np.testing.assert_allclose(sum_pmv[c], np.asarray(want_pmv),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sum_riw[c], np.asarray(want_riw),
                                   rtol=1e-5, atol=1e-5)

    # and against B8a's unsharded applies (plain versions) on the whole level
    full = _rank_level(nn, nn_n, coef, D, 1, 0)
    np.testing.assert_allclose(
        sum_pmv, vecchia_pmv(full, alpha_t, torch.tensor(x),
                             torch.tensor(LiSL)).numpy(), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        sum_riw, vecchia_riw_t(full, alpha_t, torch.tensor(u)).numpy(),
        rtol=1e-5, atol=1e-5)


def test_local_reverse_csr_covers_every_real_neighbour_once():
    """The ranks' local reverse CSRs together list every real (unit, slot)
    pair of the level once, each under its neighbour."""
    nn, nn_n, *_ = _vecchia_inputs()
    m, w = 4, _NP // 4
    seen = []
    for r in range(m):
        lvd = _rank_level(nn, nn_n, np.zeros((1, _NP, _K), np.float32),
                          np.ones((1, _NP), np.float32), m, r)
        ptr, pos = lvd.rev_ptr.numpy(), lvd.rev_pos.numpy()
        for j in range(_NP):
            for e in range(ptr[j], ptr[j + 1]):
                i, slot = divmod(int(pos[e]), _K)
                assert nn[r * w + i, slot] == j and slot < nn_n[r * w + i]
                seen.append((r * w + i, slot))
    want = [(i, s) for i in range(_NP) for s in range(nn_n[i])]
    assert sorted(seen) == want


# ---------------------------------------------------------------------------
# (b) the ShardCtx slicing against the JAX layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
def test_shardctx_slice_matches_layout(m):
    """Each rank's ``slice_site`` block is the JAX ``ShardCtx``'s on that
    device of a ``shard_map`` over the site axis (rows and units, and a
    dimension after the chain axis), and the blocks in rank order
    reassemble the full array."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh as JMesh, PartitionSpec as P
    from hmsc_tpu.mcmc.partition import ShardCtx as JShardCtx

    mesh = JMesh(np.array(jax.devices()[:m]).reshape(1, 1, m),
                 axis_names=("chains", "species", "sites"))
    jctx = JShardCtx(axis="species", n=1, ns=_NS, site_axis="sites", m=m,
                     ny=_NY, np_r=(_NU,))
    full = np.arange(3 * _NY * 2, dtype=np.float32).reshape(3, _NY, 2)
    got = shard_map(lambda: jctx.slice_site(jnp.asarray(full), 1),
                    mesh=mesh, in_specs=(), out_specs=P(None, "sites", None),
                    check_rep=False)()
    blocks = [ShardCtx(m=m, rank=r, ny=_NY, np_r=(_NU,)).slice_site(
        torch.tensor(full), 1).numpy() for r in range(m)]
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1),
                                  np.asarray(got))
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1), full)
    for r in range(m):
        ctx = ShardCtx(m=m, rank=r, ny=_NY, np_r=(_NU,))
        assert ctx.site_offset(_NY) == r * _NY // m
        assert ctx.site_offset(_NU) == r * _NU // m
        assert ctx.ny_local == _NY // m


def test_site_tables_match_the_jax_package():
    from hmsc_tpu.mcmc import partition as jpart
    assert tpart.SHARD_AGREEMENT_TOL == jpart.SHARD_AGREEMENT_TOL
    assert tpart.STATE_SITE_DIMS == jpart.STATE_SITE_DIMS
    assert tpart.DATA_SITE_DIMS == jpart.DATA_SITE_DIMS
    assert tpart.RECORD_SITE_DIMS == jpart.RECORD_SITE_DIMS
    assert jpart._SITE_UNIT_NAMES <= tpart._SITE_UNIT_NAMES
    for ny, np_r, k in ((16, [8], 4), (16, [8], 3), (12, [5], 4),
                        (16, [8, 6], 4), (2000, [1000], 3)):
        assert tpart.nearest_site_divisor(ny, np_r, k) == \
            jpart.nearest_site_divisor(ny, np_r, k)


# ---------------------------------------------------------------------------
# (c) the site-sharded sweep against the port's replicated sweep, 2 ranks
# ---------------------------------------------------------------------------

def test_shardctx_collectives(ranks):
    """psum / pmax / pmin over the ranks, the gather of each rank's block
    into its place (a zero-filled buffer summed: exact), and all_ok, the
    same on every rank."""
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3) * (r + 1) - r
          for r in range(_RANKS)]
    want = {"psum": sum(xs), "pmax": np.maximum(*xs),
            "pmin": np.minimum(*xs),
            "gather": np.repeat(np.arange(_RANKS, dtype=np.float32),
                                2)[None].repeat(2, 0),
            "all_ok": np.array([True, False])}
    for r in range(_RANKS):
        got = ranks["collectives"][r]
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("case", ["base", "nngp_cg", "nngp_dense"])
def test_site_sharded_sweep_agrees_with_replicated(ranks, case):
    """After 3 sweeps from one seed, the site-sharded state gathered to full
    width is within SHARD_AGREEMENT_TOL of the single-rank sweep's, field
    by field (the JAX package's measure); the CG case ran B8e's plain
    version and the host loop, the dense case B8c's on the gathered
    grids."""
    res = ranks[case][0]
    assert set(res["sharded"]) == set(res["replicated"])
    for k, want in res["replicated"].items():
        got = res["sharded"][k]
        assert got.shape == want.shape, k
        assert np.isfinite(got.astype(float)).all(), k
        err = _max_rel(want, got)
        assert err <= SHARD_AGREEMENT_TOL, (case, k, err)


@pytest.mark.parametrize("case", ["base", "nngp_cg", "nngp_dense",
                                  "sample_base", "sample_nngp_cg"])
def test_site_ranks_bit_identical(ranks, case):
    """Both ranks end with the same bits: the replicated state (and the
    gathered rows and units) of the sweeps, and the whole Posterior of
    ``sample_mcmc``."""
    a, b = ranks[case]
    key = "sharded" if "sharded" in a else "arrays"
    assert set(a[key]) == set(b[key])
    for k in a[key]:
        np.testing.assert_array_equal(a[key][k], b[key][k], err_msg=k)


@pytest.mark.parametrize("case,model", [("sample_base", base_model),
                                        ("sample_nngp_cg", spatial_model)])
def test_site_sharded_sample_mcmc_returns_the_full_posterior(ranks, case,
                                                             model,
                                                             monkeypatch):
    """``sample_mcmc(mesh=...)`` returns on every rank the full Posterior
    (Eta at every unit, ``site_shards`` 2), within SHARD_AGREEMENT_TOL of
    the single-process run from the same seed."""
    from hmsc_tpu_torch.mcmc import spatial
    res = ranks[case][0]
    assert res["site_shards"] == _RANKS
    assert (res["first_bad_it"] < 0).all()
    if case == "sample_nngp_cg":
        monkeypatch.setattr(spatial, "_NNGP_DENSE_MAX", 0)
        # one CG draw a sweep
        assert len(res["cg_iterations"]["loop"]) == (
            _SAMPLE_KW["transient"] + _SAMPLE_KW["samples"])
    post = ht.sample_mcmc(model(), **_SAMPLE_KW)
    assert set(res["arrays"]) == set(post.arrays)
    for k, want in post.arrays.items():
        got = res["arrays"][k]
        assert got.shape == want.shape, k
        assert _max_rel(want, got) <= SHARD_AGREEMENT_TOL, k


# ---------------------------------------------------------------------------
# (d) refusals and the divisibility gate
# ---------------------------------------------------------------------------

_MESH2 = Mesh(site_shards=2, rank=0, backend="gloo",
              device=torch.device("cpu"))
_KW = dict(samples=1, transient=0, n_chains=1, seed=1, nf_cap=2,
           device="cpu")


def _na_model():
    Y = (np.random.default_rng(4).standard_normal((_NY, _NS)) > 0) * 1.0
    Y[0, 0] = np.nan
    return base_model(Y=Y)


@pytest.mark.parametrize("what,build,kw,item", [
    ("species", base_model, dict(mesh=dataclasses.replace(
        _MESH2, species_shards=2)), "A9.3b"),
    ("full", lambda: spatial_model("Full", 22), {}, "A9.3d"),
    ("gpp", lambda: spatial_model(
        "GPP", 24, s_knot=np.random.default_rng(23).uniform(size=(3, 2)) * 4),
     {}, "A9.3d"),
    ("policy", base_model, dict(precision_policy="auto"), "A9.3e"),
    ("poisson", lambda: base_model(distr="poisson"), {}, "A9.3f"),
    ("na", _na_model, {}, "A9.3f"),
    ("da", base_model, dict(updater={"InterweaveDA": True}), "A9.3f"),
])
def test_site_mesh_refuses_unported_classes(what, build, kw, item):
    """Each class the site mesh does not run raises NotImplementedError
    naming its ROADMAP item, before any collective."""
    kw = {"mesh": _MESH2, **kw}
    with pytest.raises(NotImplementedError, match=item):
        ht.sample_mcmc(build(), **_KW, **kw)


def test_nondivisible_sites_warn_and_run_replicated():
    """ny 16 and 8 units do not divide 3 ranks: the warning names the
    nearest valid site_shards (4) and every rank runs the whole sweep, the
    same draws as the single-process run."""
    mesh = dataclasses.replace(_MESH2, site_shards=3)
    with pytest.warns(RuntimeWarning, match="nearest valid site_shards "
                      "for this model is 4"):
        post = ht.sample_mcmc(base_model(), mesh=mesh, **_KW)
    assert post.site_shards == 1
    ref = ht.sample_mcmc(base_model(), **_KW)
    for k in ref.arrays:
        np.testing.assert_array_equal(ref[k], post[k])


def test_nondivisible_sites_strict_mode_raises():
    mesh = dataclasses.replace(_MESH2, site_shards=3)
    with pytest.raises(ValueError, match="shard_sweep=True"):
        ht.sample_mcmc(base_model(), mesh=mesh, shard_sweep=True, **_KW)
    with pytest.raises(ValueError, match="shard_sweep=True requires"):
        ht.sample_mcmc(base_model(), shard_sweep=True, **_KW)


def test_make_mesh_chooses_the_backend(monkeypatch):
    """nccl is never taken on the CPU, and ranks that share a card must
    ask for gloo; one rank needs no process group."""
    with pytest.raises(ValueError, match="only gloo"):
        make_mesh(site_shards=2, backend="nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        make_mesh(site_shards=2, device="cuda")
    with pytest.raises(ValueError, match="NCCL needs a card a rank"):
        make_mesh(site_shards=2, backend="nccl", device="cuda")
    one = make_mesh(site_shards=1, device="cpu")
    assert (one.site_shards, one.rank) == (1, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ht.sample_mcmc(base_model(), mesh=one, **_KW).site_shards == 1
