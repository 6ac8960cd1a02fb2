"""Checks of the site-sharded sweep that run on every rank of a site mesh,
for :func:`hmsc_tpu_torch.utils.mesh.spawn_ranks` (module-level functions,
so a spawned rank imports this module and nothing of its caller's).

:func:`run_site_cases` runs a list of cases in one group of ranks and
returns each case's result as numpy arrays and plain numbers:

- ``{"kind": "sweeps", "hM", "n_sweeps", "seed", "n_chains", "nf_cap"}``:
  the same initial state swept ``n_sweeps`` times by the single-rank sweep
  and by the site-sharded sweep from the same seed; the result holds both
  final states at full width (``"replicated"``, ``"sharded"``, fields
  keyed as ``structs.state_from_numpy`` takes them), the kernel launches
  of the sharded sweeps and their wall time;
- ``{"kind": "sample", "hM", "kw"}``: ``sample_mcmc(hM, mesh=..., **kw)``;
  the Posterior's arrays, timing, CG counts, ``site_shards`` and the
  kernel launches of the run;
- ``{"kind": "all_reduce", "shape", "calls"}``: the host time of one
  ``all_reduce`` of a float32 tensor of ``shape`` on the rank's device,
  averaged over ``calls`` after a warm-up (through host memory under
  gloo);
- ``{"kind": "collectives"}``: each ``ShardCtx`` collective on this
  rank's small, rank-dependent inputs (``psum_site``, ``pmax_site``,
  ``pmin_site``, ``gather_site``, ``all_ok``), as numpy.

A case's ``"dense_max"`` sets the NNGP dense/CG crossover
(``spatial._NNGP_DENSE_MAX``) while it runs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["run_site_cases", "state_to_numpy"]


def state_to_numpy(state) -> dict:
    """A GibbsState as numpy arrays keyed by field name (per-level fields
    as ``levels.<r>.<field>``)."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "levels":
            for r, lv in enumerate(v):
                for g in dataclasses.fields(lv):
                    out[f"levels.{r}.{g.name}"] = \
                        getattr(lv, g.name).cpu().numpy()
        else:
            out[f.name] = v.cpu().numpy()
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sweeps(mesh, case):
    from .. import kernels as K
    from ..ops.rand import Rng
    from ..precompute import compute_data_parameters
    from .partition import ShardCtx
    from .sampler import initial_states
    from .structs import (build_model_data, build_spec, check_supported,
                          site_gather_state, site_slice_data,
                          site_slice_state)
    from .sweep import make_sharded_sweep, make_sweep
    from .updaters import update_z

    hM, n = case["hM"], int(case["n_sweeps"])
    dev = mesh.device
    spec = build_spec(hM, case.get("nf_cap", 16))
    check_supported(hM, spec)
    data = build_model_data(hM, compute_data_parameters(hM), spec, dev)
    state0, rng = initial_states(hM, spec, case.get("seed", 1),
                                 case.get("n_chains", 2), dev)
    seed = int(rng.integers(0, 2**62))
    adapt = tuple(0 for _ in range(spec.nr))

    trng = Rng(seed, dev)
    sweep = make_sweep(spec, None, adapt, [])
    s = update_z(spec, data, state0, trng)
    for it in range(1, n + 1):
        s = sweep(data, s, trng, it=it)
    replicated = state_to_numpy(s)

    ctx = ShardCtx(m=mesh.site_shards, rank=mesh.rank, ny=spec.ny,
                   np_r=tuple(ls.n_units for ls in spec.levels),
                   group=mesh.group)
    d_l, s_l = site_slice_data(data, ctx), site_slice_state(state0, ctx)
    trng = Rng(seed, dev)
    sweep = make_sharded_sweep(spec, ctx, None, adapt, [])
    _sync(dev)
    K.reset_launches()
    t0 = time.perf_counter()
    s_l = update_z(spec, d_l, s_l, trng, shard=ctx)
    for it in range(1, n + 1):
        s_l = sweep(d_l, s_l, trng, it=it)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(K.launches)
    sharded = state_to_numpy(site_gather_state(s_l, ctx))
    return {"replicated": replicated, "sharded": sharded,
            "launches": launches, "wall_s": wall}


def _sample(mesh, case):
    from .. import kernels as K
    from .sampler import sample_mcmc

    _sync(mesh.device)
    K.reset_launches()
    post = sample_mcmc(case["hM"], mesh=mesh, **case.get("kw", {}))
    _sync(mesh.device)
    return {"arrays": {k: np.asarray(v) for k, v in post.arrays.items()},
            "timing": post.timing, "cg_iterations": post.cg_iterations,
            "site_shards": post.site_shards,
            "first_bad_it": post.chain_health["first_bad_it"],
            "launches": dict(K.launches)}


def _all_reduce(mesh, case):
    import torch.distributed as dist
    x = torch.ones(tuple(case["shape"]), device=mesh.device)
    for _ in range(3):
        dist.all_reduce(x, group=mesh.group)
    calls = int(case.get("calls", 50))
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(calls):
        dist.all_reduce(x, group=mesh.group)
    _sync(mesh.device)
    return {"ms": (time.perf_counter() - t0) * 1e3 / calls,
            "bytes": x.numel() * 4}


def _collectives(mesh, case):
    from .partition import ShardCtx
    m, r = mesh.site_shards, mesh.rank
    ctx = ShardCtx(m=m, rank=r, ny=2 * m, np_r=(m,), group=mesh.group)
    x = torch.arange(6, dtype=torch.float32,
                     device=mesh.device).reshape(2, 3) * (r + 1) - r
    block = torch.full((2, 2), float(r), device=mesh.device)
    ok = torch.tensor([True, r != m - 1], device=mesh.device)
    return {k: v.cpu().numpy() for k, v in (
        ("psum", ctx.psum_site(x)), ("pmax", ctx.pmax_site(x)),
        ("pmin", ctx.pmin_site(x)), ("gather", ctx.gather_site(block, 1)),
        ("all_ok", ctx.all_ok(ok)))}


_CASES = {"sweeps": _sweeps, "sample": _sample, "all_reduce": _all_reduce,
          "collectives": _collectives}


def run_site_cases(rank, site_shards, backend, device, cases) -> list:
    """Every case of ``cases`` (see the module docstring) on this rank of a
    ``site_shards``-rank mesh made with ``backend`` on ``device``; for
    ``spawn_ranks(run_site_cases, m, backend, device, (m, backend,
    device, cases))``."""
    from ..utils.mesh import make_mesh
    from . import spatial
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(site_shards=site_shards, backend=backend, device=device)
    out = []
    for c in cases:
        saved = spatial._NNGP_DENSE_MAX
        if c.get("dense_max") is not None:
            spatial._NNGP_DENSE_MAX = int(c["dense_max"])
        try:
            out.append(_CASES[c["kind"]](mesh, c))
        finally:
            spatial._NNGP_DENSE_MAX = saved
    return out
