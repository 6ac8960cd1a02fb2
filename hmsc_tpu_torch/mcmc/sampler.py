"""The blocked Gibbs sampler (port of the core of
``hmsc_tpu/mcmc/sampler.py``: ``sample_mcmc`` and ``run_chain``).

Chains are a leading batch axis of one state, the JAX package's
``lax.scan`` is a Python loop, and draws are recorded into tensors
preallocated on the device and copied to the host once, at the end.  The
sweep loop makes no host synchronisation but the NNGP CG sampler's
convergence reads (one every few CG iterations, ``mcmc/spatial.py``): the
divergence tracker ``first_bad_update`` stays on the device,
factorisations report failure as NaN, and the kernels' Philox seeds come
from a host generator.

``sample_mcmc(mesh=make_mesh(site_shards=m))`` runs the site-sharded sweep
SPMD, one process a rank (the JAX package's ``mesh=`` with a site axis):
every rank builds the same data and initial state from the seed, keeps its
block of rows and units (``structs.site_slice_data`` /
``site_slice_state``), sweeps with the ranks' ``all_reduce`` at each
cross-site sum, and at the end gathers the recorded Eta rows, so every rank
returns the same full ``Posterior``.
"""

from __future__ import annotations

import logging
import time
import warnings

import numpy as np
import torch

from ..post.posterior import Posterior
from ..precompute import compute_data_parameters
from .partition import (ShardCtx, nearest_site_divisor,
                        site_shard_unsupported_reason)
from .structs import (DEFAULT_NF_CAP, GibbsState, build_model_data,
                      build_spec, build_state, check_supported,
                      site_slice_data, site_slice_state, stack_states)
from .precision import resolve_policy, stage_data
from .sweep import make_sharded_sweep, make_sweep, record_sample
from .updaters import da_intercept_gate, update_z
from ..ops.rand import Rng

log = logging.getLogger(__name__)

__all__ = ["sample_mcmc", "resolve_device", "initial_states"]

# names accepted by sample_mcmc(record=...); per-level variants ("Eta_0")
# are also accepted
_RECORDABLE = {"Beta", "Gamma", "V", "sigma", "rho", "Eta", "Lambda", "Psi",
               "Delta", "Alpha"}
_LEVEL_PARS = {"Eta", "Lambda", "Psi", "Delta", "Alpha"}


def resolve_device(device=None) -> torch.device:
    """The device a run uses: the card unless the caller names another.
    With no card and no explicit device this raises; it never carries on
    on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "hmsc_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def _keep_record(name: str, record) -> bool:
    """Whether a recorded-sample key survives the ``record=`` selection
    (Beta and the nfMask bookkeeping are always kept)."""
    if record is None or name == "Beta" or name.startswith("nfMask"):
        return True
    head, _, tail = name.rpartition("_")
    base = head if tail.isdigit() else name
    return name in record or base in record


def normalize_record(spec, record):
    """Validate a ``record=`` restriction and return it as a sorted tuple
    (``None`` passes through); Lambda is force-included with Eta, its sign
    reference for the alignment."""
    if record is None:
        return None
    if isinstance(record, str):
        record = (record,)
    absent = {"rho"} | (_LEVEL_PARS if spec.nr == 0 else set())
    bad, structural = [], []
    for k in record:
        head, _, tail = k.rpartition("_")
        if tail.isdigit():
            if head not in _LEVEL_PARS or int(tail) >= spec.nr:
                bad.append(k)
        elif k in absent:
            structural.append(k)
        elif k not in _RECORDABLE:
            bad.append(k)
    if structural:
        raise ValueError(
            f"record: parameter(s) {structural} do not exist on this model "
            "('rho' needs a phylogeny; per-level parameters need at least "
            "one random level)")
    if bad:
        raise ValueError(
            f"record: unknown parameter name(s) {bad}; valid names are "
            f"{sorted(_RECORDABLE)} (per-level parameters also accept a "
            f"_<level> suffix below nr={spec.nr})")
    rec_set = set(record)
    for k in list(rec_set):
        head, _, tail = k.rpartition("_")
        if k == "Eta" or (tail.isdigit() and head == "Eta"):
            rec_set.add("Lambda" if k == "Eta" else f"Lambda_{tail}")
    return tuple(sorted(rec_set))


def initial_states(hM, spec, seed, n_chains, device):
    """The chains' initial states and the numpy generator the seed table
    came from: the SAME table as the JAX sampler (``sampler.py:1166-1170,
    1198``), so chain c starts from the identical ``build_state`` draw."""
    rng = np.random.default_rng(seed)
    chain_seeds = rng.integers(0, 2**31 - 1, size=n_chains)
    state = stack_states([build_state(hM, spec, int(s), device)
                          for s in chain_seeds])
    return state, rng


def first_bad_update(state: GibbsState, bad_it, shard=None):
    """Track the first iteration whose state went non-finite, per chain
    (divergence observability; on the device, no host sync).  On a site
    mesh a chain is bad when it is on any rank (one ``all_reduce``)."""
    ok = torch.ones_like(bad_it, dtype=torch.bool)
    for t in state.float_tensors():
        ok = ok & torch.isfinite(t).flatten(1).all(dim=1)
    if shard is not None:
        ok = shard.all_ok(ok)
    return torch.where((bad_it < 0) & ~ok, state.it, bad_it)


def _site_shard(spec, mesh, updater, shard_sweep):
    """The site axis ``sample_mcmc`` engages on ``mesh`` (the JAX package's
    gate, ``sampler.py:1267-1380``): a :class:`ShardCtx`, or None where the
    mesh has no site axis, ``shard_sweep`` is False, or ny or a level's
    unit count does not divide ``site_shards`` (a warning naming the
    nearest valid ``site_shards``, every rank then running the whole
    sweep; a ``ValueError`` with ``shard_sweep=True``).  Raises
    ``NotImplementedError`` for a model class whose site branches are not
    ported."""
    if shard_sweep not in (None, True, False):
        raise ValueError(f"shard_sweep must be None (auto), True or False, "
                         f"got {shard_sweep!r}")
    m = 1 if mesh is None else int(mesh.site_shards)
    if shard_sweep is True and m < 2:
        raise ValueError("shard_sweep=True requires a mesh with a 'sites' "
                         "axis of extent >= 2 — build one with "
                         "make_mesh(site_shards=m)")
    if m < 2 or shard_sweep is False:
        return None
    reason = site_shard_unsupported_reason(spec, updater)
    if reason is not None:
        raise NotImplementedError(f"sample_mcmc(mesh=...): {reason}")
    bad_np = [ls.n_units for ls in spec.levels if ls.n_units % m]
    if spec.ny % m or bad_np:
        what = (f"ny={spec.ny}" if spec.ny % m
                else f"a level's unit count np={bad_np[0]}")
        near = nearest_site_divisor(spec.ny,
                                    [ls.n_units for ls in spec.levels], m)
        msg = (f"mesh names a 'sites' axis of size {m} but {what} is not "
               f"divisible by site_shards={m}; the nearest valid "
               f"site_shards for this model is {near}")
        if shard_sweep is True:
            raise ValueError(f"shard_sweep=True but {msg}")
        warnings.warn(f"{msg}; site arrays are replicated (every rank "
                      "runs the whole sweep)", RuntimeWarning, stacklevel=3)
        return None
    return ShardCtx(m=m, rank=int(mesh.rank), ny=spec.ny,
                    np_r=tuple(ls.n_units for ls in spec.levels),
                    group=mesh.group)


def sample_mcmc(hM, samples: int, transient: int = 0, thin: int = 1,
                n_chains: int = 1, seed: int | None = None,
                nf_cap: int = DEFAULT_NF_CAP, adapt_nf=None,
                updater: dict | None = None, record=None,
                align_post: bool = True, device=None,
                precision_policy=None, mesh=None, shard_sweep=None,
                checkpoint_every: int = 0,
                checkpoint_path: str | None = None) -> Posterior:
    """Run the blocked Gibbs sampler; returns a :class:`Posterior`.

    The arguments mirror the JAX package's ``sample_mcmc`` (``samples``,
    ``transient``, ``thin``, ``n_chains``, ``seed``, ``nf_cap``,
    ``adapt_nf``, ``updater``, ``record``, ``align_post``).
    ``device`` defaults to the CUDA card; with none present the call
    raises unless ``device="cpu"`` is given, which runs the kernels' plain
    PyTorch versions.  float32 matrix products run in full float32: the
    call sets ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False.

    ``precision_policy`` engages the per-block mixed-precision engine
    (:mod:`hmsc_tpu_torch.mcmc.precision`): ``"auto"`` takes the
    ledger-driven default for the model's class (``BetaLambda`` and
    ``GammaV`` for models without a spatial level, ``EtaSpatial`` and
    ``Interweave`` with one), a ``PrecisionPolicy`` or its ``to_meta()``
    dict names its own; ``None`` is the exact engine.  The policy is
    resolved against the final spec, its bf16 shadows are staged once
    before the timed loop, and ``policy.to_meta()`` is recorded as the
    Posterior's ``precision_policy``.  A policy naming a block whose
    mixed-precision form is not ported (``Alpha``, ``Rho``, ``wRRR``,
    ``BetaSel``, ``Gamma2``, ``GammaEta``) raises ``NotImplementedError``.

    ``mesh`` (:func:`hmsc_tpu_torch.utils.mesh.make_mesh`, called on every
    rank: ``torchrun`` or ``spawn_ranks`` start them) runs the site-sharded
    sweep, SPMD: each rank holds its block of the sampling rows and of each
    level's units, the ranks ``all_reduce`` at each cross-site sum, and
    every rank returns the same full Posterior (its ``site_shards`` says
    how many ranks sampled it).  ``device`` defaults to the mesh's.
    ``shard_sweep``: None shards where ny and every level's unit count
    divide ``site_shards`` and warns (naming the nearest valid value) and
    runs the whole sweep on every rank where not; True makes that a
    ``ValueError``; False never shards.  ``NotImplementedError`` names the
    ROADMAP item of what a mesh does not run yet: ``species_shards > 1``
    (A9.3b), a Full or GPP level (A9.3d), a precision policy with a mesh
    (A9.3e), Poisson or lognormal-Poisson columns, missing values in Y and
    the probit-DA interweave (A9.3f).  Checkpointing is not ported yet
    (ROADMAP A9.1) and raises.

    The returned Posterior carries ``timing`` = {setup_s, run_s}: run_s is
    the sampling loop up to and including the copy of the draws to the
    host; and ``cg_iterations``, one entry per NNGP CG Eta draw in sweep
    order: the iterations the CG loop ran (``"loop"``, a list) and each
    chain's own (``"chains"``, an (n_draws, n_chains) array)."""
    for name, val in (("checkpoint_every", checkpoint_every),
                      ("checkpoint_path", checkpoint_path)):
        if val:
            raise NotImplementedError(
                f"sample_mcmc({name}=...) is not ported yet (ROADMAP A9.1)")
    if mesh is not None:
        if mesh.species_shards > 1:
            raise NotImplementedError(
                "sample_mcmc(mesh=...): species sharding (species_shards "
                "> 1) is not ported yet (ROADMAP A9.3b)")
        if precision_policy is not None:
            raise NotImplementedError(
                "sample_mcmc(mesh=...): a precision policy together with a "
                "mesh is not ported yet (ROADMAP A9.3e)")
        if device is None:
            device = mesh.device
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    if adapt_nf is None:
        adapt_nf = tuple(transient for _ in range(hM.nr))
    else:
        adapt_nf = tuple(int(a) for a in np.broadcast_to(adapt_nf, (hM.nr,)))
    if any(a > transient for a in adapt_nf):
        raise ValueError("transient parameter should be no less than any "
                         "element of adaptNf parameter")

    spec = build_spec(hM, nf_cap)
    check_supported(hM, spec)
    shard = _site_shard(spec, mesh, updater, shard_sweep)
    record = normalize_record(spec, record)
    # the per-block mixed-precision policy, resolved against the final spec
    # (the "auto" selection sees the model class it will run)
    policy = resolve_policy(precision_policy, spec)
    data = build_model_data(hM, compute_data_parameters(hM), spec, dev)
    # structural gate for the opt-in probit-DA intercept interweave: a
    # model it cannot run on is told so, and runs without it
    if updater and updater.get("InterweaveDA") is True:
        reason = da_intercept_gate(
            spec, has_intercept=data.x_ones_ind is not None)
        if reason:
            log.info(f"Setting updater$InterweaveDA=FALSE: {reason}")
            updater = dict(updater)
            updater["InterweaveDA"] = False
    state, rng = initial_states(hM, spec, seed, n_chains, dev)
    trng = Rng(int(rng.integers(0, 2**62)), dev)
    cg_log = []         # (level, loop iterations, largest, per-chain)
    if shard is not None:
        # every rank keeps its block of the rows and units
        data = site_slice_data(data, shard)
        state = site_slice_state(state, shard)
        sweep = make_sharded_sweep(spec, shard, updater, adapt_nf, cg_log)
    else:
        # the policy's bf16 shadows, staged once before the timed loop
        sweep = make_sweep(spec, updater, adapt_nf, cg_log,
                           precision=policy, staged=stage_data(data, policy))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()

    # the reference initialises Z with one updateZ pass
    state = update_z(spec, data, state, trng, shard=shard)
    bad = first_bad_update(state, torch.full((n_chains,), -1,
                                             dtype=torch.int32, device=dev),
                           shard)
    it = 0
    for _ in range(transient):
        it += 1
        state = sweep(data, state, trng, it=it)
        bad = first_bad_update(state, bad, shard)

    buf = None
    for s in range(samples):
        for _ in range(thin):
            it += 1
            state = sweep(data, state, trng, it=it)
            bad = first_bad_update(state, bad, shard)
        rec = {k: v for k, v in record_sample(spec, data, state).items()
               if _keep_record(k, record)}
        if buf is None:
            buf = {k: v.new_empty((n_chains, samples) + tuple(v.shape[1:]))
                   for k, v in rec.items()}
        for k, v in rec.items():
            buf[k][:, s] = v
    if shard is not None and buf is not None:
        # the recorded Eta rows, gathered to full width on every rank
        for k in [k for k in buf if k.startswith("Eta_")]:
            buf[k] = shard.gather_site(buf[k], 2)
    arrays = {k: v.cpu().numpy() for k, v in (buf or {}).items()}
    first_bad = bad.cpu().numpy()
    nf_sat = {r: state.levels[r].nf_sat.cpu().numpy()
              for r in range(spec.nr)}
    cg_iterations = {
        "loop": (torch.stack([torch.as_tensor(e[1], device=dev)
                              for e in cg_log]).tolist() if cg_log else []),
        "chains": (torch.stack([e[3] for e in cg_log]).cpu().numpy()
                   if cg_log else np.zeros((0, n_chains), np.int32))}
    t2 = time.perf_counter()

    post = Posterior(hM, spec, arrays, samples=samples, transient=transient,
                     thin=thin)
    post.timing = {"setup_s": t1 - t0, "run_s": t2 - t1}
    post.precision_policy = None if policy is None else policy.to_meta()
    post.cg_iterations = cg_iterations
    post.site_shards = 1 if shard is None else shard.m
    post.set_chain_health(first_bad)
    for c in np.nonzero(first_bad >= 0)[0]:
        warnings.warn(
            f"chain {c} diverged: non-finite state first seen at sweep "
            f"{int(first_bad[c])} (of {it}); its draws are excluded from "
            "pooled summaries (see Posterior.chain_health)",
            RuntimeWarning, stacklevel=2)
    post.nf_saturation = nf_sat
    for r in range(spec.nr):
        if (nf_sat[r] > 0).any():
            warnings.warn(
                f"random level '{spec.levels[r].name}': factor adaptation "
                f"hit the nf_max cap ({spec.levels[r].nf_max}) and wanted to "
                f"add more factors ({nf_sat[r].tolist()} blocked attempts "
                "per chain); raise nf_cap and refit", RuntimeWarning,
                stacklevel=2)

    if align_post and spec.nr > 0 and samples > 0:
        from ..post.align import align_posterior
        for _ in range(5):
            if align_posterior(post) == 0:
                break
    return post
