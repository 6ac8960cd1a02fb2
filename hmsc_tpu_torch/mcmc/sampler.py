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
"""

from __future__ import annotations

import logging
import time
import warnings

import numpy as np
import torch

from ..post.posterior import Posterior
from ..precompute import compute_data_parameters
from .structs import (DEFAULT_NF_CAP, GibbsState, build_model_data,
                      build_spec, build_state, check_supported,
                      stack_states)
from .precision import resolve_policy, stage_data
from .sweep import make_sweep, record_sample
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


def first_bad_update(state: GibbsState, bad_it):
    """Track the first iteration whose state went non-finite, per chain
    (divergence observability; on the device, no host sync)."""
    ok = torch.ones_like(bad_it, dtype=torch.bool)
    for t in state.float_tensors():
        ok = ok & torch.isfinite(t).flatten(1).all(dim=1)
    return torch.where((bad_it < 0) & ~ok, state.it, bad_it)


def sample_mcmc(hM, samples: int, transient: int = 0, thin: int = 1,
                n_chains: int = 1, seed: int | None = None,
                nf_cap: int = DEFAULT_NF_CAP, adapt_nf=None,
                updater: dict | None = None, record=None,
                align_post: bool = True, device=None,
                precision_policy=None, mesh=None, checkpoint_every: int = 0,
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
    ``mesh`` and checkpointing are not ported yet (ROADMAP A9) and raise.

    The returned Posterior carries ``timing`` = {setup_s, run_s}: run_s is
    the sampling loop up to and including the copy of the draws to the
    host; and ``cg_iterations``, one entry per NNGP CG Eta draw in sweep
    order: the iterations the CG loop ran (``"loop"``, a list) and each
    chain's own (``"chains"``, an (n_draws, n_chains) array)."""
    for name, val, item in (("mesh", mesh, "A9.3"),
                            ("checkpoint_every", checkpoint_every, "A9.1"),
                            ("checkpoint_path", checkpoint_path, "A9.1")):
        if val:
            raise NotImplementedError(
                f"sample_mcmc({name}=...) is not ported yet (ROADMAP {item})")
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
    # the policy's bf16 shadows, staged once before the timed loop
    sweep = make_sweep(spec, updater, adapt_nf, cg_log, precision=policy,
                       staged=stage_data(data, policy))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()

    # the reference initialises Z with one updateZ pass
    state = update_z(spec, data, state, trng)
    bad = first_bad_update(state, torch.full((n_chains,), -1,
                                             dtype=torch.int32, device=dev))
    it = 0
    for _ in range(transient):
        it += 1
        state = sweep(data, state, trng, it=it)
        bad = first_bad_update(state, bad)

    buf = None
    for s in range(samples):
        for _ in range(thin):
            it += 1
            state = sweep(data, state, trng, it=it)
            bad = first_bad_update(state, bad)
        rec = {k: v for k, v in record_sample(spec, data, state).items()
               if _keep_record(k, record)}
        if buf is None:
            buf = {k: v.new_empty((n_chains, samples) + tuple(v.shape[1:]))
                   for k, v in rec.items()}
        for k, v in rec.items():
            buf[k][:, s] = v
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
