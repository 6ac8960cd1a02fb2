"""Per-block mixed-precision policy for the Gibbs sweep (port of
``hmsc_tpu/mcmc/precision.py``).

A :class:`PrecisionPolicy` maps named schedule blocks
(:func:`~hmsc_tpu_torch.mcmc.sweep.make_sweep_schedule`) to a reduced
compute dtype.  Inside a policy'd block every contraction routed through
:mod:`hmsc_tpu_torch.ops.mixed` (``matmul`` / ``einsum``, B6's and B8c's
bf16 forms, B4's) rounds its float operands to bfloat16 and accumulates and
returns float32; reductions outside those wrappers and every Cholesky or
triangular-solve pivot stay float32 (float64 where the port holds them
so).  The block's sweep-invariant model data (the design ``X``, the traits
``Tr``, a spatial level's grids) are **staged**: cast to bfloat16 once per
run by :func:`stage_data` and read inside the policy'd blocks through
``mixed.staged``.

Contracts, as in the JAX package:

- ``precision_policy=None`` (the default) is the exact engine: no wrapper
  fires, and the sweep's draws are bit for bit those of a run without the
  argument.
- :data:`PRECISION_AGREEMENT_TOL` bounds the one-sweep draw-stream
  agreement between the policy'd sweep and the float32 sweep from one
  state (per state tensor, max abs deviation over the tensor's max
  magnitude).
- ``precision_tolerance.json`` (beside this module, a copy of the JAX
  package's) records the measured per-block deviation of every default
  policy on its canonical spec; ``precision_ledger.json`` holds the JAX
  cost ledger's ``precision`` section, the data :func:`default_policy`
  takes its selection from.

``batched_layouts`` takes, inside a bf16 block, the JAX package's folded
solve pair for the library MVN draws (``ops/linalg.py · sample_mvn_prec``:
the Full and dense NNGP Eta draws, the location interweave); the port's
kernels have one layout each.  A layout-only policy (``dtype="float32"``)
is the exact engine, bit for bit.  Inside a bf16 block ``chol_spd``
symmetrises its input, as ``jnp.linalg.cholesky`` does.  Blocks whose bf16
forms are not ported raise ``NotImplementedError`` naming their ROADMAP
item.

One departure (ROADMAP Queue C, C4): the grids the port holds in float64
for accuracy (``structs._F64_FIELDS``: the GPP knot grids ``Fg``, ``iFg``
and ``idDW12g``, Queue C's C1) are not staged.  Rounded to bfloat16 they
make the knot correction ``H = F - M' iA M`` indefinite at most alpha > 0
(at every alpha from 1.4 on config 3c's level), and the JAX package's
policy'd GPP Eta draw is NaN there; the policy's ``staged`` list still
names them, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from .structs import _F64_FIELDS

__all__ = ["PrecisionPolicy", "PRECISION_AGREEMENT_TOL", "TOLERANCE_PATH",
           "LEDGER_PATH", "SUPPORTED_BLOCKS", "NOT_PORTED",
           "classify_spec", "default_policy", "resolve_policy",
           "stage_data", "load_tolerance", "load_ledger"]

# one-sweep agreement between the policy'd and the float32 sweep from one
# mid-chain state (normalised max abs per state tensor), as the JAX
# package pins it
PRECISION_AGREEMENT_TOL = 6e-2

_HERE = os.path.dirname(__file__)
TOLERANCE_PATH = os.path.join(_HERE, "precision_tolerance.json")
LEDGER_PATH = os.path.join(_HERE, "precision_ledger.json")
TOLERANCE_VERSION = 1

# schedule blocks with a mixed-precision implementation in the JAX package
SUPPORTED_BLOCKS = ("BetaLambda", "GammaV", "Rho", "Eta", "EtaSpatial",
                    "Alpha", "Interweave", "wRRR", "BetaSel",
                    "Gamma2", "GammaEta")

# blocks whose policy'd forms the port does not run yet -> ROADMAP item
NOT_PORTED = {
    "Alpha": "A9.2b: the bf16-grid forms of B8b and B8d-3",
    "Rho": "A5", "wRRR": "A7", "BetaSel": "A7", "Gamma2": "A7",
    "GammaEta": "A7"}

# the JAX package's in-code defaults (``_DEFAULT_TARGETS`` /
# ``_DEFAULT_STAGED``), taken when the ledger copy is absent
_DEFAULT_TARGETS = {
    "base": ("BetaLambda", "GammaV", "Rho"),
    "spatial": ("EtaSpatial", "Interweave"),
    "rrr": ("wRRR", "BetaLambda", "GammaV"),
    "sel": ("BetaSel", "BetaLambda", "GammaV"),
}
_DEFAULT_STAGED = {
    "base": ("U", "Qeig", "UTr", "X", "Tr"),
    "spatial": ("iWg_0", "nn_coef_0", "nn_D_0", "idDg_0", "idDW12g_0",
                "Fg_0", "iFg_0", "X"),
    "rrr": ("X", "XRRRs"),
    "sel": ("X",),
}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Hashable per-block precision policy: ``blocks`` computed at
    ``dtype``; ``staged`` model-data names cast to ``dtype`` once per run
    (``"X"`` for a :class:`ModelData` field, ``"iWg_0"`` for level 0's);
    ``batched_layouts`` the folded MVN solve pair in bf16 blocks.
    ``dtype="float32"`` is a layout-only policy: the exact engine."""
    blocks: tuple
    staged: tuple = ()
    dtype: str = "bfloat16"
    batched_layouts: bool = True

    def __post_init__(self):
        object.__setattr__(self, "blocks", tuple(self.blocks))
        object.__setattr__(self, "staged", tuple(self.staged))
        bad = [b for b in self.blocks if b not in SUPPORTED_BLOCKS]
        if bad:
            raise ValueError(
                f"no mixed-precision implementation for block(s) {bad}; "
                f"supported: {SUPPORTED_BLOCKS}")
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError("PrecisionPolicy.dtype must be 'bfloat16' or "
                             f"'float32', got {self.dtype!r}")

    def dtype_for(self, block: str):
        """Compute dtype for a schedule block, or None when unpolicied."""
        return self.dtype if block in self.blocks else None

    def to_meta(self) -> dict:
        """JSON-serializable form (recorded in the Posterior)."""
        return {"blocks": list(self.blocks), "staged": list(self.staged),
                "dtype": self.dtype,
                "batched_layouts": bool(self.batched_layouts)}

    @classmethod
    def from_meta(cls, meta: dict) -> "PrecisionPolicy":
        return cls(blocks=tuple(meta["blocks"]),
                   staged=tuple(meta.get("staged", ())),
                   dtype=meta.get("dtype", "bfloat16"),
                   batched_layouts=bool(meta.get("batched_layouts", True)))


def classify_spec(spec) -> str:
    """The canonical model class whose selection drives the default."""
    if any(ls.spatial is not None for ls in spec.levels):
        return "spatial"
    if spec.nc_rrr > 0:
        return "rrr"
    if spec.ncsel > 0:
        return "sel"
    return "base"


def _block_applies(name: str, spec) -> bool:
    if name == "Rho":
        return bool(spec.has_phylo)
    if name in ("EtaSpatial", "Alpha"):
        return any(ls.spatial is not None for ls in spec.levels)
    if name in ("Eta", "Interweave"):
        return spec.nr > 0
    if name == "wRRR":
        return spec.nc_rrr > 0
    if name == "BetaSel":
        return spec.ncsel > 0
    return True


def load_ledger(path: str = LEDGER_PATH) -> dict | None:
    """The copied cost-ledger selection (``{"precision": {...}}``)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return None


def default_policy(spec, ledger: dict | None = None):
    """The ledger-driven default policy for the spec's model class, or
    ``None`` when no targeted block applies (the JAX package's
    ``default_policy``; ``ledger={}`` takes the in-code defaults)."""
    cls_ = classify_spec(spec)
    blocks = _DEFAULT_TARGETS[cls_]
    staged = _DEFAULT_STAGED[cls_]
    if ledger is None:
        ledger = load_ledger()
    sel = (ledger or {}).get("precision", {}).get(cls_)
    if sel:
        blocks = tuple(sel.get("blocks", blocks))
        staged = tuple(sel.get("staged", staged))
    blocks = tuple(b for b in blocks if _block_applies(b, spec))
    if not blocks:
        return None
    return PrecisionPolicy(blocks=blocks, staged=staged)


def _check_ported(policy):
    if policy is None or policy.dtype == "float32":
        return policy
    for b in policy.blocks:
        if b in NOT_PORTED:
            raise NotImplementedError(
                f"precision_policy: the {b!r} block's mixed-precision form "
                f"is not ported yet (ROADMAP {NOT_PORTED[b]})")
    return policy


def resolve_policy(precision_policy, spec):
    """Normalise ``sample_mcmc``'s ``precision_policy=``: ``None`` (exact
    engine) | ``"auto"``/``"default"`` (ledger-driven) | a
    :class:`PrecisionPolicy` | its ``to_meta()`` dict.  A bf16 policy
    naming a block whose form is not ported raises
    ``NotImplementedError``."""
    if precision_policy is None:
        return None
    if isinstance(precision_policy, str):
        if precision_policy in ("auto", "default"):
            return _check_ported(default_policy(spec))
        raise ValueError(
            f"precision_policy must be None, 'auto', a PrecisionPolicy or "
            f"its to_meta() dict, got {precision_policy!r}")
    if isinstance(precision_policy, dict):
        return _check_ported(PrecisionPolicy.from_meta(precision_policy))
    if isinstance(precision_policy, PrecisionPolicy):
        return _check_ported(precision_policy)
    raise ValueError(f"precision_policy must be None, 'auto', a "
                     f"PrecisionPolicy or its to_meta() dict, got "
                     f"{type(precision_policy).__name__}")


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------

def _resolve_staged(data, name: str):
    head, _, tail = name.rpartition("_")
    if tail.isdigit() and head:
        r = int(tail)
        if r >= len(data.levels):
            return None
        return getattr(data.levels[r], head, None)
    return getattr(data, name, None)


def stage_data(data, policy) -> dict:
    """The bf16 shadow table of ``policy.staged``, made once per run on the
    data's device (round to nearest even, as XLA's convert); absent,
    non-tensor and non-float fields are skipped, and so are the float64
    grids (C4, see the module docstring).  Where the GammaV block is
    policy'd, also ``"TtT"``: ``Tr' Tr`` from the rounded ``Tr`` in
    float32, the block's sweep-invariant gram (the JAX package forms it
    from the shadow every sweep).  A float32 policy stages nothing."""
    if policy is None or policy.dtype == "float32":
        return {}
    out = {}
    for name in policy.staged:
        head, _, tail = name.rpartition("_")
        if (head if tail.isdigit() and head else name) in _F64_FIELDS:
            continue
        arr = _resolve_staged(data, name)
        if not isinstance(arr, torch.Tensor) or not arr.is_floating_point():
            continue
        out[name] = arr.to(torch.bfloat16).contiguous()
    if "GammaV" in policy.blocks:
        tr = out.get("Tr", data.Tr.to(torch.bfloat16)).float()
        out["TtT"] = tr.T @ tr
    return out


# ---------------------------------------------------------------------------
# recorded per-block tolerance
# ---------------------------------------------------------------------------

def load_tolerance(path: str = TOLERANCE_PATH) -> dict | None:
    """The measured per-block deviations (the JAX package's record)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (FileNotFoundError, ValueError):
        return None
    if doc.get("version") != TOLERANCE_VERSION:
        return None
    return doc
