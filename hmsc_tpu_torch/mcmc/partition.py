"""The site axis of the sharded Gibbs sweep: which arrays a rank holds a
block of, and the shard context the updaters read (port of the site half
of ``hmsc_tpu/mcmc/partition.py``).

The JAX package runs the sharded sweep inside ``shard_map``; here it is
SPMD over ``torch.distributed``, one process a rank (``torchrun``, or
:func:`hmsc_tpu_torch.utils.mesh.spawn_ranks`).  Each rank holds its own
block of the sampling rows (Z, Y, Ymask, X, each level's ``pi_row``) and
of each level's units (Eta, the NNGP unit grids); everything else is
replicated.  The ranks talk only where the JAX package calls
``psum_site`` / ``gather_site``: an explicit ``all_reduce`` at each
cross-site reduction.

- **Tables** (:data:`STATE_SITE_DIMS`, :data:`DATA_SITE_DIMS`,
  :data:`RECORD_SITE_DIMS`): the site dimension of every sharded field,
  chain axis excluded, as in the JAX package; :data:`PORT_SITE_DIMS` adds
  the port's own NNGP fields (the lists and grid with the unit last, the
  neighbour counts).
- :class:`ShardCtx`: the rank's geometry and its collectives.  Every
  random draw with a site dimension is taken at the GLOBAL width from the
  replicated stream and sliced, so the sharded draw stream equals the
  replicated sweep's; the kernels that draw in-kernel (B1's fused form,
  B2's Eta form) take the rank's global row or unit offset in their Philox
  counters for the same reason.

**Tolerance contract** (:data:`SHARD_AGREEMENT_TOL`): the sharded sweep
follows the replicated sweep's draw stream; what differs is the order of
the cross-site sums (and, for an NNGP CG draw, the solve's path to the
same tolerance), so after a few sweeps the states agree to well inside
5e-3 of each field's magnitude.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["SHARD_AGREEMENT_TOL", "STATE_SITE_DIMS", "DATA_SITE_DIMS",
           "RECORD_SITE_DIMS", "PORT_SITE_DIMS", "ShardCtx",
           "site_shard_unsupported_reason", "nearest_divisor",
           "nearest_site_divisor"]

# max abs error per state field, over that field's max magnitude, between
# the site-sharded and the replicated sweep after a few sweeps (the JAX
# package's contract, hmsc_tpu/mcmc/partition.py)
SHARD_AGREEMENT_TOL = 5e-3

# site-dimension index per CARRY field (chain axis excluded): Z's rows and
# each level's Eta units
STATE_SITE_DIMS = {"Z": 0, "Eta": 0}

# site-dimension index per MODEL-DATA field: row data by sampling row, the
# NNGP / GPP per-unit grids by unit.  unit_count, x_unit and iWg stay
# replicated, as in the JAX package
DATA_SITE_DIMS = {
    "Y": 0, "Ymask": 0, "X": 0, "pi_row": 0, "x_row": 0,
    "nn_idx": 0, "nn_coef": 1, "nn_D": 1, "idDg": 1, "idDW12g": 1,
}

# the port's own unit-sized NNGP fields: the lists and the grid with the
# unit last (B8b's grid mode) and the real neighbours a unit.  The reverse-
# neighbour CSR is rebuilt for the rank's rows (structs.site_slice_data)
PORT_SITE_DIMS = {"nn_idx_u": 1, "nn_coef_u": 2, "nn_n": 0}

# fields whose site dim is UNIT-sized; everything else is row-sized
_SITE_UNIT_NAMES = {"Eta", "nn_idx", "nn_coef", "nn_D", "idDg", "idDW12g",
                    "nn_idx_u", "nn_coef_u", "nn_n"}

# site-dimension index per RECORDED-SAMPLE key (per-level Eta units)
RECORD_SITE_DIMS = {"Eta": 0}


def nearest_divisor(n: int, k: int) -> int:
    """The divisor of ``n`` nearest to ``k`` (ties prefer the larger)."""
    n, k = int(n), int(k)
    divs = [d for d in range(1, n + 1) if n % d == 0]
    return min(divs, key=lambda d: (abs(d - k), -d))


def nearest_site_divisor(ny: int, np_r, k: int) -> int:
    """The ``site_shards`` nearest to ``k`` that divides ny and every
    level's unit count: the nearest divisor of their gcd."""
    g = int(ny)
    for n in np_r:
        g = math.gcd(g, int(n))
    return nearest_divisor(g, k)


def site_shard_unsupported_reason(spec,
                                  updater: dict | None = None) -> str | None:
    """Why the port's site-sharded sweep cannot run this model, naming the
    ROADMAP item that brings it, or None.  ``sample_mcmc`` raises
    ``NotImplementedError`` with it before the first sweep (and with a
    precision policy on a mesh, A9.3e, before it gets here)."""
    updater = updater or {}
    for ls in spec.levels:
        if ls.spatial in ("Full", "GPP"):
            return (f"a {ls.spatial} level on a site mesh is not ported yet "
                    "(ROADMAP A9.3d)")
    if spec.any_poisson:
        return ("Poisson and lognormal-Poisson columns on a site mesh are "
                "not ported yet (ROADMAP A9.3f)")
    if spec.has_na:
        return ("missing values in Y on a site mesh are not ported yet "
                "(ROADMAP A9.3f)")
    if updater.get("InterweaveDA") is True:
        return ("the probit-DA intercept interweave on a site mesh is not "
                "ported yet (ROADMAP A9.3f)")
    return None


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """A rank's site geometry and its collectives.

    ``m`` ranks on the site axis, this one ``rank``; ``ny`` the GLOBAL
    sampling-row count and ``np_r`` the GLOBAL per-level unit counts (a
    rank's block of a ``size``-long dimension starts at ``rank * size //
    m``).  ``group`` is the ``torch.distributed`` process group (None: the
    default one).  With ``m == 1`` every helper is the identity and no
    collective is made."""
    m: int = 1
    rank: int = 0
    ny: int = 0
    np_r: tuple = ()
    group: Any = None

    @property
    def has_sites(self) -> bool:
        return self.m > 1

    @property
    def ny_local(self) -> int:
        return self.ny // self.m

    def site_offset(self, size: int) -> int:
        """This rank's block start within a ``size``-long global dimension
        (rows or a level's units: both divide evenly)."""
        return self.rank * (int(size) // self.m)

    def slice_site(self, x, dim: int):
        """This rank's site block of a full-width tensor (rows or units:
        the local width is ``x.shape[dim] // m``), contiguous."""
        if not self.has_sites:
            return x
        width = int(x.shape[dim]) // self.m
        return x.narrow(dim, self.site_offset(x.shape[dim]),
                        width).contiguous()

    def _all_reduce(self, x, op):
        import torch.distributed as dist
        y = x.contiguous().clone()
        dist.all_reduce(y, op=op, group=self.group)
        return y

    def psum_site(self, x):
        """Cross-SITE sum: ``all_reduce(SUM)``."""
        if not self.has_sites:
            return x
        import torch.distributed as dist
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax_site(self, x):
        if not self.has_sites:
            return x
        import torch.distributed as dist
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def pmin_site(self, x):
        if not self.has_sites:
            return x
        import torch.distributed as dist
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def gather_site(self, x, dim: int):
        """Full-width reassembly of a site-sharded tensor: the rank's block
        at its offset in a zero-filled full-width buffer, summed over the
        ranks (exact: every other term of each entry is zero)."""
        if not self.has_sites:
            return x
        shape = list(x.shape)
        width = shape[dim]
        shape[dim] = width * self.m
        full = x.new_zeros(shape)
        full.narrow(dim, self.rank * width, width).copy_(x)
        return self.psum_site(full)

    def all_ok(self, ok):
        """A per-chain boolean ANDed over the ranks (divergence tracking):
        a NaN in any rank's block marks the chain on every rank."""
        if not self.has_sites:
            return ok
        bad = self.psum_site((~ok).to(torch.int32))
        return bad == 0

    # -- site-dim draws: the GLOBAL width from the replicated stream, then
    # this rank's block (the kernels that draw in-kernel take the rank's
    # offset in their Philox counters instead)
    def normal(self, rng, shape, dtype, site_dim: int):
        return self.slice_site(rng.normal(tuple(shape), dtype), site_dim)
