"""hmsc_tpu_torch — the PyTorch/CUDA port of ``hmsc_tpu`` for NVIDIA Hopper
(H100, sm_90a).

Requires PyTorch (``torch`` is not a dependency of the ``hmsc-tpu``
distribution: install it for your CUDA toolkit) and, to build the
hand-written kernels under ``csrc/``, the CUDA toolkit's ``nvcc``.  The port
imports neither JAX nor the ``hmsc_tpu`` package; the numpy host modules it
needs (model specification, formulas, random levels, initial values,
posterior container) are copied into it.

This slice samples normal, probit, Poisson and lognormal-Poisson JSDMs
(any mix of them across species), with missing values in Y, a design
matrix, optional traits, and unstructured or spatial (``Full``, ``NNGP``
and ``GPP``) random levels (``sample_mcmc``), with the opt-in probit-DA
intercept interweave (``updater={"InterweaveDA": True}``), the JAX
package's per-block mixed-precision policy (``precision_policy=``) and
its site-sharded sweep over ``torch.distributed`` (``mesh=make_mesh(
site_shards=m)``, one process a rank), and
predicts from and serves the fitted posterior (``predict``, ``ServingEngine``, compacted
serving artifacts in the JAX package's format, ``python -m hmsc_tpu_torch
serve <artifact>``).  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``; features of later slices raise
``NotImplementedError`` naming their ROADMAP item.
"""

from .model import Hmsc
from .random_level import HmscRandomLevel, set_priors_random_level
from .precompute import construct_knots
from .mcmc.sampler import sample_mcmc
from .post import Posterior
from .predict import construct_gradient, predict
from .serve import ServingEngine, compact_posterior, load_artifact
from .utils.mesh import make_mesh, spawn_ranks

# reference-style camelCase alias
constructKnots = construct_knots

__all__ = ["Hmsc", "HmscRandomLevel", "set_priors_random_level",
           "construct_knots", "constructKnots", "sample_mcmc", "Posterior",
           "predict", "construct_gradient", "ServingEngine",
           "compact_posterior", "load_artifact", "make_mesh", "spawn_ranks"]
