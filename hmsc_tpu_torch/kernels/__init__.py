"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled on first use by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc -c`` per source
started together, then linked into one shared library (named by a hash
of the sources and flags, so an edited source is rebuilt).  In a source
checkout the library goes to ``build/hmsc_tpu_torch_kernels/`` beside the
package; an installed package builds into the user's cache,
``$XDG_CACHE_HOME/hmsc_tpu_torch`` (``~/.cache/hmsc_tpu_torch``).  The library has a plain C
interface and is loaded with ``ctypes``; every entry point returns
``cudaGetLastError()`` after its launch, and :func:`check` raises on a
non-zero value.

``launches`` counts kernel launches per kernel.  A wrapper in
:mod:`hmsc_tpu_torch.ops` adds one where it launches its kernel and nowhere
else, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["launches", "reset_launches", "library", "check", "stream_of",
           "KERNELS"]

# kernel name -> its source file under csrc/
KERNELS = {"probit_z": "probit_z.cu",
           "probit_z_fused": "probit_z.cu",
           "mvn_prec_small": "mvn_prec_small.cu",
           "standard_gamma": "standard_gamma.cu",
           "shrinkage_gamma": "shrinkage_gamma.cu",
           "gamma_v": "gamma_v.cu",
           "poisson_z": "poisson_z.cu",
           "masked_gram": "masked_gram.cu",
           "vecchia_apply": "vecchia_apply.cu",
           "vecchia_site": "vecchia_site.cu",
           "nngp_quad": "nngp_quad.cu",
           "nngp_riw": "nngp_riw.cu",
           "gpp_unit": "gpp_unit.cu",
           "gpp_knot": "gpp_knot.cu",
           "gpp_quad": "gpp_quad.cu",
           "truncnorm_da": "truncnorm_da.cu",
           "serve_predict": "serve_predict.cu",
           "serve_quantile": "serve_quantile.cu",
           "serve_conditional": "serve_conditional.cu",
           "mixed_gemm": "mixed_gemm.cu"}

launches = {name: 0 for name in KERNELS}

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC"]

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from csrc/ on first use")


def _build_dir() -> pathlib.Path:
    if (_PKG.parent / "pyproject.toml").exists():       # a source checkout
        return _PKG.parent / "build" / "hmsc_tpu_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return pathlib.Path(cache) / "hmsc_tpu_torch"


def _build() -> pathlib.Path:
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    tag = h.hexdigest()[:16]
    build = _build_dir()
    so = build / f"libhmsc_tpu_torch_{tag}.so"
    if so.exists():
        return so
    build.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sources:
        obj = build / f"{src.stem}_{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src.name}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([nvcc, *_FLAGS, "-shared", *map(str, objs), "-o",
                        str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


def library():
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            p, i, ll, u64, u32 = (ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_ulonglong,
                                  ctypes.c_uint)
            lib.hmsc_probit_z.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                          u64, u32, p]
            lib.hmsc_probit_z_fused.argtypes = [p] * 11 + [i] * 8 + [
                u64, u32, p]
            lib.hmsc_mvn_prec_small.argtypes = [p, i, p, i] + [p] * 5 + [
                i, i, p, p, ll, i, i, i, i, i, u64, u32, p]
            lib.hmsc_standard_gamma.argtypes = [p, p, ll, u64, u32, p]
            lib.hmsc_shrinkage_gamma.argtypes = [p] * 10 + [i] * 8 + [
                u64, u32, u32, p]
            lib.hmsc_shrinkage_clusters.argtypes = [i, i, i, p]
            lib.hmsc_gamma_v.argtypes = [p] * 13 + [i] * 4 + [
                ctypes.c_float, u64, u32, u32, u32, p]
            lib.hmsc_z_mixed.argtypes = [p] * 11 + [i] * 6 + [u64, u32, p]
            lib.hmsc_masked_gram.argtypes = [p, ll, ll, ll, p, ll, ll, p, ll,
                                             ll, p, ll, ll, ll, p, p, p, p, p,
                                             p, i, i, i, i, i, i, i, i, i, p]
            lib.hmsc_vecchia_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                             p]
            lib.hmsc_vecchia_adj.argtypes = [p, p, p, p, p, p, p, p, p, i, i,
                                             i, i, i, p]
            lib.hmsc_vecchia_site.argtypes = [p] * 11 + [i] * 6 + [p]
            lib.hmsc_vecchia_cg.argtypes = [p] * 15 + [i] * 8 + [
                ctypes.c_float, i, p]
            lib.hmsc_nngp_quad_grid.argtypes = [p] * 5 + [i] * 8 + [p]
            lib.hmsc_nngp_quad_at.argtypes = [p] * 6 + [i] * 10 + [p]
            lib.hmsc_nngp_iw.argtypes = [p] * 8 + [i] * 8 + [p]
            lib.hmsc_gpp_unit.argtypes = [p, p, p, p, p, p, i, i, i, p]
            lib.hmsc_gpp_knot.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                          i, i, p]
            lib.hmsc_gpp_quad_grid.argtypes = [p] * 7 + [i] * 7 + [p]
            lib.hmsc_gpp_quad_at.argtypes = [p] * 8 + [i] * 6 + [p]
            lib.hmsc_truncnorm_da.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                              i, i, i, i, i, u64, u32, p]
            lib.hmsc_serve_predict.argtypes = [p] * 8 + [i] + [p] * 10 + [
                i] * 12 + [u64, u32, p]
            lib.hmsc_serve_quantile.argtypes = [p, ll, i, i, p, i, p, p]
            lib.hmsc_serve_conditional.argtypes = [p] * 10 + [i] + [p] * 11 + [
                i] * 13 + [u64, u32, p]
            lib.hmsc_mixed_gemm.argtypes = [p, i, ll, ll, ll, p, i, ll, ll,
                                            ll, p, p] + [i] * 6 + [p]
            for fn in (lib.hmsc_probit_z, lib.hmsc_probit_z_fused,
                       lib.hmsc_mvn_prec_small,
                       lib.hmsc_standard_gamma, lib.hmsc_shrinkage_gamma,
                       lib.hmsc_shrinkage_clusters,
                       lib.hmsc_gamma_v,
                       lib.hmsc_z_mixed,
                       lib.hmsc_masked_gram, lib.hmsc_vecchia_fwd,
                       lib.hmsc_vecchia_adj, lib.hmsc_vecchia_site,
                       lib.hmsc_vecchia_cg,
                       lib.hmsc_nngp_quad_grid,
                       lib.hmsc_nngp_quad_at, lib.hmsc_nngp_iw,
                       lib.hmsc_gpp_unit, lib.hmsc_gpp_knot,
                       lib.hmsc_gpp_quad_grid, lib.hmsc_gpp_quad_at,
                       lib.hmsc_truncnorm_da, lib.hmsc_serve_predict,
                       lib.hmsc_serve_quantile, lib.hmsc_serve_conditional,
                       lib.hmsc_mixed_gemm):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def stream_of(t):
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
