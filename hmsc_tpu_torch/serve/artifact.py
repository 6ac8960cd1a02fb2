"""Compacted serving artifacts (port of ``hmsc_tpu/serve/artifact.py``): the
posterior re-shaped for serving, in the same on-disk format as the JAX
package's, so a posterior fitted by either package is served by the other.

``compact_posterior`` writes one ``param-<name>.npy`` per served parameter
(pooled ``(n_draws, ...)``, C-contiguous) and a ``serving.json`` manifest
(per-payload crc32, the model-spec fingerprint, and what the engine needs
to answer raw-X queries without the ``Hmsc`` object: family codes, Y
scaling, each level's unit names).  ``dtype="bfloat16"`` halves it: draws
are cast to bfloat16 rounding to nearest even (``torch.bfloat16``, as
``jnp.bfloat16`` rounds) and stored as their raw uint16 bit patterns; the
manifest records each parameter's largest absolute and relative cast error.

The spec fingerprint is the sha256 of the writing package's own spec repr
(the two packages' reprs differ); readers record it and check nothing
against it.  Run directories (``load_run_posterior``, ``resolve_run_epoch``)
need the append-layout checkpoint, ROADMAP A9.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..utils.checkpoint import (CheckpointCorruptError, CheckpointError,
                                _atomic_write, _crc, spec_fingerprint)

__all__ = ["compact_posterior", "load_artifact", "ServingArtifact",
           "ARTIFACT_VERSION", "load_run_posterior", "resolve_run_epoch"]

ARTIFACT_VERSION = 1
_MANIFEST_NAME = "serving.json"
_FORMAT = "hmsc_tpu-serving-artifact"


def _bf16_encode(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Round-to-nearest-even bfloat16 cast of a float32 array: the raw
    uint16 bit patterns and the float32 values they decode to."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    bits = t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return bits, _bf16_decode(bits)


def _bf16_decode(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns -> float32, with plain numpy."""
    return (np.asarray(bits, dtype=np.uint32) << 16).view(np.float32)


def compact_posterior(post, out_dir: str, *, thin: int = 1,
                      dtype: str = "float32", params=None) -> dict:
    """Write a serving artifact for a fitted posterior (the port's
    :class:`~hmsc_tpu_torch.post.Posterior`).

    ``params`` defaults to what the serving engine reads: Beta, sigma and
    every level's Eta and Lambda (and wRRR where recorded).  ``thin`` keeps
    every ``thin``-th recorded draw per chain before pooling.  ``dtype`` is
    ``"float32"`` (bit-exact) or ``"bfloat16"`` (half the bytes, the cast
    error recorded per parameter).  Returns the manifest written."""
    thin = int(thin)
    if thin < 1:
        raise ValueError(f"compact_posterior: thin must be >= 1, got {thin}")
    if dtype not in ("float32", "bfloat16"):
        raise ValueError("compact_posterior: dtype must be 'float32' or "
                         f"'bfloat16', got {dtype!r}")
    hM, spec = post.hM, post.spec
    if params is None:
        params = ["Beta", "sigma"]
        for r in range(spec.nr):
            params += [f"Eta_{r}", f"Lambda_{r}"]
        if "wRRR" in post.arrays:
            params.append("wRRR")
    missing = [p for p in params if p not in post.arrays]
    if missing:
        raise KeyError(
            f"compact_posterior: {missing} not recorded in this posterior "
            "(re-sample without the record= restriction, or drop them from "
            "params=)")

    os.makedirs(out_dir, exist_ok=True)
    entries = {}
    n_draws = None
    for name in params:
        a = np.ascontiguousarray(post.pooled(name, thin=thin))
        n_draws = a.shape[0] if n_draws is None else n_draws
        if a.shape[0] != n_draws:
            raise ValueError(
                f"compact_posterior: {name} carries {a.shape[0]} pooled "
                f"draws, expected {n_draws}")
        entry = {"shape": list(a.shape), "dtype": str(a.dtype)}
        if dtype == "bfloat16" and np.issubdtype(a.dtype, np.floating):
            a32 = np.asarray(a, dtype=np.float32)
            bits, back = _bf16_encode(a32)
            err = np.abs(back - a32)
            scale = np.maximum(np.abs(a32), 1e-30)
            entry.update(
                dtype="float32", stored_dtype="bfloat16_bits",
                cast={"max_abs_err": float(err.max(initial=0.0)),
                      "max_rel_err": float((err / scale).max(initial=0.0))})
            a = bits
        fname = f"param-{name}.npy"
        path = os.path.join(out_dir, fname)
        _atomic_write(path, lambda f, _a=a: np.lib.format.write_array(
            f, _a, allow_pickle=False))
        entry.update(file=fname, crc32=_crc(a),
                     nbytes=int(os.path.getsize(path)))
        entries[name] = entry

    m, s = hM.y_scale_par
    good = post.good_chain_mask()
    manifest = {
        "format": _FORMAT,
        "version": ARTIFACT_VERSION,
        "n_draws": int(n_draws or 0),
        "thin": thin,
        "dtype": dtype,
        "spec_sha256": spec_fingerprint(spec),
        "source": {"samples": int(post.samples),
                   "transient": int(post.transient),
                   "thin": int(post.thin),
                   "n_chains": int(post.n_chains),
                   "good_chains": int(good.sum())},
        "model": {"ns": int(hM.ns), "nc": int(hM.nc),
                  "nc_nrrr": int(hM.nc_nrrr), "nc_rrr": int(hM.nc_rrr),
                  "x_is_list": bool(hM.x_is_list),
                  "distr": [int(v) for v in hM.distr[:, 0]],
                  "y_scale_m": [float(v) for v in np.asarray(m)],
                  "y_scale_s": [float(v) for v in np.asarray(s)]},
        "levels": [{"name": hM.rl_names[r],
                    "units": [str(u) for u in hM.pi_names[r]],
                    "x_dim": int(spec.levels[r].x_dim),
                    "nf": int(spec.levels[r].nf_max)}
                   for r in range(spec.nr)],
        "params": entries,
    }
    _atomic_write(os.path.join(out_dir, _MANIFEST_NAME),
                  lambda f: f.write(json.dumps(manifest,
                                               sort_keys=True).encode()))
    return manifest


class ServingArtifact:
    """Read side of a compacted artifact: the manifest, and parameters
    materialised on first access (optionally memory-mapped).

    ``pooled(name)`` gives one float32 ``(n_draws, ...)`` array per
    parameter (bfloat16-stored ones decoded once and cached);
    ``stored(name)`` gives the parameter in its stored type, for staging:
    the float32 array, or a ``torch.bfloat16`` tensor of the raw bits."""

    def __init__(self, dirpath: str, *, mmap: bool = True,
                 verify: bool = True):
        self.dir = os.fspath(dirpath)
        mpath = os.path.join(self.dir, _MANIFEST_NAME)
        try:
            with open(mpath, "rb") as f:
                man = json.loads(f.read().decode())
        except (OSError, ValueError, UnicodeDecodeError) as e:
            raise CheckpointCorruptError(
                f"{mpath}: unreadable serving manifest "
                f"({type(e).__name__}: {e})") from e
        if not isinstance(man, dict) or man.get("format") != _FORMAT:
            raise CheckpointCorruptError(
                f"{mpath}: not an hmsc_tpu serving artifact")
        if int(man.get("version", 0)) > ARTIFACT_VERSION:
            raise CheckpointError(
                f"{mpath}: artifact version {man['version']} is newer than "
                f"this package reads (<= {ARTIFACT_VERSION})")
        self.meta = man
        self.n_draws = int(man["n_draws"])
        self._mmap = bool(mmap)
        self._verify = bool(verify)
        self._cache: dict = {}

    def __contains__(self, name: str) -> bool:
        return name in self.meta["params"]

    def params(self) -> list[str]:
        return list(self.meta["params"])

    def _entry(self, name):
        entry = self.meta["params"].get(name)
        if entry is None:
            raise KeyError(
                f"{name!r} is not in this serving artifact (has: "
                f"{sorted(self.meta['params'])}) — re-run compaction with "
                "params= including it")
        return entry

    def _load(self, name, entry, mmap):
        path = os.path.join(self.dir, entry["file"])
        try:
            a = np.load(path, allow_pickle=False,
                        mmap_mode="r" if mmap else None)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"{path}: unreadable artifact parameter "
                f"({type(e).__name__}: {e})") from e
        if self._verify:
            got = _crc(a)
            if got != entry["crc32"]:
                raise CheckpointCorruptError(
                    f"{path}: parameter {name!r} failed its integrity "
                    f"checksum (crc32 {got} != {entry['crc32']}) — the "
                    "artifact is corrupt; re-run compaction")
        if a.shape != tuple(entry["shape"]):
            raise CheckpointCorruptError(
                f"{path}: parameter {name!r} has shape {a.shape}, manifest "
                f"claims {tuple(entry['shape'])}")
        return a

    def pooled(self, name: str) -> np.ndarray:
        if name in self._cache:
            return self._cache[name]
        entry = self._entry(name)
        decode = entry.get("stored_dtype") == "bfloat16_bits"
        # decoding reads every byte anyway; mmap only helps raw float32
        a = self._load(name, entry, self._mmap and not decode)
        if decode:
            a = _bf16_decode(np.asarray(a))
        self._cache[name] = a
        return a

    def stored(self, name: str):
        """The parameter in its stored type: the float32 array (a memmap
        when mmap'd) or, for bfloat16 storage, a ``torch.bfloat16`` tensor
        of the raw bits (no float32 copy; the serving kernels widen it)."""
        entry = self._entry(name)
        if entry.get("stored_dtype") != "bfloat16_bits":
            return self.pooled(name)
        ck = ("stored", name)
        if ck not in self._cache:
            bits = np.array(self._load(name, entry, self._mmap),
                            dtype=np.uint16)
            self._cache[ck] = torch.from_numpy(bits.view(np.int16)).view(
                torch.bfloat16)
        return self._cache[ck]

    def cast_tolerance(self, name: str) -> dict | None:
        """The recorded bfloat16 cast error of a parameter (``None`` for
        bit-exact float32 storage)."""
        return self.meta["params"][name].get("cast")


def load_artifact(dirpath: str, *, mmap: bool = True,
                  verify: bool = True) -> ServingArtifact:
    """Open a compacted serving artifact directory."""
    return ServingArtifact(dirpath, mmap=mmap, verify=verify)


def resolve_run_epoch(run_dir: str, epoch: int | None = None):
    """Epoch selection in a run directory: needs the append-layout
    checkpoint, which the port does not have yet."""
    raise NotImplementedError(
        "serving from a run directory needs the append-layout checkpoint "
        "(ROADMAP A9); compact the posterior with compact_posterior and "
        "serve the artifact directory")


def load_run_posterior(run_dir: str, hM=None, *, mmap: bool = True,
                       epoch: int | None = None):
    """The posterior of a run directory: ROADMAP A9, see
    :func:`resolve_run_epoch`."""
    return resolve_run_epoch(run_dir, epoch)
