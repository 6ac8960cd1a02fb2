"""Checkpoint file primitives the serving artifact needs (copied from
``hmsc_tpu/utils/checkpoint.py:189-195, 264-339``): the error classes, the
crc32 of a payload, the atomic durable write and the model-spec
fingerprint.  Checkpoint and resume of a run are ROADMAP A9."""

from __future__ import annotations

import hashlib
import os
import zlib

import numpy as np

__all__ = ["CheckpointError", "CheckpointCorruptError", "spec_fingerprint"]


class CheckpointError(RuntimeError):
    """Base class for checkpoint load/save failures."""


class CheckpointCorruptError(CheckpointError):
    """The file is unreadable or a payload failed its integrity checksum."""


def spec_fingerprint(spec) -> str:
    """sha256 of the (frozen, primitive-valued) ModelSpec repr."""
    return hashlib.sha256(repr(spec).encode()).hexdigest()


def _crc(a) -> str:
    # checksum over the buffer in place (no .tobytes() copy)
    buf = memoryview(np.ascontiguousarray(a)).cast("B")
    return f"{zlib.crc32(buf) & 0xFFFFFFFF:08x}"


def _fsync_dir(path: str) -> None:
    """fsync the containing directory so a completed rename is durable."""
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass                   # directory fsync unsupported (non-POSIX)


def _atomic_write(path: str, write_cb, fsync_dir: bool = True) -> None:
    """Serialise into a tmp file via ``write_cb(fileobj)``, fsync it,
    rename it over ``path`` and (by default) fsync the directory: a kill at
    any instant leaves the old file or the new one, never a torn mix."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_cb(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync_dir:
            _fsync_dir(path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
