"""Crash-consistent file writes (``ray_lightning_tpu/utils/fsio.py``).

A reader, often a process that has just restarted, sees all of the
previous file or all of the new one, never a torn write: the data goes to
a temporary file in the same directory, which ``os.replace`` renames over
the target (atomic on POSIX within one filesystem). ``fsync=True`` also
makes the contents durable against a machine crash before the rename, for
ledgers whose write-before-act contract must hold across one; telemetry
summaries need only the rename.
"""
from __future__ import annotations

import json
import os
import tempfile
from contextlib import contextmanager
from typing import Any, Iterator, Optional


@contextmanager
def atomic_writer(path: str, mode: str = "wb", fsync: bool = False,
                  encoding: Optional[str] = None) -> Iterator[Any]:
    """A handle on a temporary file beside ``path``, renamed over ``path``
    on a clean exit and unlinked on an error. ``mkstemp`` names it, so two
    writers of one path never share a temporary file."""
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    f = (os.fdopen(fd, mode) if "b" in mode
         else os.fdopen(fd, mode, encoding=encoding or "utf-8"))
    try:
        yield f
        f.flush()
        if fsync:
            os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
    except BaseException:
        try:
            f.close()
        except OSError:
            pass
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_bytes(path: str, data: bytes, fsync: bool = False) -> None:
    with atomic_writer(path, "wb", fsync=fsync) as f:
        f.write(data)


def atomic_write_json(path: str, obj: Any, fsync: bool = False,
                      indent: Optional[int] = None, sort_keys: bool = False,
                      default: Any = None) -> None:
    with atomic_writer(path, "w", fsync=fsync) as f:
        json.dump(obj, f, indent=indent, sort_keys=sort_keys, default=default)
