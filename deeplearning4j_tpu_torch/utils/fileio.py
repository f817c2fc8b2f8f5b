"""Atomic file publication shared by the coordination modules (statetracker,
config registry): write to a tempfile on the same filesystem, then
``os.replace`` — readers never observe partial content."""

from __future__ import annotations

import os
import tempfile
from typing import Optional


def atomic_write_text(path: str, data: str,
                      tmp_dir: Optional[str] = None,
                      durable: bool = True) -> None:
    """Write ``data`` to ``path`` atomically. ``tmp_dir`` (default: the
    target's directory) must be on the same filesystem as ``path``.

    ``durable=True`` fsyncs the tempfile before the rename so a crash
    right after publication cannot leave the *new name* pointing at
    zero-length/partial content (rename is atomic in the namespace, not
    in the data journal); the containing directory is fsynced best-effort
    so the rename itself survives too.
    """
    # bare filenames: dirname() == "" and mkstemp(dir="") fails — stage in
    # the CWD the target resolves against
    fd, tmp = tempfile.mkstemp(dir=tmp_dir or os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if durable:
            _fsync_dir(os.path.dirname(path) or ".")
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def atomic_write_bytes(path: str, writer,
                       tmp_dir: Optional[str] = None,
                       durable: bool = True) -> None:
    """Binary twin of :func:`atomic_write_text`: ``writer(fileobj)``
    produces the content (streaming downloads, ``np.save``, …) into a
    tempfile which is then published with ``os.replace``. Same durability
    contract (fsync-before-rename when ``durable``); the tempfile is
    removed on any failure."""
    fd, tmp = tempfile.mkstemp(dir=tmp_dir or os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            writer(f)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if durable:
            _fsync_dir(os.path.dirname(path) or ".")
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _fsync_dir(dirname: str) -> None:
    """Persist a directory entry (rename/creat) — best-effort: some
    filesystems (and platforms) refuse O_RDONLY fsync on directories."""
    try:
        dfd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)
