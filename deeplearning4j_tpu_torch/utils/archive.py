"""Archive extraction (util/ArchiveUtils.java, 161 LoC: unzip/untar/gunzip
with path traversal left to the JVM). Stdlib zipfile/tarfile/gzip, with
explicit zip-slip protection the reference lacked. Port of
``deeplearning4j_tpu/utils/archive.py``."""

from __future__ import annotations

import gzip
import os
import shutil
import tarfile
import zipfile


def _check_within(base: str, target: str) -> None:
    base = os.path.abspath(base)
    if os.path.commonpath([base, os.path.abspath(target)]) != base:
        raise ValueError(f"archive entry escapes destination: {target}")


def unzip_file_to(archive: str, dest_dir: str) -> None:
    """ArchiveUtils.unzipFileTo — dispatches on extension."""
    os.makedirs(dest_dir, exist_ok=True)
    if archive.endswith(".zip"):
        with zipfile.ZipFile(archive) as zf:
            for name in zf.namelist():
                _check_within(dest_dir, os.path.join(dest_dir, name))
            zf.extractall(dest_dir)
    elif archive.endswith((".tar.gz", ".tgz", ".tar")):
        mode = "r:gz" if archive.endswith(("gz", "tgz")) else "r"
        with tarfile.open(archive, mode) as tf:
            for member in tf.getmembers():
                _check_within(dest_dir, os.path.join(dest_dir, member.name))
            tf.extractall(dest_dir, filter="data")
    elif archive.endswith(".gz"):
        out = os.path.join(dest_dir,
                           os.path.basename(archive)[: -len(".gz")])
        with gzip.open(archive, "rb") as src, open(out, "wb") as dst:
            shutil.copyfileobj(src, dst)
    else:
        raise ValueError(f"unsupported archive type: {archive}")
