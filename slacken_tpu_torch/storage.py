"""Storage abstraction: local filesystem + fsspec-backed remote URIs.

The reference talks to HDFS/S3/GCS through the Hadoop FileSystem API
(HDFSUtil.scala:31-156): every index/taxonomy/report path may be a remote
URI, which is what lets a multi-host cluster share one index. Here the same
role is played by fsspec — any path with a `scheme://` prefix (gs://, s3://,
memory://, ...) is routed through `fsspec.open`/`fsspec.filesystem`, plain
paths through the standard library. numpy arrays are (de)serialized through
file objects (`np.save`/`np.load` accept them), so remote .npy shards work
unchanged; local paths keep their mmap fast path.

fsspec is optional at import time: local-only deployments never touch it.
"""

from __future__ import annotations

import os
import posixpath
from typing import List, Optional

import numpy as np

_LOCAL_SCHEMES = ("file",)


def is_remote(path: str) -> bool:
    """True when `path` carries a non-local fsspec scheme (gs://, s3://...).

    Windows drive letters ("C:\\") and bare paths are local; `file://` is
    treated as local-equivalent but still routed through fsspec so the URI
    form works.
    """
    if "://" not in path:
        return False
    scheme = path.split("://", 1)[0]
    return len(scheme) > 1  # single letter = drive, not a scheme


def _fs(path: str):
    import fsspec

    return fsspec.core.url_to_fs(path)


def join(base: str, *parts: str) -> str:
    """Path join that preserves URI schemes (os.path.join would not)."""
    if is_remote(base):
        return posixpath.join(base, *parts)
    return os.path.join(base, *parts)


def exists(path: str) -> bool:
    if is_remote(path):
        fs, p = _fs(path)
        return fs.exists(p)
    return os.path.exists(path)


def makedirs(path: str) -> None:
    if is_remote(path):
        fs, p = _fs(path)
        fs.makedirs(p, exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)


def open_file(path: str, mode: str = "r", **kw):
    """Open a local path or remote URI. Text modes get utf-8 + replacement
    decoding to match the reference's lenient dmp reading."""
    if is_remote(path):
        import fsspec

        if "b" not in mode:
            kw.setdefault("encoding", "utf-8")
            kw.setdefault("errors", "replace")
        return fsspec.open(path, mode, **kw).open()
    if "b" not in mode:
        kw.setdefault("encoding", "utf-8")
        kw.setdefault("errors", "replace")
    return open(path, mode, **kw)


def np_save(path: str, arr: np.ndarray) -> None:
    if is_remote(path):
        with open_file(path, "wb") as f:
            np.save(f, np.asarray(arr))
    else:
        np.save(path, arr)


def np_load(path: str, mmap: bool = True) -> np.ndarray:
    """Load a .npy array; local paths memory-map (the hot path for large
    indexes), remote URIs stream the bytes."""
    if is_remote(path):
        with open_file(path, "rb") as f:
            return np.load(f)
    return np.load(path, mmap_mode="r" if mmap else None)


def listdir(path: str) -> List[str]:
    """Entry basenames under a directory/prefix (HDFSUtil.findFiles
    analogue)."""
    if is_remote(path):
        fs, p = _fs(path)
        return sorted(posixpath.basename(e.rstrip("/")) for e in fs.ls(p, detail=False))
    return sorted(os.listdir(path))


def find_files(path: str, suffix: str) -> List[str]:
    """Recursively find files with `suffix` under `path`, returned as full
    paths/URIs (HDFSUtil.scala:findFiles)."""
    if is_remote(path):
        fs, p = _fs(path)
        scheme = path.split("://", 1)[0]
        return sorted(
            f"{scheme}://{e}" for e in fs.find(p) if e.endswith(suffix)
        )
    out = []
    for root, _, files in os.walk(path):
        out += [os.path.join(root, f) for f in files if f.endswith(suffix)]
    return sorted(out)


def copy(src: str, dst: str, chunk: int = 1 << 22) -> None:
    """Byte copy across any (local|remote) x (local|remote) pair
    (HDFSUtil.copy analogue)."""
    with open_file(src, "rb") as fi, open_file(dst, "wb") as fo:
        while True:
            b = fi.read(chunk)
            if not b:
                break
            fo.write(b)


def delete_recursive(path: str) -> None:
    if is_remote(path):
        fs, p = _fs(path)
        if fs.exists(p):
            fs.rm(p, recursive=True)
    else:
        import shutil

        if os.path.exists(path):
            shutil.rmtree(path)


def mmap_ok(path: str) -> Optional[str]:
    """mmap mode usable for this path (None for remote)."""
    return None if is_remote(path) else "r"
