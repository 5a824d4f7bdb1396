"""Bucket views the port's checkpoints read and write: its own copies of
the reference's ``MountedBucket`` and ``DirBucket``
(``repro/data/objectstore.py``).

``MountedBucket`` wraps an object store service by duck typing: anything
with ``get``, ``put``, ``list`` and ``exists`` (the platform's in-memory
``ObjectStore`` reaches the learner as ``ctx.objstore``). The reference's
read-through block cache is not carried over: checkpoints are read once.
``DirBucket`` is the same interface over a local directory, the train CLI's
checkpoint target.
"""

from __future__ import annotations

import os


class MountedBucket:
    """Filesystem-like view of one bucket of an object store."""

    def __init__(self, store, bucket: str):
        self.store = store
        self.bucket = bucket

    def read(self, key: str) -> bytes:
        return self.store.get(self.bucket, key)

    def write(self, key: str, data: bytes):
        self.store.put(self.bucket, key, data)

    def listdir(self, prefix: str = "") -> list[str]:
        return self.store.list(self.bucket, prefix)

    def exists(self, key: str) -> bool:
        return self.store.exists(self.bucket, key)


class DirBucket:
    """MountedBucket-compatible view over a local directory. A write lands
    in a temporary file and is renamed into place, so a reader never sees
    half a blob."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    def read(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def write(self, key: str, data):
        if isinstance(data, str):
            data = data.encode()
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic publish

    def listdir(self, prefix: str = "") -> list:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix) and not rel.endswith(".tmp"):
                    out.append(rel)
        return sorted(out)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))
