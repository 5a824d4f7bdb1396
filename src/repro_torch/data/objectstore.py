"""The object store, its block cache and the bucket views the port's jobs
read and write: its own copies of the reference's ``ObjectStore``,
``StoreStats``, ``ObjectStoreError``, ``BlockCache``, ``MountedBucket`` and
``DirBucket`` (``repro/data/objectstore.py``).

``ObjectStore`` models the remote service (FfDL C8): buckets of immutable
blobs with GET/PUT/LIST and per-operation byte accounting, a chaos hook
and the fault plane's interposition points. The platform owns one; it
reaches the learner as ``ctx.objstore``. ``MountedBucket`` is the mounted
view of one bucket over an object store service, by duck typing: anything
with ``get``, ``put``, ``list`` and ``exists``. Given a ``BlockCache`` it
reads through it: an LRU of blobs keyed by (bucket, key) and shared across
epochs and jobs (FfDL §3.7, §4), its hits and misses counted in the store's
``StoreStats``. ``DirBucket`` is the same interface over a local directory,
the train CLI's checkpoint target.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional


class ObjectStoreError(Exception):
    pass


@dataclass
class StoreStats:
    gets: int = 0
    puts: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    cache_hits: int = 0
    cache_misses: int = 0


class ObjectStore:
    """In-process object storage service: buckets → key → immutable bytes.

    ``bandwidth_bps`` (optional) models the shared network/storage pipe: each
    transfer asks the clock for ``size / bandwidth`` seconds, which the scale
    benchmark aggregates to reproduce heavy-load degradation.
    """

    def __init__(self, clock=None, bandwidth_bps: Optional[float] = None):
        self._buckets: dict[str, dict[str, bytes]] = {}
        self._lock = threading.RLock()
        self.stats = StoreStats()
        self.clock = clock
        self.bandwidth_bps = bandwidth_bps
        self.fail_next: int = 0  # chaos hook: fail the next N operations
        # gray-failure interposition (objstore.get / objstore.put): wired
        # by the owning platform to the shared FaultPlane
        self.faults = None
        self.fault_key = None

    def _maybe_fail(self, op: str):
        if self.fail_next > 0:
            self.fail_next -= 1
            raise ObjectStoreError(f"injected object-store fault during {op}")
        if self.faults is not None:
            self.faults.on(f"objstore.{op}", key=self.fault_key,
                           exc=ObjectStoreError)

    def _charge(self, nbytes: int):
        if self.clock is not None and self.bandwidth_bps:
            self.clock.advance(nbytes / self.bandwidth_bps)

    def create_bucket(self, name: str):
        with self._lock:
            self._buckets.setdefault(name, {})

    def put(self, bucket: str, key: str, data):
        self._maybe_fail("put")
        if isinstance(data, str):
            data = data.encode()
        with self._lock:
            self._buckets.setdefault(bucket, {})[key] = bytes(data)
            self.stats.puts += 1
            self.stats.bytes_written += len(data)
        self._charge(len(data))

    def get(self, bucket: str, key: str) -> bytes:
        self._maybe_fail("get")
        with self._lock:
            try:
                data = self._buckets[bucket][key]
            except KeyError:
                raise ObjectStoreError(f"no such object {bucket}/{key}")
            self.stats.gets += 1
            self.stats.bytes_read += len(data)
        self._charge(len(data))
        return data

    def delete(self, bucket: str, key: str):
        with self._lock:
            self._buckets.get(bucket, {}).pop(key, None)

    def list(self, bucket: str, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._buckets.get(bucket, {})
                          if k.startswith(prefix))

    def exists(self, bucket: str, key: str) -> bool:
        with self._lock:
            return key in self._buckets.get(bucket, {})


class BlockCache:
    """LRU byte-block cache shared across MountedBucket instances.

    Keyed by (bucket, key) — "the same datasets are often used across jobs,
    and an intelligent caching layer tuned to DL access patterns could have
    significant cost and performance improvements" (FfDL §4).
    """

    def __init__(self, capacity_bytes: int = 1 << 30):
        self.capacity = capacity_bytes
        self._lru: OrderedDict[tuple, bytes] = OrderedDict()
        self._size = 0
        self._lock = threading.Lock()

    def get(self, k):
        with self._lock:
            if k in self._lru:
                self._lru.move_to_end(k)
                return self._lru[k]
        return None

    def put(self, k, data: bytes):
        with self._lock:
            if k in self._lru:
                return
            self._lru[k] = data
            self._size += len(data)
            while self._size > self.capacity and self._lru:
                _, evicted = self._lru.popitem(last=False)
                self._size -= len(evicted)


class MountedBucket:
    """Filesystem-like view of one bucket of an object store, reading
    through ``cache`` where one is given."""

    def __init__(self, store, bucket: str, cache: Optional[BlockCache] = None):
        self.store = store
        self.bucket = bucket
        self.cache = cache

    def read(self, key: str) -> bytes:
        ck = (self.bucket, key)
        if self.cache is not None:
            hit = self.cache.get(ck)
            if hit is not None:
                self.store.stats.cache_hits += 1
                return hit
            self.store.stats.cache_misses += 1
        data = self.store.get(self.bucket, key)
        if self.cache is not None:
            self.cache.put(ck, data)
        return data

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
