"""Checkpoints to an object store in the reference's layout
(``repro/ckpt/checkpoint.py``), so that a checkpoint written by either
package restores in the other.

Layout per checkpoint ``<prefix>/step_%08d/``:
  * one blob per tree leaf (``leaf/<path>``): a one-byte codec tag (zlib
    ``\\x01``, zstd ``\\x02``) and the compressed msgpack map
    ``{"dtype": str, "shape": [int, ...], "data": bin}`` of the leaf's raw
    little-endian bytes. bf16 travels as dtype ``"bfloat16"`` with its raw
    16-bit words; the step is a 0-d ``int32`` with ``shape: []``;
  * ``MANIFEST.json`` with each blob's key, sha256 and size, written
    **last**: a checkpoint whose manifest is missing (the writer crashed
    mid-save) or whose blobs fail their checksums is invalid and skipped.

The port writes zlib at level 1, the reference's codec where ``zstandard``
is absent: the same tree then gives byte-identical blobs and manifests in
both packages. It reads zstd blobs where ``zstandard`` imports and raises
``CheckpointError`` otherwise. The msgpack map is written and read by a
small codec of the port's own (the port needs nothing beyond torch, numpy
and the standard library): the subset that map needs, with the
reference's key order.

A tree of DTensors (a train state on a mesh) is saved whole: every rank
gathers each leaf (``full_tensor()``, a collective, on the calling
thread), rank 0 writes, and the others wait at a barrier. So a checkpoint
written from any mesh has the paths, dtypes and shapes of an unsharded
one, and ``restore(like=, shardings=)`` places it on any mesh, or none.
"""

from __future__ import annotations

import hashlib
import json
import struct
import threading
import zlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.launch.mesh import local_device
from repro_torch.parallel.sharding import place
from repro_torch.utils.trees import tree_flatten_with_paths, tree_map_with_path

try:
    import zstandard
except ImportError:  # zlib is the codec the port writes; zstd blobs need the module
    zstandard = None

_TAG_ZLIB = b"\x01"
_TAG_ZSTD = b"\x02"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"  # the reference's legacy untagged frames

# the dtypes of a train state's leaves (and fp16, which the reference's
# checkpoints also carry)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32}
_NAMES = {v: k for k, v in _DTYPES.items()}


class CheckpointError(Exception):
    pass


# --------------------------------------------------------------------------
# msgpack: the subset of the format that a leaf's map uses
# --------------------------------------------------------------------------

def _pack_len(n: int, small_tag: int, small_max: int, tags: tuple) -> bytes:
    """A header for a length: the fix form below ``small_max`` (when the
    type has one), else the 8-, 16- or 32-bit form (tags for each, None
    where the type has no such form)."""
    if small_tag is not None and n < small_max:
        return bytes([small_tag | n])
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise CheckpointError(f"msgpack: length {n} too large")


def _pack(obj) -> bytes:
    if isinstance(obj, dict):
        return _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF)) + b"".join(
            _pack(k) + _pack(v) for k, v in obj.items())
    if isinstance(obj, str):
        raw = obj.encode()
        return _pack_len(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(obj, (bytes, bytearray)):
        return _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + bytes(obj)
    if isinstance(obj, list):
        return _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD)) + b"".join(map(_pack, obj))
    if isinstance(obj, int) and obj >= 0:
        if obj < 0x80:
            return bytes([obj])
        for tag, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if obj < limit:
                return bytes([tag]) + struct.pack(fmt, obj)
    raise CheckpointError(f"msgpack: cannot pack {type(obj).__name__} {obj!r:.40}")


_LEN_FORMS = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
              0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
              0xDC: (">H", "array"), 0xDD: (">I", "array"),
              0xDE: (">H", "map"), 0xDF: (">I", "map")}
_UINTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}


def _unpack(buf: bytes, pos: int = 0):
    """(object, next position) of the msgpack value at ``pos``."""
    if pos >= len(buf):
        raise CheckpointError("msgpack: truncated payload")
    tag = buf[pos]
    pos += 1
    if tag < 0x80:
        return tag, pos
    if tag in _UINTS:
        fmt = _UINTS[tag]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif tag in _LEN_FORMS:
        fmt, kind = _LEN_FORMS[tag]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
    else:
        raise CheckpointError(f"msgpack: type byte 0x{tag:02x} is not used by checkpoints")
    if kind in ("str", "bin"):
        if pos + n > len(buf):
            raise CheckpointError("msgpack: truncated payload")
        raw = buf[pos:pos + n]
        return (raw.decode() if kind == "str" else bytes(raw)), pos + n
    if kind == "array":
        out = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            out.append(item)
        return out, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        out[key], pos = _unpack(buf, pos)
    return out, pos


def packb(obj) -> bytes:
    """msgpack bytes of a leaf map (dict, str, bytes, list, unsigned int),
    as ``msgpack.packb`` gives them."""
    return _pack(obj)


def unpackb(buf: bytes):
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise CheckpointError("msgpack: trailing bytes after the payload")
    return obj


# --------------------------------------------------------------------------
# leaves
# --------------------------------------------------------------------------

def _compress(payload: bytes) -> bytes:
    return _TAG_ZLIB + zlib.compress(payload, 1)


def _decompress(blob: bytes) -> bytes:
    tag = blob[:1]
    if tag == _TAG_ZSTD or blob[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise CheckpointError(
                "checkpoint blob is zstd-compressed but the zstandard module is "
                "not installed; the port writes zlib")
        body = blob[1:] if tag == _TAG_ZSTD else blob
        return zstandard.ZstdDecompressor().decompress(body)
    body = blob[1:] if tag == _TAG_ZLIB else blob
    return zlib.decompress(body)


def _leaf_bytes(leaf) -> tuple[str, list, bytes]:
    """(dtype name, shape, raw bytes) of a tensor or numpy array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise CheckpointError(f"cannot checkpoint dtype {t.dtype}")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        return _NAMES[t.dtype], list(t.shape), raw
    arr = np.ascontiguousarray(leaf)
    return str(arr.dtype), list(arr.shape), arr.tobytes()


def _encode_leaf(leaf) -> bytes:
    dtype, shape, raw = _leaf_bytes(leaf)
    return _compress(packb({"dtype": dtype, "shape": shape, "data": raw}))


def _decode_leaf(blob: bytes) -> torch.Tensor:
    payload = unpackb(_decompress(blob))
    dtype = _DTYPES.get(payload["dtype"])
    if dtype is None:
        raise CheckpointError(f"checkpoint leaf of dtype {payload['dtype']!r} is not supported")
    shape = tuple(payload["shape"])
    data = payload["data"]
    if not data:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(data), dtype=dtype).reshape(shape)


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _sharded(tree) -> bool:
    return any(isinstance(t, DTensor) for _, t in tree_flatten_with_paths(tree))


def _host(tree):
    """The writer's copy of ``tree``, each leaf whole on the host; None on
    the other ranks. DTensor leaves are gathered one at a time (every rank
    of their mesh must call this, on its main thread): a rank that does not
    write drops each gathered leaf at once. So a save holds one whole leaf
    at a time on each card, and the whole tree in host memory on rank 0
    alone."""
    keep = _writer()

    def one(_, t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if not keep:
            return None
        return t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor) else t
    host = tree_map_with_path(one, tree)
    return host if keep else None


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def save(bucket, prefix: str, step: int, tree, metadata: Optional[dict] = None):
    """Synchronous checkpoint save. ``bucket`` is a MountedBucket-like. A
    tree of DTensors is gathered leaf by leaf on every rank and written by
    rank 0, whose host memory alone holds the whole tree (``_host``); every
    rank returns after the write (a barrier)."""
    base = f"{prefix}/step_{step:08d}"
    if _sharded(tree):
        host = _host(tree)
        if host is not None:
            save(bucket, prefix, step, host, metadata)
        dist.barrier()
        return base
    manifest = {"step": step, "leaves": {}, "metadata": metadata or {}}
    for path, leaf in tree_flatten_with_paths(tree):
        blob = _encode_leaf(leaf)
        key = f"{base}/leaf/{path}"
        bucket.write(key, blob)
        manifest["leaves"][path] = {"key": key, "sha256": _sha(blob), "bytes": len(blob)}
    # Commit marker LAST: an interrupted save leaves no manifest → invalid.
    bucket.write(f"{base}/MANIFEST.json", json.dumps(manifest).encode())
    return base


def is_valid(bucket, prefix: str, step: int, verify_data: bool = True) -> bool:
    base = f"{prefix}/step_{step:08d}"
    if not bucket.exists(f"{base}/MANIFEST.json"):
        return False
    # A manifest or blob that cannot be read or parsed, whatever the store
    # raises, makes the checkpoint invalid: recovery moves on to an older one.
    try:
        manifest = json.loads(bucket.read(f"{base}/MANIFEST.json"))
        for info in manifest["leaves"].values():
            if not bucket.exists(info["key"]):
                return False
            if verify_data and _sha(bucket.read(info["key"])) != info["sha256"]:
                return False
    except Exception:
        return False
    return True


def steps_available(bucket, prefix: str) -> list[int]:
    steps = set()
    for key in bucket.listdir(prefix + "/"):
        tail = key[len(prefix) + 1:]
        if tail.startswith("step_") and "/" in tail:
            name = tail.split("/")[0][5:]
            if name.isdigit():
                steps.add(int(name))
    return sorted(steps)


def latest_step(bucket, prefix: str, verify_data: bool = True) -> Optional[int]:
    """Newest *valid* checkpoint step (corrupt/partial ones are skipped)."""
    for step in reversed(steps_available(bucket, prefix)):
        if is_valid(bucket, prefix, step, verify_data=verify_data):
            return step
    return None


def restore(bucket, prefix: str, step: int, like=None, shardings=None):
    """Load a checkpoint: ({path: CPU tensor}, metadata). A train state is
    rebuilt from it, its paths, shapes and dtypes checked, by
    ``repro_torch.convert.train_state_from_numpy``.

    With ``like`` (a tree of tensors or ``params.ShapeDtype``; e.g.
    ``steps.abstract_train_state``) the tree comes back in its structure,
    each leaf checked against its shape and dtype; with ``shardings`` (a
    same-structured tree of ``NamedSharding``, or None for a leaf to keep
    whole) each leaf is placed on its mesh, on this rank's device, which
    may be another mesh than the one that saved."""
    base = f"{prefix}/step_{step:08d}"
    if not bucket.exists(f"{base}/MANIFEST.json"):
        raise CheckpointError(f"no manifest for {base}")
    manifest = json.loads(bucket.read(f"{base}/MANIFEST.json"))
    by_path = {}
    for path, info in manifest["leaves"].items():
        blob = bucket.read(info["key"])
        if _sha(blob) != info["sha256"]:
            raise CheckpointError(f"checksum mismatch for {path}")
        by_path[path] = _decode_leaf(blob)
    if like is None:
        return by_path, manifest["metadata"]
    missing = [p for p, _ in tree_flatten_with_paths(like) if p not in by_path]
    if missing:
        raise CheckpointError(f"checkpoint missing leaves: {missing[:5]}")
    by_sharding = dict(tree_flatten_with_paths(shardings)) if shardings is not None else {}

    def one(path, want):
        t = by_path[path]
        if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
            raise CheckpointError(f"{path}: checkpoint has {tuple(t.shape)} {t.dtype}, "
                                  f"want {tuple(want.shape)} {want.dtype}")
        sh = by_sharding.get(path)
        if sh is None:
            return t
        return place(t.to(local_device(sh.mesh.device_type)), sh)

    return tree_map_with_path(one, like), manifest["metadata"]


class AsyncCheckpointer:
    """Saves on a background thread, one in flight at a time (a new save
    waits for the previous, which keeps the steps in order). A failed save
    raises at the next ``save`` or ``wait``."""

    def __init__(self, bucket, prefix: str):
        self.bucket = bucket
        self.prefix = prefix
        self._thread: Optional[threading.Thread] = None
        self._barrier = False  # a sharded save in flight: wait() ends at a barrier
        self.error: Optional[Exception] = None
        self.saved_steps: list[int] = []

    def save(self, step: int, tree, metadata: Optional[dict] = None):
        """A tree of DTensors is gathered here, on the calling thread (a
        collective on every rank); only rank 0 keeps a host copy, and its
        thread writes it, issuing no collective."""
        self.wait()
        # Snapshot to host memory now, so training may go on updating the
        # device tensors while the writes run.
        self._barrier = _sharded(tree)
        host_tree = _host(tree)
        if host_tree is None:
            return

        def run():
            try:
                save(self.bucket, self.prefix, step, host_tree, metadata)
                self.saved_steps.append(step)
            except Exception as e:  # raised in the caller's thread by wait()
                self.error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:  # every rank returns once rank 0's write is done
            self._barrier = False
            dist.barrier()
        if self.error is not None:
            err, self.error = self.error, None
            raise err


def prune_old(bucket, prefix: str, keep: int = 3):
    """Delete all but the newest ``keep`` checkpoints (a MountedBucket's)."""
    steps = steps_available(bucket, prefix)
    for step in steps[:-keep] if keep else steps:
        base = f"{prefix}/step_{step:08d}"
        for key in bucket.listdir(base):
            bucket.store.delete(bucket.bucket, key)
