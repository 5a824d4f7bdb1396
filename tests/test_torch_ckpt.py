"""The port's checkpoints (repro_torch.ckpt) against the JAX package's on the
CPU: the msgpack codec byte for byte, a whole train state across packages
in both directions bit for bit, byte-identical blobs and manifests under
zlib, and recovery's skipping of partial and corrupt checkpoints."""

import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_tiny_config as jget_tiny
from repro.data.objectstore import MountedBucket as JMountedBucket
from repro.data.objectstore import ObjectStore
from repro.models import steps as jsteps
from repro.utils.trees import tree_flatten_with_paths as jflatten

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_tiny_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.objectstore import DirBucket, MountedBucket
from repro_torch.models import steps
from repro_torch.utils.trees import tree_flatten_with_paths

ARCH = "smollm-360m"


@pytest.fixture
def bucket():
    store = ObjectStore()
    store.create_bucket("b")
    return MountedBucket(store, "b")


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bf16 as its uint16 words)."""
    t = t.detach().contiguous()
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()


def _jnp_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# --------------------------------------------------------------------------
# the msgpack codec
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [[], [3], [300, 70000], list(range(1, 18)), [2 ** 33]])
@pytest.mark.parametrize("n_bytes", [0, 5, 255, 256, 70000])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int32"])
def test_msgpack_codec_is_msgpacks_byte_for_byte(shape, n_bytes, dtype):
    """The leaf map packs to msgpack.packb's bytes (fixmap, fixstr, fix and
    16-bit arrays, unsigned ints of every width, bin 8/16/32), in the
    reference's key order, and unpacks to what msgpack.unpackb gives."""
    payload = {"dtype": dtype, "shape": shape,
               "data": np.random.default_rng(n_bytes).bytes(n_bytes)}
    packed = ckpt.packb(payload)
    assert packed == msgpack.packb(payload)
    assert ckpt.unpackb(packed) == msgpack.unpackb(packed) == payload


def test_msgpack_codec_rejects_what_checkpoints_do_not_use():
    with pytest.raises(ckpt.CheckpointError):
        ckpt.unpackb(msgpack.packb({"x": -1.5}))
    with pytest.raises(ckpt.CheckpointError):
        ckpt.unpackb(msgpack.packb({"x": 1}) + b"\x00")
    with pytest.raises(ckpt.CheckpointError):
        ckpt.packb({"x": -3})


# --------------------------------------------------------------------------
# across packages
# --------------------------------------------------------------------------

def _jax_state(seed=0, steps_taken=0):
    jcfg = jget_tiny(ARCH)
    state = jsteps.init_train_state(jcfg, jax.random.key(seed))
    # every leaf distinct from its init: m, v and master nonzero, the step 7
    leaves = jax.tree.map(lambda x: x, state)
    rng = np.random.default_rng(seed)
    opt = jax.tree.map(lambda x: x + jnp.asarray(rng.standard_normal(x.shape), x.dtype),
                       leaves.opt)
    return jsteps.TrainState(jnp.int32(7 + steps_taken), leaves.params, opt)


def test_reference_train_state_restores_in_the_port_bit_for_bit(bucket):
    """Whatever codec the reference wrote (zstd where zstandard imports,
    else zlib)."""
    jstate = _jax_state()
    jckpt.save(bucket, "ck", 7, jstate, {"loss": 1.25})
    assert ckpt.latest_step(bucket, "ck") == 7
    flat, meta = ckpt.restore(bucket, "ck", 7)
    assert meta == {"loss": 1.25}
    want = dict(jflatten(jstate))
    assert set(flat) == set(want)
    for path, t in flat.items():
        w = np.asarray(want[path])
        assert tuple(t.shape) == w.shape and str(t.dtype).split(".")[-1] == str(w.dtype), path
        np.testing.assert_array_equal(_np(t), _jnp_bits(w), err_msg=path)
    state = train_state_from_numpy(flat, get_tiny_config(ARCH), "cpu")
    assert state.step.dtype == torch.int32 and state.step.shape == () and int(state.step) == 7
    assert state.params["embed"].dtype == torch.bfloat16
    assert state.opt.master["embed"].dtype == torch.float32


def test_port_train_state_restores_in_the_reference_bit_for_bit(bucket):
    cfg = get_tiny_config(ARCH)
    state = steps.init_train_state(cfg, 3)
    state = steps.TrainState(torch.tensor(11, dtype=torch.int32), state.params,
                             state.opt._replace(m=state.opt.master))
    ckpt.save(bucket, "ck", 11, state, {"loss": 2.5})
    assert jckpt.latest_step(bucket, "ck") == 11
    like = jsteps.abstract_train_state(jget_tiny(ARCH))
    restored, meta = jckpt.restore(bucket, "ck", 11, like=like)
    assert meta == {"loss": 2.5}
    got = dict(jflatten(restored))
    for path, t in tree_flatten_with_paths(state):
        g = np.asarray(got[path])
        assert g.shape == tuple(t.shape) and str(g.dtype) == str(t.dtype).split(".")[-1], path
        np.testing.assert_array_equal(_jnp_bits(g), _np(t), err_msg=path)


def test_same_tree_gives_byte_identical_blobs_and_manifests(bucket, monkeypatch):
    """Under zlib (what the reference writes where zstandard is absent, and
    what the port always writes) the port's checkpoint of a tree is the
    reference's, byte for byte."""
    monkeypatch.setattr(jckpt, "zstandard", None)
    jstate = _jax_state(seed=1)
    jckpt.save(bucket, "ref", 7, jstate, {"loss": 0.5})
    flat, _ = ckpt.restore(bucket, "ref", 7)
    state = train_state_from_numpy(flat, get_tiny_config(ARCH), "cpu")
    ckpt.save(bucket, "port", 7, state, {"loss": 0.5})
    ref_keys = bucket.listdir("ref/")
    assert [k[len("ref/"):] for k in ref_keys] == \
        [k[len("port/"):] for k in bucket.listdir("port/")]
    for key in ref_keys:
        mine = bucket.read("port/" + key[len("ref/"):])
        theirs = bucket.read(key)
        if key.endswith("MANIFEST.json"):
            theirs = theirs.replace(b'"ref/step_', b'"port/step_')
        assert mine == theirs, key
    manifest = json.loads(bucket.read("port/step_00000007/MANIFEST.json"))
    assert list(manifest) == ["step", "leaves", "metadata"]


def test_port_roundtrip_keeps_dtypes_shapes_and_bits(bucket):
    tree = {"w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
            "nested": {"b": torch.ones(5), "step": torch.tensor(7, dtype=torch.int32),
                       "h": torch.full((2,), 0.1, dtype=torch.float16)},
            "empty": torch.zeros((0, 3))}
    ckpt.save(bucket, "ck", 3, tree, {"loss": 1.5})
    restored, meta = ckpt.restore(bucket, "ck", 3)
    assert meta == {"loss": 1.5}
    want = dict(tree_flatten_with_paths(tree))
    assert set(restored) == set(want)
    for path, t in restored.items():
        assert t.dtype == want[path].dtype and t.shape == want[path].shape, path
        assert torch.equal(t, want[path]), path
    with pytest.raises(ckpt.CheckpointError, match="float64"):
        ckpt.save(bucket, "ck", 4, {"x": torch.zeros(2, dtype=torch.float64)})


# --------------------------------------------------------------------------
# recovery's view: partial and corrupt checkpoints
# --------------------------------------------------------------------------

def test_latest_skips_partial_checkpoint(bucket):
    tree = {"w": torch.ones(4)}
    ckpt.save(bucket, "ck", 10, tree)
    ckpt.save(bucket, "ck", 20, tree)
    # a crash mid-save of step 30: blobs but no manifest
    bucket.write("ck/step_00000030/leaf/w", b"garbage")
    assert ckpt.steps_available(bucket, "ck") == [10, 20, 30]
    assert ckpt.latest_step(bucket, "ck") == 20


def test_latest_skips_corrupt_checkpoint(bucket):
    tree = {"w": torch.ones(4)}
    ckpt.save(bucket, "ck", 10, tree)
    base = ckpt.save(bucket, "ck", 20, tree)
    bucket.store.put("b", f"{base}/leaf/w", b"\x01corrupt")  # checksum now fails
    assert not ckpt.is_valid(bucket, "ck", 20)
    assert ckpt.latest_step(bucket, "ck") == 10
    with pytest.raises(ckpt.CheckpointError, match="checksum"):
        ckpt.restore(bucket, "ck", 20)


def test_zstd_blob_without_zstandard_raises_checkpoint_error(bucket, monkeypatch):
    monkeypatch.setattr(ckpt, "zstandard", None)
    with pytest.raises(ckpt.CheckpointError, match="zstandard"):
        ckpt._decode_leaf(b"\x02" + b"\x28\xb5\x2f\xfd" + b"\x00" * 8)


def test_async_checkpointer_keeps_order_and_prune_keeps_newest(tmp_path):
    store = ObjectStore()
    store.create_bucket("b")
    bucket = MountedBucket(store, "b")
    acp = ckpt.AsyncCheckpointer(bucket, "ck")
    w = torch.zeros(4)
    for step in (1, 2, 3, 4):
        w += 1  # the snapshot is taken at save time
        acp.save(step, {"w": w})
    acp.wait()
    assert acp.saved_steps == [1, 2, 3, 4]
    flat, _ = ckpt.restore(bucket, "ck", 2)
    assert torch.equal(flat["w"], torch.full((4,), 2.0))
    ckpt.prune_old(bucket, "ck", keep=2)
    assert ckpt.steps_available(bucket, "ck") == [3, 4]
    # the same interface over a directory, readable by the reference
    local = DirBucket(str(tmp_path))
    ckpt.save(local, "ck", 5, {"w": w})
    assert jckpt.latest_step(local, "ck") == 5
    assert ckpt.latest_step(JMountedBucket(store, "b"), "ck") == 4
