"""Process group and mesh construction (the reference's
``repro/launch/mesh.py``).

The port runs one process per device. ``init_process_group`` joins the
launcher's world where ``RANK``/``WORLD_SIZE`` are set (``torchrun``), or
else makes a world of one in this process; NCCL on the card, gloo on the
CPU. Importing this module touches no device and starts no group.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import (
    MULTI_POD_RULES,
    SINGLE_POD_RULES,
    AbstractMesh,
    MeshEnv,
    mesh_shape,
    zero1_rules,
)


# H100 SXM5 80GB data-sheet figures at its 700 W limit (NVIDIA's data sheet,
# dense rates): not measurements. The dry-run's roofline terms read them.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s a GPU, bf16 on the tensor cores
HBM_BW = 3.35e12              # bytes/s a GPU
NVLINK_BW = 450e9             # bytes/s a GPU each way, within one host of 8 GPUs
NET_BW = 50e9                 # bytes/s a GPU beyond 8: one 400 Gb/s port (DGX H100)
NVLINK_DOMAIN = 8             # GPUs a host joins by NVLink


def collective_bw(n_devices: int) -> float:
    """The bytes/s a GPU's collectives move at over a mesh of ``n_devices``:
    NVLink within one host of 8, the network beyond (the reference's single
    ``ICI_BW`` of a TPU's torus)."""
    return NVLINK_BW if n_devices <= NVLINK_DOMAIN else NET_BW


def init_process_group(device="cuda", init_method: str | None = None,
                       rank: int | None = None, world_size: int | None = None) -> int:
    """Join (or make) the default process group; returns its world size.

    A group already started is kept. Otherwise the rank and world size come
    from the arguments, then from ``RANK``/``WORLD_SIZE`` (a launcher's,
    with its ``env://`` rendezvous), else a world of one on an in-process
    store. ``init_method`` (e.g. ``file://`` of a fresh path) overrides the
    rendezvous. On the card each rank takes device ``LOCAL_RANK`` (or its
    rank)."""
    if dist.is_initialized():
        return dist.get_world_size()
    device = torch.device(device)
    if rank is None and "RANK" in os.environ:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if rank is None or (init_method is None and world_size == 1):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    return dist.get_world_size()


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:<current>`` on the card, else ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default group's ranks (its
    product must be the world size), its dims named ``axes``."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {n} processes, the world has "
                         f"{dist.get_world_size()}")
    # DTensor warns at each reduction over two mesh dims (the ZeRO-1
    # reduce-scatter over (data, model) is one); the schedule is the design
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


FAKE_WORLD = 512  # the largest production mesh: every dry-run mesh fits in it


def init_fake_process_group(world_size: int = FAKE_WORLD) -> int:
    """A fake process group of ``world_size`` ranks in this one process,
    this process rank 0: its collectives move nothing (the dry-run's, whose
    tensors are meta). ``torch.testing``'s fake backend, imported here, so
    that nothing else loads it. A fake group already started is kept (one
    group for the process's life: DTensor caches plans by mesh shape, and a
    replaced group would leave them naming its dead subgroups); a real one
    raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is running; the "
                               "dry-run's fake group needs a process of its own")
        return dist.get_world_size()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    return dist.get_world_size()


def make_fake_mesh(shape, axes):
    """A ``DeviceMesh`` over the first prod(shape) ranks of the fake world
    (``init_fake_process_group``, started here where it is not), its dims
    named ``axes``, of device type cuda (the card's collectives, e.g. its
    all-to-all, where a CPU mesh would fall back to all-gathers): the
    dry-run's meshes, this process their rank 0."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for d in shape:
        n *= d
    if init_fake_process_group() < n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the fake world has "
                         f"{dist.get_world_size()}")
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    return DeviceMesh("cuda", torch.arange(n).reshape(tuple(shape)), mesh_dim_names=tuple(axes))


PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production meshes over a real world of 256 or 512
    processes: 16x16 (data, model) or 2x16x16 (pod, data, model). The
    dry-run builds the same shapes over its fake world (``make_fake_mesh``
    of ``PRODUCTION_MESHES``)."""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    return make_mesh(shape, axes, device)


def make_test_mesh(data: int = 2, model: int = 2, device="cpu"):
    """A (data, model) mesh for the CPU integration tests (a world of
    data*model processes)."""
    return make_mesh((data, model), ("data", "model"), device)


def make_env(mesh, overrides: dict | None = None) -> MeshEnv:
    """MeshEnv with the right rules for this mesh (+ overrides). ``mesh`` is
    a ``DeviceMesh`` or an ``AbstractMesh`` (spec derivation only)."""
    rules = MULTI_POD_RULES if "pod" in mesh_shape(mesh) else SINGLE_POD_RULES
    rules = zero1_rules(rules)
    if overrides:
        rules = dict(rules, **overrides)
    return MeshEnv(mesh=mesh, rules=rules)


def mesh_env(spec: str, device, overrides: dict | None = None):
    """(env, device) of a ``--mesh`` option: a null env and ``device`` for a
    single number; else a (data, model) mesh over the process group
    (started here where it is not), its rules with ``overrides``, and this
    rank's device. Exits with the reference's message where the mesh does
    not match the world size."""
    shape = parse_mesh(spec)
    if shape is None:
        return MeshEnv(mesh=None), device
    if len(shape) != 2:
        raise SystemExit("--mesh must be DxM (e.g. 2x2)")
    need = shape[0] * shape[1]
    world = init_process_group(device)
    if world != need:
        raise SystemExit(f"mesh {spec} needs {need} devices, have {world} "
                         f"(launch with torchrun --nproc-per-node {need})")
    device = local_device(device)
    return make_env(make_mesh(shape, ("data", "model"), device), overrides), device


def parse_mesh(spec: str):
    """``"DxM"`` → (D, M); a single number → None (one device, no mesh)."""
    parts = [int(x) for x in spec.split("x")]
    if len(parts) == 1:
        return None
    return tuple(parts)


__all__ = ["AbstractMesh", "HBM_BW", "NET_BW", "NVLINK_BW", "PEAK_FLOPS_BF16",
           "collective_bw", "init_fake_process_group", "init_process_group", "make_fake_mesh",
           "local_device", "make_env", "make_mesh", "make_production_mesh",
           "make_test_mesh", "mesh_env", "parse_mesh"]
