"""Per-rank cost of one call of a step function: FLOPs, bytes, collective
bytes and peak live bytes (the reference's ``repro/launch/hlo_cost.py``).

The reference reads its roofline inputs from XLA's compiled HLO. The port
has no HLO: eager PyTorch runs each ATen op as a kernel of its own. So this
module counts what executes, with a dispatch mode (:class:`OpCost`) over the
call's forward, backward and optimizer update:

* **flops**: every op that ``torch.utils.flop_counter`` has a formula for
  (the products: ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ...), plus each
  hand-written kernel's own count, which its wrapper on the card, or its
  shape function on meta tensors, reports (``kernels.cost``: 4·D a kept
  (query, key) pair and head for the flash forward, 10·D for its backward;
  2 an element for the scan, 3 for its backward);
* **bytes**: each op's operands plus its results, a result written into an
  operand counted once. There is no fusion discount: every eager op is a
  kernel that reads and writes device memory, where the reference's count
  charges a fusion only its external operands and results. Views and
  allocations launch nothing and count nothing;
* **collective_bytes**: each collective, max(result, operand) bytes, as the
  reference's, under the reference's names (``collectives``,
  ``collective_counts``);
* **peak_bytes**: the high-water mark of live storage: the arguments'
  storages, then each op output's storage, added when it appears and taken
  away when it is freed (a weak reference's callback). The tracker is this
  module's, not ``torch.distributed._tools.mem_tracker.MemTracker``, which
  books memory to ``nn.Module``\\ s and optimizers through their hooks; the
  port's models are functions of parameter trees, and only the high-water
  mark is wanted.

Loops need no trip count: eager code executes every iteration, and each is
counted.

The count is one rank's. On a mesh the step's tensors are DTensors: the
mode hands a DTensor op back to DTensor (``NotImplemented``), whose dispatch
runs the rank's local ops and its collectives (``_c10d_functional``) through
the mode again. So DTensor's ops count at their local shards' shapes, as the
kernels on local shards (``kernels.ops.heads_local``) and the MoE's local
branches do. The ops that DTensor's sharding propagation runs on fake
tensors at the global shapes, to infer shapes, are not counted.

On meta tensors (the dry-run's, ``launch.dryrun``) nothing is computed or
allocated; on the card the same mode counts an executed step, through the
real kernels.
"""

from __future__ import annotations

import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# the reference's names (repro/launch/hlo_cost.py)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")
_COLLECTIVE_NS = ("_c10d_functional", "c10d", "_dtensor")
# an ATen op name's prefix -> the reference's collective (longest first)
_COLLECTIVE_OPS = (("ragged_all_to_all", "ragged-all-to-all"),
                   ("shard_dim_alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
                   ("alltoall", "all-to-all"), ("all_gather", "all-gather"),
                   ("allgather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
                   ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                   ("send", "collective-permute"), ("recv", "collective-permute"))
# allocations: storage, but no kernel and no traffic
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _collective(func) -> str | None:
    ns, _, op = func._schema.name.partition("::")
    if ns not in _COLLECTIVE_NS:
        return None
    for prefix, name in _COLLECTIVE_OPS:
        if op.startswith(prefix):
            return name
    return None  # wait_tensor and the like: no traffic of their own


def _is_view(func) -> bool:
    """Whether ``func`` returns an alias of an input that it does not write."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _fake_active() -> bool:
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


class OpCost(TorchDispatchMode):
    """A dispatch mode that counts one rank's FLOPs, bytes, collectives and
    peak live storage (module doc). ``track(tree)`` books storages that exist
    before the mode is entered (the call's arguments)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = {name: 0 for name in COLLECTIVES}
        self.collective_counts = {name: 0 for name in COLLECTIVES}
        self.kernels: dict[str, dict] = {}
        self.loops: dict[str, dict] = {}
        self.live = 0
        self.peak = 0
        self._storages: dict[int, tuple] = {}

    # -- storage ----------------------------------------------------------
    def _freed(self, key):
        entry = self._storages.pop(key, None)
        if entry is not None:
            self.live -= entry[1]

    def _book(self, t):
        st = _local(t).untyped_storage()
        key, size = st._cdata, st.nbytes()
        entry = self._storages.get(key)
        if entry is not None:
            if entry[1] == size:
                return
            self.live -= entry[1]  # resized in place
        self._storages[key] = (weakref.ref(st, lambda _, k=key: self._freed(k)), size)
        self.live += size
        self.peak = max(self.peak, self.live)

    def track(self, tree):
        """Book the storages of the tensors (DTensors' local shards) in ``tree``."""
        for t in _tensors(tree):
            self._book(t)

    # -- counting ---------------------------------------------------------
    def kernel_call(self, name: str, flops: int, nbytes: int):
        """One call of a hand-written kernel (``kernels.cost``)."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def loop_call(self, name: str, flops: int, nbytes: int):
        """A loop counted as one measured step times its steps
        (``kernels.cost.report_loop``)."""
        k = self.loops.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def measure(self, fn):
        """(a fresh counter of ``fn()``'s ops, ``fn()``'s result), every active
        mode set aside while it runs, so that this count leaves it out."""
        with _disable_current_modes():
            inner = type(self)()
            with inner:
                out = fn()
        return inner, out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs its local ops through this mode
        out = func(*args, **kwargs)
        if _fake_active():  # DTensor's shape inference at the global shapes
            return out
        outs = _tensors(out)
        for t in outs:
            self._book(t)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not outs or _is_view(func) or packet.__name__ in _ALLOCATIONS:
            return out  # no kernel, no traffic
        ins = _tensors((args, kwargs))
        operands = {id(t) for t in ins}  # a result written in place is one of them
        self.bytes += sum(map(_nbytes, ins)) + sum(_nbytes(t) for t in outs
                                                   if id(t) not in operands)
        name = _collective(func)
        if name is not None:
            self.collectives[name] += max(sum(_nbytes(t) for t in ins),
                                          sum(_nbytes(t) for t in outs))
            self.collective_counts[name] += 1
        return out

    def result(self) -> dict:
        """The reference's keys, plus ``peak_bytes`` and the kernels' part."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collective_bytes": float(sum(self.collectives.values())),
                "collectives": dict(self.collectives),
                "collective_counts": dict(self.collective_counts),
                "peak_bytes": self.peak, "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "loops": {k: dict(v) for k, v in self.loops.items()}}


def local_bytes(tree) -> int:
    """Bytes of the tensors in ``tree``, a DTensor's local shard's."""
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


def analyze(fn, *args, **kwargs) -> dict:
    """One call ``fn(*args, **kwargs)`` counted (:class:`OpCost`): its
    arguments' storages booked first, its output dropped when it returns.
    Adds ``arg_bytes`` and ``output_bytes``, the rank's shards of the
    arguments and of the output."""
    counter = OpCost()
    counter.track((args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    return {**counter.result(), "arg_bytes": local_bytes((args, kwargs)),
            "output_bytes": local_bytes(out)}
