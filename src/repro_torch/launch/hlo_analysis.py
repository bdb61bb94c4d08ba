"""Op-level accounting of a PyTorch step: collective bytes, dot FLOPs, HBM
bytes and live memory.

The reference parses XLA's partitioned HLO (``compiled.as_text()``): it
walks the computations, multiplies while bodies by their trip counts, and
sums per DEVICE collective bytes (times a ring factor), dot FLOPs and the
operand + result bytes of every top-level instruction.  PyTorch has no HLO:
an eager step dispatches ATen ops one at a time.  So this module counts the
same quantities over the ops a step dispatches, under a
``TorchDispatchMode`` (:class:`OpAccounting`, or :func:`analyze`), on real,
meta or fake tensors alike:

* **dots**: every op that ``torch.utils.flop_counter`` has a formula for
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, fused attention)
  adds that formula's count, ``2 x prod(out) x prod(contracting)`` for a
  product, and one to ``dot_count``;
* **HBM bytes**: the operand bytes plus the result bytes of every op but
  those that move no data (views, aliases, ``detach``, metadata, the
  ``empty`` factories, and the collectives, whose bytes are the link
  term): the reference's ``_NO_TRAFFIC``.  An eager step fuses nothing, so
  every elementwise op pays its own round trip, where XLA's fusions pay
  one.  A write into a slice (``copy_``, ``index_put_``, ``slice_scatter``,
  ``select_scatter``) counts twice the update, as the reference counts a
  ``dynamic-update-slice``;
* **kernels**: a hand-written kernel (the ``repro_torch::`` custom ops of
  ``kernels/ops.py``) counts its operands and results and no dots, as the
  reference counts a Pallas call at its call site; ``kernel_calls`` counts
  its calls;
* **collectives**: the bytes of the reference's printed result type
  (gathered for an all-gather, scattered for a reduce-scatter) times its
  ring factor for the op's group size G (``_ring_factor``), for the
  functional collectives (``_c10d_functional``, which DTensor's
  redistributions call) and the classic ones (``c10d``, the EP
  all_to_all).  An eager loop dispatches every iteration, so nothing is
  multiplied by a trip count, and ``count_by_kind`` counts CALLS, not
  instructions: a collective in a loop of 7 counts 7 (the reference's
  instruction count says 1).

A DTensor op is let through to DTensor (the mode answers NotImplemented),
which runs it as local ops and collectives the mode then sees: every count
is per DEVICE, as the reference's are.

The mode also tracks the bytes of live storages the step allocates (each
counted once, from the op that made it until it is freed): ``peak_bytes``
is the step's peak, the counterpart of XLA's temp + output sizes.

Each op that moves data can be written to an op log (``OpAccounting(log=
file)``, one JSON object a line: the op's name, its arguments with each
tensor as shape and dtype, its results and its group size), the
counterpart of the reference's stored ``.hlo.gz``: :func:`analyze_records`
recomputes the collective, dot and HBM figures from it.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import threading
import weakref
from collections import defaultdict
from typing import IO, Any, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

__all__ = ["HloStats", "OpAccounting", "analyze", "analyze_records", "KERNEL_NAMESPACE"]

KERNEL_NAMESPACE = "repro_torch"     # the hand-written kernels' custom ops

# collective op packet -> the reference's kind
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "broadcast",
    "_c10d_functional.broadcast_": "broadcast",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "broadcast",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}

# ops that move no data besides views (``OpOverload.is_view``): aliases,
# metadata, the empty factories, and the collectives' completion
_NO_TRAFFIC = {
    "aten.detach", "aten.alias", "aten.lift_fresh", "aten._unsafe_view",
    "aten._reshape_alias", "aten.empty", "aten.empty_strided", "aten.empty_like",
    "aten.new_empty", "aten.new_empty_strided", "aten.sym_size", "aten.sym_stride",
    "aten.sym_numel", "aten.sym_storage_offset", "aten.is_same_size",
    "aten._has_compatible_shallow_copy_type", "aten.set_", "aten.resize_",
    "aten._local_scalar_dense", "prim.device", "prim.layout",
    "_c10d_functional.wait_tensor",
}

# writes into a slice of their first argument: twice the update's bytes
_UPDATE_ARG = {"aten.copy_": "src", "aten.index_put_": "values",
               "aten.index_put": "values", "aten._index_put_impl_": "values",
               "aten.slice_scatter": "src", "aten.select_scatter": "src"}


def _ring_factor(kind: str, G: int) -> float:
    """The reference's per-device traffic factor of a ring collective."""
    if G <= 1:
        return 0.0
    return {
        "all-gather": (G - 1) / G,
        "all-reduce": 2 * (G - 1) / G,
        "reduce-scatter": float(G - 1),
        "all-to-all": (G - 1) / G,
        "collective-permute": 1.0,
    }.get(kind, 1.0)


@dataclasses.dataclass
class HloStats:
    """Per-device totals of one step (the reference's fields, less
    ``pallas_interp_bytes``: a kernel op's body is never dispatched), and
    the calls of each hand-written kernel."""
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]
    dot_flops: float
    dot_count: int
    hbm_bytes: float = 0.0
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


# ---------------------------------------------------------------------------
# one op, as a record

def _encode(x):
    """An argument as JSON: a tensor as {"t": [shape, dtype]}, a list as a
    list, anything else that JSON cannot hold (a dtype, a process group) as
    its str."""
    if isinstance(x, torch.Tensor):
        return {"t": [list(x.shape), str(x.dtype).replace("torch.", "")]}
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    if isinstance(x, (list, tuple)):
        return [_encode(v) for v in x]
    if isinstance(x, torch.SymInt):
        return int(x)
    return str(x)


def _is_tensor(x) -> bool:
    return isinstance(x, dict) and set(x) == {"t"}


def _nbytes(x) -> int:
    shape, dtype = x["t"]
    n = 1
    for d in shape:
        n *= int(d)
    return n * getattr(torch, dtype).itemsize


def _tensors(tree) -> List[dict]:
    leaves, _ = tree_flatten(tree, is_leaf=_is_tensor)
    return [x for x in leaves if _is_tensor(x)]


def _group_size(args, kwargs) -> int:
    """The size of the group a collective runs over: its ``group_size``
    argument, else its process group (a classic op's, boxed as a script
    object, or a functional op's group name)."""
    if "group_size" in kwargs:
        return int(kwargs["group_size"])
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return int(dist.ProcessGroup.unbox(a).size())
        if isinstance(a, dist.ProcessGroup):
            return int(a.size())
        if isinstance(a, str) and a not in ("sum", "avg", "max", "min", "product"):
            try:
                return int(dist.distributed_c10d._resolve_process_group(a).size())
            except (KeyError, ValueError, RuntimeError):
                continue
    return 1


def _op_name(func) -> str:
    """'namespace.op' of an OpOverload (its packet's name)."""
    return f"{func.namespace}.{func._schema.name.split('::')[-1]}"


def _named_args(func, args, kwargs) -> Dict[str, Any]:
    """The op's arguments by schema name."""
    out = dict(kwargs)
    for arg, val in zip(func._schema.arguments, args):
        out[arg.name] = val
    return out


def _resolve(op: str):
    """The OpOverload a record names ('aten.mm.default')."""
    ns, name, overload = op.split(".")
    return getattr(getattr(getattr(torch.ops, ns), name), overload)


class _Totals:
    """Running sums over records."""

    def __init__(self):
        self.bytes_by_kind: Dict[str, float] = defaultdict(float)
        self.count_by_kind: Dict[str, int] = defaultdict(int)
        self.kernel_calls: Dict[str, int] = defaultdict(int)
        self.dot_flops = 0.0
        self.dot_count = 0
        self.hbm_bytes = 0.0

    def add(self, func, rec: dict) -> None:
        """Account one op: ``func`` its OpOverload, ``rec`` its record."""
        packet = _op_name(func)
        named = _named_args(func, rec["args"], rec["kwargs"])
        if packet in _COLLECTIVES:
            kind = _COLLECTIVES[packet]
            # the reference's printed result: a classic op's output buffers,
            # else the tensors it returns (or, in place, takes)
            outs = [v for k, v in named.items() if k.startswith("output")]
            payload = sum(map(_nbytes, _tensors(outs) or _tensors(rec["out"])
                              or _tensors(named)))
            self.bytes_by_kind[kind] += payload * _ring_factor(kind, rec["group"])
            self.count_by_kind[kind] += 1
            return
        if func.namespace == KERNEL_NAMESPACE:
            self.kernel_calls[packet.split(".", 1)[1]] += 1
        elif func._overloadpacket in flop_registry:
            shapes = tree_map(lambda x: torch.Size(x["t"][0]) if _is_tensor(x) else x,
                              (rec["args"], rec["kwargs"], rec["out"]), is_leaf=_is_tensor)
            out = shapes[2][0] if len(shapes[2]) == 1 else shapes[2]
            self.dot_flops += float(flop_registry[func._overloadpacket](
                *shapes[0], **shapes[1], out_val=out))
            self.dot_count += 1
        if packet in _UPDATE_ARG and _UPDATE_ARG[packet] in named:
            self.hbm_bytes += 2 * sum(map(_nbytes, _tensors(named[_UPDATE_ARG[packet]])))
        else:
            self.hbm_bytes += sum(map(_nbytes, _tensors((rec["args"], rec["kwargs"],
                                                          rec["out"]))))

    def stats(self) -> HloStats:
        return HloStats(dict(self.bytes_by_kind), dict(self.count_by_kind), self.dot_flops,
                        self.dot_count, self.hbm_bytes, dict(self.kernel_calls))


def _moves_data(func) -> bool:
    return not (func.is_view or _op_name(func) in _NO_TRAFFIC)


def analyze_records(records: Iterable[dict]) -> HloStats:
    """The collective, dot and HBM figures of a stored op log (the records
    :class:`OpAccounting` writes), with today's rules: the reference's
    ``analyze_hlo`` of a stored trace."""
    totals = _Totals()
    for rec in records:
        func = _resolve(rec["op"])
        if _moves_data(func) or _op_name(func) in _COLLECTIVES:
            totals.add(func, rec)
    return totals.stats()


# ---------------------------------------------------------------------------
# the mode

# DTensor finds an op's output shapes by running it again on fake tensors of
# the GLOBAL shapes (``ShardingPropagator``); those runs reach the mode too
# and compute nothing on the device, so the mode passes them through unseen.
_META_RUNS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
_meta_run = threading.local()


class _ShapeRuns:
    """Marks DTensor's shape-finding runs while any accounting is on: the
    first of ``_META_RUNS`` that ``ShardingPropagator`` has is wrapped to
    raise a per-thread depth around its call."""
    users = 0
    saved = None

    @classmethod
    def install(cls) -> None:
        cls.users += 1
        if cls.users > 1:
            return
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        for name in _META_RUNS:
            orig = ShardingPropagator.__dict__.get(name)
            if orig is not None:
                break
        else:
            return

        @functools.wraps(orig)
        def marked(*args, **kwargs):
            _meta_run.depth = getattr(_meta_run, "depth", 0) + 1
            try:
                return orig(*args, **kwargs)
            finally:
                _meta_run.depth -= 1

        cls.saved = (ShardingPropagator, name, orig)
        setattr(ShardingPropagator, name, marked)

    @classmethod
    def remove(cls) -> None:
        cls.users -= 1
        if cls.users == 0 and cls.saved is not None:
            owner, name, orig = cls.saved
            setattr(owner, name, orig)
            cls.saved = None


class OpAccounting(TorchDispatchMode):
    """Counts what the ops dispatched inside it compute, move and allocate.

    With a ``log`` (a text file) each data-moving op's record is written to
    it, a JSON line each.  After the block: :meth:`stats` (the
    :class:`HloStats`), :attr:`peak_bytes` (the peak of the storages the
    block allocated, live together) and :attr:`live_bytes` (those still
    alive)."""

    def __init__(self, log: Optional[IO[str]] = None):
        super().__init__()
        self._totals = _Totals()
        self._log = log
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}

    def __enter__(self):
        _ShapeRuns.install()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ShapeRuns.remove()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs it as local ops, seen here
        if getattr(_meta_run, "depth", 0):
            return func(*args, **kwargs)   # DTensor's shape-finding run
        if (isinstance(func, torch._ops.OpOverload) and func.namespace != "prim"
                and func._overloadpacket not in flop_registry):
            # a composite op reaching the mode whole (inference mode skips the
            # autograd keys that decompose it): count its parts, as
            # FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload):
            return out
        collective = _op_name(func) in _COLLECTIVES
        if collective or _moves_data(func):
            rec = {"op": f"{_op_name(func)}.{func._overloadname}",
                   "args": _encode(list(args)),
                   "kwargs": {k: _encode(v) for k, v in kwargs.items()},
                   "out": _encode(out if isinstance(out, (list, tuple)) else [out]),
                   "group": _group_size(args, kwargs) if collective else None}
            self._totals.add(func, rec)
            if self._log is not None:
                self._log.write(json.dumps(rec) + "\n")
            self._track(args, kwargs, out)
        return out

    def _track(self, args, kwargs, out) -> None:
        """Count each storage an op's results hold that none of its inputs
        holds and that is not counted yet, until it is freed."""
        leaves, _ = tree_flatten(out)
        results = [t for t in leaves if isinstance(t, torch.Tensor)]
        if not results:
            return
        inputs, _ = tree_flatten((args, kwargs))
        held = {t.untyped_storage()._cdata for t in inputs if isinstance(t, torch.Tensor)}
        for t in results:
            st = t.untyped_storage()
            key = st._cdata
            if key in held or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def stats(self) -> HloStats:
        return self._totals.stats()


def analyze(fn, *args, **kwargs) -> Tuple[Any, HloStats]:
    """``fn(*args, **kwargs)`` under :class:`OpAccounting`: (its result, the
    step's :class:`HloStats`)."""
    with OpAccounting() as mode:
        out = fn(*args, **kwargs)
    return out, mode.stats()
