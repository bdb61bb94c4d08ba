"""Logical-axis sharding: a map from logical axes to mesh dimensions.

Model code annotates tensors with LOGICAL axis names ("dp", "sp", "tp",
"fsdp", "ep", None); a context-scoped ``AxisRules`` maps those to the
dimensions of a ``DeviceMesh`` (``launch/mesh.py``: ("data", "model"), or
("pod", "data", "model")).  Outside any rules context every annotation is a
no-op, so the same model code runs on one device and on a mesh unchanged.

Logical names used across the codebase:
  dp    - data parallel (batch dim)                  -> ("pod", "data")
  fsdp  - fully-sharded parameter dim (ZeRO-3)       -> ("pod", "data")
  sp    - sequence parallel (activations at rest)    -> ("model",)
  tp    - tensor parallel (heads / ffn / experts)    -> ("model",)
  ep    - expert parallel                            -> ("model",)

The reference is one program over every device, and ``shard(x, ...)`` is a
layout constraint its compiler fulfils.  The port runs one process a rank:
a sharded tensor is a ``torch.distributed.tensor.DTensor``, and ``shard``
redistributes it (the collectives run eagerly).  A spec here is what the
reference's ``PartitionSpec`` holds: per tensor dimension a mesh dimension's
name, a tuple of names, or None; :func:`placements` turns it into the
``DTensor`` placements (per mesh dimension, ``Shard(d)`` or
``Replicate()``).  ``shard_map_compat`` runs a function on the local shards
(``local_map``), as the reference's ``shard_map`` does.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

__all__ = ["AxisRules", "P", "axis_rules", "current_rules", "default_rules", "shard",
           "logical_sharding", "shard_map_compat", "placements", "resolve_spec",
           "mesh_sizes", "replicated", "partial_over", "recompute_context",
           "fsdp_gathered"]

AxisName = Union[str, None]
Spec = Tuple[Union[str, Tuple[str, ...], None], ...]


class P(tuple):
    """A partition spec, the reference's ``PartitionSpec``: per tensor
    dimension a mesh dimension's name, a tuple of names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def mesh_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    """{mesh dimension name: its size}."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def placements(mesh: DeviceMesh, spec: Spec) -> tuple:
    """A spec (per tensor dimension: a mesh dimension's name, a tuple of
    names, or None) as DTensor placements (per mesh dimension).  Several
    mesh dimensions on one tensor dimension split it major to minor in the
    mesh's order, as a ``PartitionSpec`` tuple does when it names them in
    that order."""
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(name)] = Shard(dim)
    return tuple(out)


class AxisRules:
    """Maps logical axis names to mesh dimension names (or None)."""

    def __init__(self, mesh: DeviceMesh,
                 table: Dict[str, Union[str, Tuple[str, ...], None]]):
        self.mesh = mesh
        self.table = dict(table)

    def physical(self, logical: AxisName):
        if logical is None:
            return None
        if logical not in self.table:
            raise KeyError(f"unknown logical axis {logical!r}; known: {list(self.table)}")
        return self.table[logical]

    def spec(self, *logical: AxisName) -> P:
        """The reference's ``PartitionSpec``: one entry per logical axis."""
        return P(*(self.physical(a) for a in logical))

    def placements(self, *logical: AxisName) -> tuple:
        """The DTensor placements of :meth:`spec` (no divisibility check)."""
        return placements(self.mesh, self.spec(*logical))


_local = threading.local()


def current_rules() -> Optional[AxisRules]:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: Optional[AxisRules]):
    prev = current_rules()
    _local.rules = rules
    try:
        yield rules
    finally:
        _local.rules = prev


def recompute_context(inner=None):
    """A ``context_fn`` for ``torch.utils.checkpoint`` (around ``inner``'s,
    if any): the recomputed forward runs under the sharding rules active
    now, with plain tensors counting as replicated.  The autograd engine
    runs a CUDA backward, recomputation included, on its own thread, which
    does not see this thread's rules."""
    rules = current_rules()

    def context_fn():
        fwd, rec = inner() if inner is not None else (contextlib.nullcontext(),
                                                       contextlib.nullcontext())
        if rules is None:
            return fwd, rec
        return fwd, _recompute(rec, rules)

    return context_fn


@contextlib.contextmanager
def _recompute(rec, rules: AxisRules):
    with rec, axis_rules(rules), implicit_replication():
        yield


def default_rules(mesh: DeviceMesh, fsdp: bool = True) -> AxisRules:
    """The reference's table for the production meshes.

    Single-pod  (data, model):        dp/fsdp -> data,        sp/tp/ep -> model
    Multi-pod   (pod, data, model):   dp/fsdp -> (pod, data), sp/tp/ep -> model

    ``fsdp=False`` replicates parameters over the data dimensions (pure TP).
    """
    dp: Union[str, Tuple[str, ...]] = (("pod", "data") if "pod" in mesh.mesh_dim_names
                                       else "data")
    return AxisRules(mesh, {
        "dp": dp,
        "fsdp": dp if fsdp else None,
        "sp": "model",
        "tp": "model",
        "ep": "model",
    })


def resolve_spec(rules: AxisRules, shape: Sequence[int],
                 logical: Sequence[AxisName]) -> P:
    """The spec the reference's ``shard`` resolves for a tensor of
    ``shape``: trailing unannotated dimensions replicated, and an axis whose
    mesh size does not divide its dimension silently dropped (replicated),
    which keeps one set of annotations valid across architectures."""
    sizes = mesh_sizes(rules.mesh)
    names = list(logical) + [None] * (len(shape) - len(logical))
    resolved = []
    for dim, name in zip(shape, names[:len(shape)]):
        phys = rules.physical(name) if name is not None else None
        if phys is None:
            resolved.append(None)
            continue
        size = 1
        for a in (phys if isinstance(phys, tuple) else (phys,)):
            size *= sizes[a]
        resolved.append(phys if dim % size == 0 else None)
    return P(*resolved)


def shard(x, *logical: AxisName):
    """Lay ``x`` out by logical names: a DTensor is redistributed to the
    resolved placements (a collective where they change); without rules, or
    for a plain tensor, ``x`` is returned as it is."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    want = placements(rules.mesh, resolve_spec(rules, x.shape, logical))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


def fsdp_gathered(p):
    """A parameter as a layer computes with it under the current rules: a
    DTensor gathered over the mesh dimensions "fsdp" maps to (its other
    splits kept), as FSDP unshards a parameter for compute; differentiable
    (the gradient is reduce-scattered back).  Without rules, or for a plain
    tensor or no fsdp dimension, ``p``."""
    rules = current_rules()
    if rules is None or not isinstance(p, DTensor):
        return p
    fsdp = rules.physical("fsdp")
    names = set(fsdp if isinstance(fsdp, tuple) else (fsdp,)) - {None}
    want = tuple(Replicate() if name in names else pl
                 for name, pl in zip(rules.mesh.mesh_dim_names, p.placements))
    return p if want == tuple(p.placements) else p.redistribute(rules.mesh, want)


def logical_sharding(*logical: AxisName) -> Optional[tuple]:
    """The placements of these logical axes under the current rules (None
    outside a rules context)."""
    rules = current_rules()
    if rules is None:
        return None
    return rules.placements(*logical)


def shard_map_compat(f, *, mesh: DeviceMesh, in_specs, out_specs,
                     in_grad_placements=None):
    """``f`` run on the local shards, the reference's ``shard_map``: each
    DTensor argument is redistributed to its ``in_specs`` entry (a
    :class:`P`, or None for a non-tensor argument) and handed to ``f`` as
    its local tensor; ``f``'s tensors come back as DTensors placed by
    ``out_specs`` (a :class:`P`, or a tuple of them for several outputs; a
    list of DTensor placements in place of a spec passes through, e.g. a
    ``Partial`` sum).
    ``in_grad_placements`` (per input: DTensor placements, or None) says how
    an input's gradient is laid out where that differs from the input: a
    replicated input that each shard uses on its own data has a partial-sum
    gradient (``local_map``'s argument of the same name)."""
    def one(spec):       # a list: local_map reads a tuple as one entry per output
        if spec is None:
            return None
        if not isinstance(spec, P):      # DTensor placements (a Partial sum, say)
            return list(spec)
        return list(placements(mesh, spec))

    single = isinstance(out_specs, P) or (isinstance(out_specs, list) and all(
        isinstance(p, Placement) for p in out_specs))
    outs = one(out_specs) if single else tuple(one(s) for s in out_specs)
    ins = tuple(one(s) for s in in_specs)
    if in_grad_placements is not None:     # None entries: laid out as the input
        in_grad_placements = tuple(g if g is not None else i
                                   for g, i in zip(in_grad_placements, ins))
    fn = local_map(f, out_placements=outs, in_placements=ins,
                   in_grad_placements=in_grad_placements,
                   device_mesh=mesh, redistribute_inputs=True)

    def call(*args):
        # beside DTensors a plain tensor holds the whole (replicated) value
        if any(isinstance(a, DTensor) for a in args):
            args = tuple(replicated(a, mesh) if isinstance(a, torch.Tensor) else a
                         for a in args)
        return fn(*args)

    return call


def partial_over(mesh: DeviceMesh, spec: Spec, dims) -> tuple:
    """The gradient placements of an input laid out by ``spec`` that each
    rank uses on its own share of the data split over the mesh dimensions
    ``dims``: a partial sum over those (where the input is replicated on
    them), else the input's own placement."""
    names = set(dims if isinstance(dims, tuple) else (dims,)) - {None}
    return tuple(Partial() if name in names and isinstance(p, Replicate) else p
                 for name, p in zip(mesh.mesh_dim_names, placements(mesh, spec)))


def replicated(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` as a DTensor on ``mesh``: a plain tensor is taken as the whole
    value, replicated on every rank; a DTensor is returned as it is."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
