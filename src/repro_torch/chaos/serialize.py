"""One dataclass <-> JSON-safe-dict serialiser for every trace surface.

Both trace formats in the system — ``chaos.trace`` (per-step control-loop
records) and ``serve.trace`` (per-request/per-batch serving records) —
persist frozen dataclasses as JSONL and compare them field-for-field on
replay.  They share this module so a field added to ``StepReport`` (or to
the serve tier's request records) round-trips through every surface
automatically instead of each recorder hand-picking fields and silently
dropping new ones.

The contract:

* :func:`dataclass_to_dict` walks ``dataclasses.fields`` in declaration
  order, drops ``exclude``-listed fields, and passes each value through
  :func:`jsonable` (tuples/arrays -> lists, numpy scalars -> Python
  scalars, nested dataclasses -> dicts).  ``json.dumps`` serialises
  Python floats at shortest round-trip precision, so float64 values
  survive the file boundary bit-exactly.
* :func:`tuplify` is the inverse normalisation on load: nested lists
  become tuples again, so reconstructed frozen dataclasses compare equal
  to freshly built ones (``==`` is the bit-determinism contract).
* :func:`report_to_dict` is the shared ``StepReport`` serialisation:
  everything except ``wall_ms`` (measured wall time is the one field a
  bit-exact replay can never reproduce).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np

__all__ = ["REPORT_VOLATILE_FIELDS", "jsonable", "tuplify",
           "report_field_names", "dataclass_to_dict", "report_to_dict"]

#: ``StepReport`` fields no serialiser records: wall-clock noise only.
REPORT_VOLATILE_FIELDS: Tuple[str, ...] = ("wall_ms",)


def report_field_names(report_cls: Any,
                       volatile: Tuple[str, ...] = REPORT_VOLATILE_FIELDS,
                       ) -> Tuple[str, ...]:
    """Dataclass field names minus the volatile ones, declaration order.

    The ONE place field selection happens for every trace surface:
    :func:`dataclass_to_dict` (hence :func:`report_to_dict` and both
    JSONL recorders) and ``chaos.trace.COMPARED_FIELDS`` all derive from
    it, so a field added to ``StepReport`` either flows through every
    surface at once or fails loudly — it can no longer be recorded by one
    format and silently dropped by another.

    Raises:
        TypeError: if ``report_cls`` is not a dataclass.
    """
    if not dataclasses.is_dataclass(report_cls):
        raise TypeError(f"need a dataclass, got {report_cls!r}")
    return tuple(f.name for f in dataclasses.fields(report_cls)
                 if f.name not in volatile)


def jsonable(value: Any) -> Any:
    """``value`` recursively converted to JSON-encodable Python types.

    Tuples, lists, and numpy arrays become lists; numpy scalars become the
    matching Python scalar (preserving the float64 bit pattern — ``json``
    writes shortest-round-trip decimal); nested dataclasses become dicts;
    dict values convert recursively.  Everything else passes through.
    """
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: jsonable(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, np.ndarray):
        return [jsonable(v) for v in value.tolist()]
    if isinstance(value, (tuple, list)):
        return [jsonable(v) for v in value]
    if isinstance(value, dict):
        return {k: jsonable(v) for k, v in value.items()}
    if isinstance(value, np.generic):
        return value.item()
    return value


def tuplify(value: Any) -> Any:
    """Inverse normalisation for loaded records: lists -> tuples, recursively.

    Applied to sequence-valued fields when reconstructing frozen
    dataclasses from JSON, so loaded records compare ``==`` to fresh ones.
    Dicts keep their type (values convert); scalars pass through.
    """
    if isinstance(value, (list, tuple)):
        return tuple(tuplify(v) for v in value)
    if isinstance(value, dict):
        return {k: tuplify(v) for k, v in value.items()}
    return value


def dataclass_to_dict(dc: Any, exclude: Tuple[str, ...] = ()) -> dict:
    """All of ``dc``'s fields (minus ``exclude``) as a JSON-safe dict.

    Field order follows the dataclass declaration; every value goes
    through :func:`jsonable`.  Unlike ``dataclasses.asdict`` this is
    exclusion-aware and numpy-aware, which is what the trace surfaces
    need.

    Raises:
        TypeError: if ``dc`` is not a dataclass instance.
    """
    if not dataclasses.is_dataclass(dc) or isinstance(dc, type):
        raise TypeError(f"need a dataclass instance, got {type(dc).__name__}")
    return {name: jsonable(getattr(dc, name))
            for name in report_field_names(type(dc), volatile=exclude)}


def report_to_dict(report: Any,
                   exclude: Tuple[str, ...] = REPORT_VOLATILE_FIELDS) -> dict:
    """The shared ``StepReport`` serialisation (drops wall-clock noise).

    Used by ``chaos.trace`` (step records) and ``serve.trace`` (the
    per-batch ``report`` payload) so both formats carry the SAME field
    set and a new ``StepReport`` field shows up in both.
    """
    return dataclass_to_dict(report, exclude=exclude)
