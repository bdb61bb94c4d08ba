"""Precision and device policy: an explicit dtype in place of a global x64 flag.

The paper's decode requires float64 on the master (Table I uses s up to
2^36, far beyond float32's 24-bit mantissa).  PyTorch has float64 without
any global switch, so the policy is explicit: every entry point takes a
``dtype`` (default ``torch.float64``; ``torch.float32`` allowed) and a
``device`` (default the CUDA card, or on a mesh the rank's own device; the
CPU only when the caller asks).

It also says when the host must not read a tensor's values
(:func:`is_traced`): while a CUDA graph is being captured, and for the
tensors of a trace.
"""
from __future__ import annotations

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.fx.experimental.proxy_tensor import get_proxy_mode, has_proxy_slot
from torch.utils._python_dispatch import _get_current_dispatch_mode

__all__ = [
    "DEFAULT_DTYPE",
    "SUPPORTED_DTYPES",
    "resolve_dtype",
    "complex_dtype",
    "resolve_device",
    "capturing",
    "any_traced",
    "tracing",
    "is_traced",
]

DEFAULT_DTYPE = torch.float64
SUPPORTED_DTYPES = (torch.float64, torch.float32)

_BY_NAME = {"float64": torch.float64, "float32": torch.float32}


def resolve_dtype(dtype=None) -> torch.dtype:
    """A supported real torch dtype from a torch/numpy dtype or its name.

    Raises:
        ValueError: for anything but float64 / float32.
    """
    if dtype is None:
        return DEFAULT_DTYPE
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = _BY_NAME.get(np.dtype(dtype).name)
    if out not in SUPPORTED_DTYPES:
        raise ValueError(
            f"dtype {dtype!r} is not supported: the coded matmul runs in "
            "float64 (default) or float32")
    return out


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype unit-circle plans compute in for real ``dtype``."""
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def resolve_device(device=None, mesh=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless asked.

    With no ``device`` and a ``mesh`` (a ``DeviceMesh``), a rank computes on
    its own device: the CPU for a CPU mesh, else its current CUDA device.

    Raises:
        RuntimeError: when no device is given and no CUDA card is present
            (entry points never fall back to the CPU on their own).
    """
    if device is None and mesh is not None:
        if mesh.device_type == "cpu":
            return torch.device("cpu")
        return torch.device(mesh.device_type, torch.cuda.current_device())
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def capturing() -> bool:
    """True while the current CUDA stream is being captured into a graph
    (a process that never initialised CUDA captures nothing)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def tracing() -> bool:
    """True under a dispatch mode (a ``make_fx`` or fake-tensor trace), where
    a tensor made from host data becomes a constant of the trace."""
    return _get_current_dispatch_mode() is not None


def is_traced(x) -> bool:
    """True when ``x`` is a tensor whose values the host must not or cannot
    read, the counterpart of a jax tracer: a CUDA stream is being captured
    (a read would synchronise, which a capture refuses), or ``x`` is a
    ``FakeTensor``, a functorch-wrapped tensor (``vmap``, ``grad``), or a
    tensor that an active ``make_fx`` proxy mode tracks (an input of the
    traced function or a value computed from one).  A plain eager tensor,
    on any device, is not traced; nor is a tensor that a trace closes over.
    """
    return any_traced((x,))


def any_traced(values) -> bool:
    """Whether any of ``values`` is traced (:func:`is_traced`), asking once
    whether a stream is being captured and for the proxy mode."""
    tensors = [x for x in values if isinstance(x, torch.Tensor)]
    if not tensors:
        return False
    if capturing():
        return True
    mode = get_proxy_mode()
    return any(isinstance(x, FakeTensor) or torch._C._functorch.is_functorch_wrapped_tensor(x)
               or (mode is not None and has_proxy_slot(x, mode.tracer)) for x in tensors)
