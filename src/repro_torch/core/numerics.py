"""Precision and device policy: an explicit dtype in place of a global x64 flag.

The paper's decode requires float64 on the master (Table I uses s up to
2^36, far beyond float32's 24-bit mantissa).  PyTorch has float64 without
any global switch, so the policy is explicit: every entry point takes a
``dtype`` (default ``torch.float64``; ``torch.float32`` allowed) and a
``device`` (default the CUDA card, or on a mesh the rank's own device; the
CPU only when the caller asks).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DEFAULT_DTYPE",
    "SUPPORTED_DTYPES",
    "resolve_dtype",
    "complex_dtype",
    "resolve_device",
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
