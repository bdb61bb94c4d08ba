"""Public wrappers around the CUDA kernels.

Each wrapper promotes dtypes, routes complex operands to the plain complex
PyTorch path (as the reference package routes them to its jnp oracles: its
TPU kernels, like these CUDA kernels, are real-only), and then dispatches on
where the tensors lie: CPU tensors run the kernel's plain version, CUDA
tensors launch the kernel (or raise; there is no fallback).  Complex plans
(unit-circle points) therefore take the plain path on the card too.

Every wrapper carries an integer ``launches`` count, raised by one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.coded_decode import decode_cuda
from repro_torch.kernels.coded_fused import fused_worker_cuda

__all__ = ["fused_worker", "decode", "launch_counts", "reset_launch_counts"]


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix."""
    kinds = {x.device.type for x in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"operands must all lie on the CPU or all on one CUDA "
                     f"device, got {sorted(kinds)}")


def fused_worker(coeff_a: torch.Tensor, coeff_b: torch.Tensor,
                 a_blocks: torch.Tensor, b_blocks: torch.Tensor, *,
                 out_dtype=None) -> torch.Tensor:
    """All-K fused encode+product: coeff_a (K, P), coeff_b (K, Q),
    a_blocks (*grid_a, v, r), b_blocks (*grid_b, v, t) -> (K, r, t), with the
    leading block dims flattened row-major to P (resp. Q).

    Promotes everything to one dtype (encode semantics).  The kernel masks
    ragged edges itself, so nothing is padded.  Complex operands take the
    plain path wherever they lie.
    """
    tensors = (coeff_a, coeff_b, a_blocks, b_blocks)
    if any(x.is_complex() for x in tensors):
        return ref.fused_worker_ref(coeff_a, coeff_b, a_blocks, b_blocks,
                                    out_dtype)
    dt = coeff_a.dtype
    for x in tensors[1:]:
        dt = torch.promote_types(dt, x.dtype)
    ca, cb, a, b = (x.to(dt) for x in tensors)
    if not _on_card(*tensors):
        return ref.fused_worker_ref(ca, cb, a, b, out_dtype)
    out = fused_worker_cuda(ca, cb, a, b)
    fused_worker.launches += 1
    return out if out_dtype is None else out.to(out_dtype)


def decode(W: torch.Tensor, Y: torch.Tensor, s: float, *,
           extract: bool = True) -> torch.Tensor:
    """W: (mn, tau), Y: (tau, E) -> (mn, E) decoded + digit-extracted
    (``extract=False`` only rounds).  Y is promoted to W's dtype; complex
    panels take the plain path (the real part is extracted)."""
    if W.is_complex() or Y.is_complex():
        return ref.decode_ref(W, Y, s, extract)
    Y = Y.to(W.dtype)
    if not _on_card(W, Y):
        return ref.decode_ref(W, Y, s, extract)
    out = decode_cuda(W, Y, s, extract)
    decode.launches += 1
    return out


fused_worker.launches = 0
decode.launches = 0
_WRAPPERS = {"fused_worker": fused_worker, "decode": decode}


def launch_counts() -> dict:
    """``{wrapper name: kernel launches so far}``."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in _WRAPPERS.values():
        fn.launches = 0
