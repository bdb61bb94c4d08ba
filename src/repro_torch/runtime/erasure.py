"""One erasure-pattern type for every entry point.

``ErasurePattern`` normalises ``erased=`` / ``survivors=`` lists and 0/1
``mask`` arrays into one value with two kinds, as in the reference package:

* ``concrete`` - the survivor set is host-known (a list, a numpy array, or
  an eager tensor on any device, which is read to the host).  The runtime
  looks up a host-built decode panel for it, and the pattern reaches the
  kernels only as data.
* ``traced``   - the mask is a tensor whose values the host must not read
  (``core.numerics.is_traced``): any tensor while a CUDA graph is being
  captured, a fake or functorch-wrapped tensor, or an input of a ``make_fx``
  trace.  The decode panel is then built on the device from the mask
  (``core.decoding.masked_panel``), so one captured graph serves every
  survivor set written into the mask's buffer.

Positional normalisation rule: an array-like of length K is a 0/1 mask;
anything else sequence-like is a list of erased worker ids.  Use the
keyword forms when in doubt.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.core.numerics import is_traced

__all__ = ["ErasurePattern"]


def _host(x: Any) -> np.ndarray:
    """``x``'s values on the host; a tensor is read with any dispatch mode
    off, so a concrete tensor closed over by a trace reads as itself."""
    if isinstance(x, torch.Tensor):
        with _disable_current_modes():
            return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class ErasurePattern:
    """Normalised survivor/erasure description for K workers.

    ``mask`` is a (K,) 0/1 float64 numpy array for ``kind == "concrete"``
    and the original tensor for ``kind == "traced"``.
    """

    K: int
    kind: str  # "concrete" | "traced"
    mask: Any

    # -- constructors -------------------------------------------------------
    @classmethod
    def all_alive(cls, K: int) -> "ErasurePattern":
        """The no-failure pattern: every one of the K workers survives."""
        return cls(K=K, kind="concrete", mask=np.ones(K, dtype=np.float64))

    @classmethod
    def from_erased(cls, K: int, erased: Sequence[int]) -> "ErasurePattern":
        """Pattern from a list of ERASED worker ids.

        Raises:
            ValueError: on duplicate or out-of-range ids.
        """
        ids = cls._check_ids(K, erased, "erased")
        mask = np.ones(K, dtype=np.float64)
        mask[list(ids)] = 0.0
        return cls(K=K, kind="concrete", mask=mask)

    @classmethod
    def from_survivors(cls, K: int, survivors: Sequence[int]) -> "ErasurePattern":
        """Pattern from a list of SURVIVING worker ids.

        Raises:
            ValueError: on duplicate or out-of-range ids.
        """
        ids = cls._check_ids(K, survivors, "survivors")
        mask = np.zeros(K, dtype=np.float64)
        mask[list(ids)] = 1.0
        return cls(K=K, kind="concrete", mask=mask)

    @classmethod
    def from_mask(cls, K: int, mask: Any) -> "ErasurePattern":
        """Pattern from a (K,) 0/1 mask: numpy, a list, an eager tensor (read
        to the host), or a traced tensor (kept as it is, never read).

        Raises:
            ValueError: if the mask's shape is not (K,), or a concrete mask
                holds values outside {0, 1}: a fractional per-worker
                completion vector is not an erasure mask; pass it as
                ``progress=`` with ``sub_tasks=Q`` (or a ``PartialPattern``)
                so the finished prefix of each straggler is decoded instead
                of discarded.
        """
        if is_traced(mask):
            if tuple(mask.shape) != (K,):
                raise ValueError(f"traced mask shape {tuple(mask.shape)} != ({K},)")
            return cls(K=K, kind="traced", mask=mask)
        m = _host(mask)
        if m.shape != (K,):
            raise ValueError(f"mask shape {m.shape} != ({K},)")
        if not bool(np.all((m == 0) | (m == 1))):
            raise ValueError(
                f"binary erasure mask entries must be 0 or 1, got "
                f"{m.tolist()}: a fractional per-worker completion vector "
                f"is NOT an erasure mask — pass it as progress= with "
                f"sub_tasks=Q (or a PartialPattern) so the finished prefix "
                f"of each straggler is decoded instead of discarded")
        return cls(K=K, kind="concrete", mask=(m != 0).astype(np.float64))

    @classmethod
    def normalize(
        cls,
        K: int,
        spec: Any = None,
        *,
        erased: Optional[Sequence[int]] = None,
        survivors: Optional[Sequence[int]] = None,
        mask: Any = None,
    ) -> "ErasurePattern":
        """Accept exactly one of spec/erased/survivors/mask (or none)."""
        given = [x is not None for x in (spec, erased, survivors, mask)]
        if sum(given) > 1:
            raise ValueError(
                "pass only one of erasure spec / erased / survivors / mask")
        if spec is not None:
            if isinstance(spec, ErasurePattern):
                if spec.K != K:
                    raise ValueError(f"pattern built for K={spec.K}, plan has K={K}")
                return spec
            if is_traced(spec):
                return cls.from_mask(K, spec)
            if isinstance(spec, (list, tuple, np.ndarray, torch.Tensor)):
                arr = _host(spec)
                if arr.shape == (K,):
                    return cls.from_mask(K, arr)
                return cls.from_erased(K, [int(i) for i in arr.reshape(-1)])
            raise TypeError(f"cannot interpret erasure spec {type(spec).__name__}")
        if erased is not None:
            return cls.from_erased(K, erased)
        if survivors is not None:
            return cls.from_survivors(K, survivors)
        if mask is not None:
            return cls.from_mask(K, mask)
        return cls.all_alive(K)

    # -- views --------------------------------------------------------------
    @property
    def is_concrete(self) -> bool:
        """True when the survivor set is host-known (not traced)."""
        return self.kind == "concrete"

    @property
    def survivors(self) -> tuple:
        """Surviving worker ids, ascending (concrete patterns only)."""
        self._require_concrete("survivors")
        return tuple(int(i) for i in np.flatnonzero(self.mask))

    @property
    def erased(self) -> tuple:
        """Erased worker ids, ascending (concrete patterns only)."""
        self._require_concrete("erased")
        return tuple(int(i) for i in np.flatnonzero(self.mask == 0))

    @property
    def n_survivors(self) -> int:
        """Number of surviving workers (concrete patterns only)."""
        self._require_concrete("n_survivors")
        return int(np.sum(self.mask != 0))

    @property
    def key(self) -> tuple:
        """Hashable identity: the support for concrete, the kind for traced."""
        if self.is_concrete:
            return tuple(int(x != 0) for x in self.mask)
        return ("traced",)

    def mask_array(self, dtype: torch.dtype, device) -> torch.Tensor:
        """The mask as a (K,) tensor of ``dtype`` on ``device``; a traced
        mask is cast where it lies, never copied through the host."""
        if self.is_concrete:
            return torch.as_tensor(self.mask, dtype=dtype, device=device)
        return self.mask.to(device=device, dtype=dtype)

    # -- helpers ------------------------------------------------------------
    def _require_concrete(self, what: str) -> None:
        if not self.is_concrete:
            raise ValueError(f"{what} is undefined for a traced erasure pattern")

    @staticmethod
    def _check_ids(K: int, ids: Sequence[int], what: str) -> Sequence[int]:
        ids = [int(i) for i in ids]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate worker ids in {what}: {ids}")
        for i in ids:
            if not 0 <= i < K:
                raise ValueError(f"{what} id {i} out of range for K={K}")
        return ids
