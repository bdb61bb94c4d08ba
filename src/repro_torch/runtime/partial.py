"""Fractional straggler progress: ``PartialPattern`` and the chunk schedule.

``ErasurePattern`` models a worker as binary - alive or erased.  A slow
worker that completed an ordered PREFIX of its task still contributes to
decoding (Das & Ramamoorthy, arXiv 2012.06065, 2109.12070): each worker's
coded block product ``A~_k^T B~_k`` is split into ``Q`` ordered sub-tasks
(row chunks of the output), and a worker reporting progress ``q/Q`` has
completed ``q`` of them.

Chunk schedule
--------------
Workers process chunks in a CYCLIC order - worker ``k`` runs chunk
``(k + j) % Q`` as its ``j``-th sub-task - so each prefix length spreads its
coverage evenly over the chunks:

    worker k has chunk c  <=>  ((c - k) mod Q) < q_k

Decodability is PER CHUNK: chunk ``c`` decodes iff at least tau workers
completed it, and the whole product decodes iff every chunk does.  A binary
pattern is the special case ``q_k in {0, Q}``; ``Q = 1`` is exactly
``ErasurePattern``.

Like ``ErasurePattern``, a pattern is *concrete* (host-known progress: the
decode looks up a per-chunk panel stack keyed on the quantized signature)
or *traced* (progress is a tensor the host must not read, as
``core.numerics.is_traced`` decides: the chunk masks and their panels are
built on the device, :func:`chunk_masks_traced`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.numerics import is_traced
from repro_torch.runtime.erasure import ErasurePattern, _host

__all__ = ["PartialPattern", "chunk_bounds", "chunk_masks_for",
           "chunk_masks_traced", "chunk_coverage"]


def chunk_bounds(rows: int, Q: int) -> tuple:
    """Row offsets splitting ``rows`` output rows into ``Q`` ordered chunks.

    Chunks differ in size by at most one row (the first ``rows % Q`` chunks
    get the extra row).  Returns ``Q + 1`` offsets.

    Raises:
        ValueError: when ``Q < 1`` or ``rows < Q`` (a chunk would be empty).
    """
    if Q < 1:
        raise ValueError(f"need Q >= 1 sub-tasks, got {Q}")
    if rows < Q:
        raise ValueError(
            f"cannot split {rows} output rows into Q={Q} non-empty chunks; "
            f"lower --sub-tasks or grow the block size")
    sizes = np.full(Q, rows // Q, dtype=np.int64)
    sizes[: rows % Q] += 1
    return tuple(int(x) for x in np.concatenate([[0], np.cumsum(sizes)]))


def chunk_masks_for(counts: np.ndarray, Q: int) -> np.ndarray:
    """(Q, K) 0/1 chunk-availability masks from per-worker chunk counts.

    ``counts[k]`` is the number of sub-tasks worker ``k`` completed under
    the cyclic schedule; row ``c`` of the result masks the workers whose
    prefix covers chunk ``c``.
    """
    counts = np.asarray(counts, dtype=np.int64)
    c = np.arange(Q)[:, None]
    k = np.arange(counts.shape[0])[None, :]
    return (((c - k) % Q) < counts[None, :]).astype(np.float64)


def chunk_masks_traced(progress: torch.Tensor, Q: int) -> torch.Tensor:
    """(Q, K) 0/1 chunk-availability masks from a (K,) progress tensor, on
    its device and in its dtype, with no host read: the counts are
    ``floor(progress * Q + 1e-9)`` and worker k holds chunk c iff
    ``((c - k) mod Q) < count_k``, as the reference's traced body computes
    them."""
    counts = torch.floor(progress * Q + 1e-9)
    c = torch.arange(Q, device=progress.device)[:, None]
    k = torch.arange(progress.shape[0], device=progress.device)[None, :]
    return (torch.remainder(c - k, Q) < counts).to(progress.dtype)


def chunk_coverage(counts: np.ndarray, Q: int) -> np.ndarray:
    """(Q,) number of workers covering each chunk under the cyclic schedule."""
    return chunk_masks_for(counts, Q).sum(axis=1).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class PartialPattern:
    """Per-worker fractional progress over K workers and Q sub-tasks.

    ``progress`` is a (K,) float64 numpy array in [0, 1] for ``kind ==
    "concrete"`` (quantized to multiples of ``1/Q`` by ``chunk_counts``) and
    the original tensor for ``kind == "traced"``.
    """

    K: int
    Q: int
    kind: str  # "concrete" | "traced"
    progress: Any

    # -- constructors -------------------------------------------------------
    @classmethod
    def full(cls, K: int, Q: int) -> "PartialPattern":
        """Every worker completed all ``Q`` sub-tasks."""
        cls._check_q(Q)
        return cls(K=K, Q=Q, kind="concrete",
                   progress=np.ones(K, dtype=np.float64))

    @classmethod
    def from_progress(cls, K: int, Q: int, progress: Any) -> "PartialPattern":
        """Pattern from a (K,) progress vector: array-like, an eager tensor
        (read to the host), or a traced tensor (kept as it is, never read).

        Raises:
            ValueError: on a bad shape, or concrete values outside [0, 1].
        """
        cls._check_q(Q)
        if is_traced(progress):
            if tuple(progress.shape) != (K,):
                raise ValueError(
                    f"traced progress shape {tuple(progress.shape)} != ({K},)")
            return cls(K=K, Q=Q, kind="traced", progress=progress)
        prog = _host(progress).astype(np.float64)
        if prog.shape != (K,):
            raise ValueError(f"progress shape {prog.shape} != ({K},)")
        if not np.all(np.isfinite(prog)) or np.any(prog < 0) or np.any(prog > 1):
            raise ValueError(
                f"progress must lie in [0, 1], got {prog.tolist()}")
        return cls(K=K, Q=Q, kind="concrete", progress=prog)

    @classmethod
    def from_erasure(cls, pattern: ErasurePattern, Q: int) -> "PartialPattern":
        """Lift a binary ``ErasurePattern`` (0/1 progress) to ``Q`` sub-tasks."""
        cls._check_q(Q)
        if pattern.is_concrete:
            return cls(K=pattern.K, Q=Q, kind="concrete",
                       progress=np.asarray(pattern.mask, dtype=np.float64))
        return cls(K=pattern.K, Q=Q, kind="traced", progress=pattern.mask)

    @classmethod
    def normalize(
        cls,
        K: int,
        Q: int,
        spec: Any = None,
        *,
        progress: Any = None,
        erased: Optional[Sequence[int]] = None,
        survivors: Optional[Sequence[int]] = None,
        mask: Any = None,
    ) -> "PartialPattern":
        """Accept one spec (pattern / progress / binary forms; none = full).

        A ``PartialPattern`` spec must agree with ``K`` (and keeps its own
        ``Q``); binary specs become 0/1 progress.
        """
        if spec is not None and progress is not None:
            raise ValueError("pass only one of partial spec / progress")
        if isinstance(spec, PartialPattern):
            if spec.K != K:
                raise ValueError(
                    f"pattern built for K={spec.K}, plan has K={K}")
            return spec
        if isinstance(spec, ErasurePattern):
            return cls.from_erasure(spec, Q)
        if spec is not None:
            return cls.from_progress(K, Q, spec)
        if progress is not None:
            return cls.from_progress(K, Q, progress)
        if erased is not None or survivors is not None or mask is not None:
            return cls.from_erasure(
                ErasurePattern.normalize(K, erased=erased,
                                         survivors=survivors, mask=mask), Q)
        return cls.full(K, Q)

    # -- views --------------------------------------------------------------
    @property
    def is_concrete(self) -> bool:
        """True when the progress vector is host-known (not traced)."""
        return self.kind == "concrete"

    @property
    def chunk_counts(self) -> np.ndarray:
        """(K,) completed sub-task counts: ``floor(progress * Q)`` (concrete
        patterns only)."""
        if not self.is_concrete:
            raise ValueError("chunk_counts is undefined for a traced partial pattern")
        return np.floor(self.progress * self.Q + 1e-9).astype(np.int64)

    @property
    def chunk_masks(self) -> np.ndarray:
        """(Q, K) per-chunk worker-availability masks (concrete patterns)."""
        return chunk_masks_for(self.chunk_counts, self.Q)

    @property
    def coverage(self) -> np.ndarray:
        """(Q,) workers covering each chunk (concrete patterns)."""
        return chunk_coverage(self.chunk_counts, self.Q)

    @property
    def key(self) -> tuple:
        """Hashable identity: (Q, quantized signature) for concrete patterns,
        (Q, "traced") for traced ones."""
        if self.is_concrete:
            return (self.Q,) + tuple(int(c) for c in self.chunk_counts)
        return (self.Q, "traced")

    def decodable(self, tau: int) -> bool:
        """True when every chunk has at least ``tau`` contributors."""
        return bool(np.all(self.coverage >= tau))

    def require_decodable(self, tau: int) -> None:
        """Raise loudly (not garbage output) when a chunk is undercovered.

        Raises:
            ValueError: naming every chunk whose coverage is below ``tau``.
        """
        cov = self.coverage
        bad = np.flatnonzero(cov < tau)
        if bad.size:
            detail = ", ".join(f"chunk {int(c)}: {int(cov[c])}" for c in bad)
            raise ValueError(
                f"partial progress does not span the decoding system: "
                f"need >= tau={tau} contributors per chunk, got {detail} "
                f"(counts {self.chunk_counts.tolist()}, Q={self.Q})")

    def progress_array(self, dtype: torch.dtype, device) -> torch.Tensor:
        """The progress vector as a (K,) tensor of ``dtype`` on ``device``; a
        traced one is cast where it lies, never copied through the host."""
        if self.is_concrete:
            return torch.as_tensor(self.progress, dtype=dtype, device=device)
        return self.progress.to(device=device, dtype=dtype)

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _check_q(Q: int) -> None:
        if Q < 1:
            raise ValueError(f"need Q >= 1 sub-tasks, got {Q}")
