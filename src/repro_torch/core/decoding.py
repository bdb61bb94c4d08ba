"""Decoding: interpolation + digit extraction (paper Sec. III-C).

Given worker outputs Y_k = A~(s,z_k)^T B~(s,z_k) from any tau survivors:

1. Vandermonde-interpolate the z-polynomial coefficients X_0..X_{tau-1}.
2. Select the useful powers X_{phi(i,j)}.
3. Digit extraction (bounded-entry schemes only):
     R   = round(X)            # kills the negative s-digits (< 1/2 total)
     C^  = R mod s             # in [0, s)
     C   = C^            if C^ <= s/2
           C^ - s        otherwise       # sign recentering
   With s a power of two the mod is exact in binary floating point.

For the baseline polynomial code the useful coefficient IS C_ij (round only).

Decode panels (the per-mask weights W) of a concrete mask are host scipy
math, bit-identical to the reference package's; the panel of a traced mask
(one the host must not read) is built on the mask's device by
:func:`masked_panel`.  The other functions here that take tensors are the
plain PyTorch versions.  The runtime's kernel path decodes through
``kernels.ops.decode`` (and, per chunk, ``kernels.ops.decode_partial``) and
must agree with :func:`decode_with_weights`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.schemes import Scheme
from repro_torch.core.vandermonde import _vander, interpolate_masked, interpolate_solve

__all__ = [
    "digit_extract", "decode", "decode_masked", "masked_panel",
    "DecodePanel", "DecodePanelCache", "make_decode_panel",
    "decode_with_panel", "decode_with_weights",
]


def digit_extract(X: torch.Tensor, s: float, round_first: bool = True) -> torch.Tensor:
    """Recover the s^0 digit of X = ... + *s^{-1} + C + *s + ... , |C| < s/2.

    ``torch.round`` rounds halves to even, as ``jnp.round`` does.
    """
    R = torch.round(X) if round_first else X
    C_hat = torch.remainder(R, s)  # convention: result in [0, s)
    return torch.where(C_hat <= s / 2, C_hat, C_hat - s)


def _finish_extract(scheme: Scheme, Xu: torch.Tensor, s: float,
                    tail: tuple) -> torch.Tensor:
    """Already-selected useful rows Xu (m*n, ...) -> (m, n, *tail) C blocks:
    real part, digit extraction (or plain rounding), block reshape."""
    g = scheme.grid
    if Xu.is_complex():
        Xu = Xu.real
    if scheme.needs_digit_extraction:
        C = digit_extract(Xu, s)
    else:
        C = torch.round(Xu)
    return C.reshape(g.m, g.n, *tail)


def _useful_rows(scheme: Scheme, X: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The useful powers' rows of X along ``dim``, in the scheme's (m, n)
    order, selected one by one: no index tensor to upload."""
    return torch.stack([X.select(dim, int(i))
                        for i in scheme.useful_z_exp().reshape(-1)], dim=dim)


def _extract_useful(scheme: Scheme, X: torch.Tensor, s: float) -> torch.Tensor:
    """X: (tau, br, bt) coefficients -> (m, n, br, bt) decoded C blocks."""
    return _finish_extract(scheme, _useful_rows(scheme, X), s, tuple(X.shape[1:]))


def decode(scheme: Scheme, z_survivors: torch.Tensor, Y_survivors: torch.Tensor,
           s: float) -> torch.Tensor:
    """Decode from exactly tau survivor outputs (static survivor set).

    z_survivors: (tau,), Y_survivors: (tau, br, bt) -> C blocks (m, n, br, bt).
    """
    tau = scheme.tau
    if z_survivors.shape[0] != tau:
        raise ValueError(
            f"need exactly tau={tau} survivors, got {z_survivors.shape[0]}; "
            "slice the first tau or use decode_masked")
    X = interpolate_solve(z_survivors, Y_survivors)
    return _extract_useful(scheme, X, s)


def decode_masked(scheme: Scheme, z_all: torch.Tensor, Y_all: torch.Tensor,
                  mask: torch.Tensor, s: float, ridge: float = 0.0) -> torch.Tensor:
    """Decode with a 0/1 survivor mask over all K workers (in-body solve).

    Requires sum(mask) >= tau; erased rows of Y_all may hold garbage.
    """
    X = interpolate_masked(z_all, Y_all, mask, scheme.tau, ridge)
    return _extract_useful(scheme, X, s)


def masked_panel(scheme: Scheme, z_all: torch.Tensor, mask: torch.Tensor,
                 ridge: float = 0.0) -> torch.Tensor:
    """The decode panel of a 0/1 survivor mask, built where the mask lies.

    z_all (K,) evaluation points in the decode dtype and mask (*batch, K),
    tensors on one device -> (*batch, mn, K): the useful rows of
    ``G^{-1} V_w^H`` with ``G = V^H D V`` (+ ``ridge`` I), ``D = diag(mask)``,
    the panel :func:`make_decode_panel` factors on the host, so
    ``decode_with_weights`` (or the decode kernels) can apply it.  A batch
    of masks (the Q chunk masks of a partial pattern) gives the (Q, mn, K)
    stack.  The solve is LU with partial pivoting (LAPACK's ``getrf``, or
    cuSOLVER's on the card) and never checks its result on the host, so the
    host reads nothing and the call can be captured into a CUDA graph.
    Requires sum(mask) >= tau, unchecked: fewer survivors give a singular
    G and non-finite or wrong weights.  The last bits of W may differ from
    the host panel's; C is equal wherever the decode is exact.
    """
    tau = scheme.tau
    V = _vander(z_all, tau)                                   # (K, tau)
    Vw = V * mask.to(V.dtype)[..., :, None]                   # (*batch, K, tau)
    G = V.conj().T @ Vw                                       # (*batch, tau, tau)
    if ridge:
        G = G + ridge * torch.eye(tau, dtype=G.dtype, device=G.device)
    W_full = torch.linalg.solve_ex(G, Vw.conj().transpose(-1, -2),
                                   check_errors=False)[0]     # (*batch, tau, K)
    return _useful_rows(scheme, W_full, dim=-2)


# ---------------------------------------------------------------------------
# Decode panels: per-survivor-mask setup factored OUT of the decode hot path.
#
# The masked normal equations G X = V_w^H Y depend only on (z, mask), not on
# the worker outputs Y.  A DecodePanel solves them ONCE on the host (LU
# factorisation of G, then the useful rows of G^{-1} V_w^H) and is reused for
# every later step with the same erasure pattern: decode becomes a single
# (mn, K) @ (K, E) product + digit extraction.  Erased workers get zero
# COLUMNS in W, so garbage rows of Y_all are annihilated.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecodePanel:
    """Precomputed decode weights for one (z_points, survivor-mask) pair."""

    mask: np.ndarray       # (K,) 0/1 as built
    W: np.ndarray          # (mn, K) useful rows of G^{-1} V_w^H (host const)

    @property
    def K(self) -> int:
        return self.W.shape[1]


def make_decode_panel(scheme: Scheme, z_all: np.ndarray,
                      mask: Optional[np.ndarray] = None,
                      ridge: float = 0.0) -> DecodePanel:
    """Factor the masked normal equations for a CONCRETE survivor mask.

    Pure host math (scipy/numpy), the same operations in the same order as
    the reference package, so the panel is bit-identical to its panel.
    """
    import scipy.linalg as sl

    z = np.asarray(z_all)
    K = z.shape[0]
    # Binarise: panels model 0/1 survivorship (and the cache keys by
    # support), so fractional weights would silently alias a cached panel.
    m = np.ones(K) if mask is None else (np.asarray(mask) != 0).astype(np.float64)
    if m.shape != (K,):
        raise ValueError(f"mask shape {m.shape} != ({K},)")
    if int(np.sum(m != 0)) < scheme.tau:
        raise ValueError(
            f"only {int(np.sum(m != 0))} survivors < tau={scheme.tau}")
    tau = scheme.tau
    V = z[:, None] ** np.arange(tau)[None, :]               # (K, tau)
    Vw = V * m[:, None]
    G = V.conj().T @ Vw                                      # (tau, tau)
    if ridge:
        G = G + ridge * np.eye(tau, dtype=G.dtype)
    lu_piv = sl.lu_factor(G)
    W_full = sl.lu_solve(lu_piv, Vw.conj().T)                # (tau, K)
    useful = np.asarray(scheme.useful_z_exp()).reshape(-1)
    return DecodePanel(mask=m, W=np.asarray(W_full[useful]))


def decode_with_weights(scheme: Scheme, W: torch.Tensor, Y_all: torch.Tensor,
                        s: float) -> torch.Tensor:
    """Decode from a ready (mn, K) weight panel (plain PyTorch version).

    Y_all: (K, br, bt) ALL worker outputs (garbage where erased) ->
    (m, n, br, bt).  No linear solve inside; erased workers have zero
    columns in W.
    """
    K = Y_all.shape[0]
    Xu = W @ Y_all.reshape(K, -1).to(W.dtype)                # (mn, E)
    return _finish_extract(scheme, Xu, s, tuple(Y_all.shape[1:]))


def decode_with_panel(scheme: Scheme, panel: DecodePanel, Y_all: torch.Tensor,
                      s: float) -> torch.Tensor:
    """Y_all: (K, br, bt) ALL worker outputs (garbage where erased)
    -> (m, n, br, bt) via the precomputed panel.  No linear solve inside."""
    W = torch.as_tensor(panel.W, device=Y_all.device)
    return decode_with_weights(scheme, W, Y_all, s)


class DecodePanelCache:
    """Memoises DecodePanels by erasure pattern.

    For a stable mask (the common case - failures are rare events) this turns
    decode set-up from an O(tau^3) factorisation per call into a dict lookup.
    ``builds`` counts actual factorisations (tests assert cache hits).
    """

    def __init__(self, scheme: Scheme, z_all: np.ndarray, ridge: float = 0.0):
        self.scheme = scheme
        self.z_all = np.asarray(z_all)
        self.ridge = ridge
        self.builds = 0
        self._panels: dict = {}
        self._partial_stacks: dict = {}

    def get(self, mask: Optional[np.ndarray] = None) -> DecodePanel:
        """The panel of a 0/1 survivor ``mask`` (default: all alive),
        factored on its first request (a ``decode.panel.get`` span, with a
        ``decode.panel.build`` child on a miss)."""
        with obs.span("decode.panel.get"):
            K = self.z_all.shape[0]
            m = np.ones(K) if mask is None else np.asarray(mask)
            key = tuple(int(x != 0) for x in m)
            panel = self._panels.get(key)
            if panel is None:
                with obs.span("decode.panel.build"):
                    panel = make_decode_panel(self.scheme, self.z_all, m,
                                              self.ridge)
                self._panels[key] = panel
                self.builds += 1
                obs.count("decode.panel_cache.miss", cache="panel")
            else:
                obs.count("decode.panel_cache.hit", cache="panel")
            return panel

    def extended(self, z_new: np.ndarray) -> "DecodePanelCache":
        """A cache over the Leja-extended point set, seeded from this one.

        ``z_new`` must extend this cache's points (``z_new[:K] == z_all``
        bit-exact).  Every cached panel transfers: a K-pool survivor
        pattern is the (K+g)-pool pattern with all new workers erased, and
        masking the new workers zeroes their Vandermonde rows, so the
        normal-equations matrix G - hence the weights for the old workers -
        is IDENTICAL, and the new workers contribute zero columns.  Seeding
        therefore pads the cached ``W`` panels with zero columns instead of
        refactoring (``builds`` starts at 0; partial stacks transfer the
        same way).

        Raises:
            ValueError: if ``z_new`` does not extend this cache's points.
        """
        z = np.asarray(z_new)
        K = self.z_all.shape[0]
        if z.ndim != 1 or z.shape[0] < K or not np.array_equal(z[:K],
                                                               self.z_all):
            raise ValueError("z_new must extend this cache's point set "
                             "(bit-exact prefix)")
        g = z.shape[0] - K
        cache = DecodePanelCache(self.scheme, z, self.ridge)
        if g == 0:
            cache._panels = dict(self._panels)
            cache._partial_stacks = dict(self._partial_stacks)
            return cache
        pad_mask = np.zeros(g, dtype=np.float64)
        for key, panel in self._panels.items():
            W = np.concatenate(
                [panel.W, np.zeros((panel.W.shape[0], g), panel.W.dtype)],
                axis=1)
            cache._panels[key + (0,) * g] = DecodePanel(
                mask=np.concatenate([panel.mask, pad_mask]), W=W)
        for key, stack in self._partial_stacks.items():
            new_key = ("partial",) + tuple(row + (0,) * g for row in key[1:])
            cache._partial_stacks[new_key] = np.concatenate(
                [stack, np.zeros(stack.shape[:2] + (g,), stack.dtype)],
                axis=2)
        return cache

    def get_partial(self, chunk_masks: np.ndarray) -> np.ndarray:
        """Stacked (Q, mn, K) decode weights for per-chunk survivor masks.

        ``chunk_masks`` is the (Q, K) 0/1 availability matrix of a
        ``PartialPattern``: row c masks the workers whose completed prefix
        covers output-row chunk c.  Per-chunk panels come from :meth:`get`,
        so chunks sharing a survivor set - and binary patterns, where all Q
        rows are identical - share ONE factorisation; the stack itself is
        memoised by the pattern's quantized signature.

        Raises:
            ValueError: if ``chunk_masks`` is not (Q, K).
        """
        with obs.span("decode.panel.get"):
            cm = np.asarray(chunk_masks)
            if cm.ndim != 2 or cm.shape[1] != self.z_all.shape[0]:
                raise ValueError(
                    f"chunk_masks shape {cm.shape} != (Q, {self.z_all.shape[0]})")
            key = ("partial",) + tuple(
                tuple(int(x != 0) for x in row) for row in cm)
            stack = self._partial_stacks.get(key)
            if stack is None:
                stack = np.stack([self.get(row).W for row in cm])
                self._partial_stacks[key] = stack
                obs.count("decode.panel_cache.miss", cache="stack")
            else:
                obs.count("decode.panel_cache.hit", cache="stack")
            return stack
