"""Numeric-headroom analysis (paper Sec. III-D and Sec. IV).

The bounded-entry schemes require every decoded coefficient magnitude to be
exactly representable: |X| <= (2L)^{p/p'}/2 must stay within the floating
mantissa so that round() recovers the integer exactly.  This module computes
safe (L, s, p') regions per dtype and picks the smallest p' (lowest tau)
that is numerically safe - the paper's precision/threshold tradeoff as an
executable policy.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.schemes import make_scheme

__all__ = [
    "mantissa_bits",
    "conservative_L",
    "choose_s",
    "max_abs_coefficient",
    "is_safe",
    "BoundsReport",
    "plan_p_prime",
]

_MANTISSA = {
    "float64": 53,
    "float32": 24,
    "bfloat16": 8,
    "complex128": 53,
    "complex64": 24,
}


def mantissa_bits(dtype) -> int:
    if isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        name = np.dtype(dtype).name
    try:
        return _MANTISSA[str(name)]
    except KeyError:
        raise ValueError(f"no mantissa entry for dtype {dtype!r}")


def conservative_L(v: int, max_a: float, max_b: float) -> int:
    """Paper Sec. III-D: L = v * max|A| * max|B| + 1 bounds every C entry and
    every interference product (each is an inner product of length <= v)."""
    return int(v * max_a * max_b) + 1


def choose_s(L: float, power_of_two: bool = True) -> int:
    """Smallest valid base s >= 2L; power of two preferred (exact mod by
    bit-shift, and exact fp multiplication by s)."""
    s_min = 2 * L
    if not power_of_two:
        return int(math.ceil(s_min))
    return 1 << int(math.ceil(math.log2(s_min)))


def max_abs_coefficient(L: float, s: float, digit_depth: int) -> float:
    """Bound on |X_ij|: sum over digits -D..D of (L-1) s^d."""
    return (L - 1) * sum(float(s) ** d for d in range(-digit_depth, digit_depth + 1))


def is_safe(L: float, s: float, digit_depth: int, dtype, tau: int = 1,
            conditioning_slack_bits: float = 4.0) -> bool:
    """True if decode is exact for this (L, s, digit depth, dtype).

    Exact rounding needs the interpolated X to carry absolute error < 1/2.
    We require max|Y| ~ tau * max|X| (|z| <= 1) to sit
    ``conditioning_slack_bits`` below the mantissa, leaving headroom for the
    Vandermonde solve's error amplification.  The slack is a policy knob;
    Table I reproduction uses the raw (0-slack) check.
    """
    mx = max_abs_coefficient(L, s, digit_depth) * max(tau, 1)
    if mx <= 0:
        return True
    return math.log2(mx) + conditioning_slack_bits <= mantissa_bits(dtype)


@dataclasses.dataclass(frozen=True)
class BoundsReport:
    L: int
    s: int
    p_prime: int
    tau: int
    digit_depth: int
    max_abs_X: float
    mantissa: int
    safe: bool


def plan_p_prime(
    p: int, m: int, n: int, L: int, dtype="float64",
    power_of_two_s: bool = True,
    conditioning_slack_bits: float = 4.0,
) -> BoundsReport:
    """Pick the smallest divisor p' of p whose tradeoff scheme is numerically
    safe for ``dtype``; falls back to p'=p (pure polynomial code regime,
    always safe digit-wise) if none is.

    This is the paper's Sec. IV tradeoff surfaced as an executable planner:
    small p' -> low recovery threshold but tall digit stacks; large p' ->
    shallow digits (small |X|) but high threshold.
    """
    s = choose_s(L, power_of_two_s)
    divisors = [d for d in range(1, p + 1) if p % d == 0]
    chosen = None
    for pp in divisors:
        sch = make_scheme("tradeoff", p, m, n, p_prime=pp)
        if is_safe(L, s, sch.digit_depth, dtype, tau=sch.tau,
                   conditioning_slack_bits=conditioning_slack_bits):
            chosen = (pp, sch)
            break
    if chosen is None:
        pp = p
        chosen = (pp, make_scheme("tradeoff", p, m, n, p_prime=pp))
    pp, sch = chosen
    return BoundsReport(
        L=L, s=s, p_prime=pp, tau=sch.tau, digit_depth=sch.digit_depth,
        max_abs_X=max_abs_coefficient(L, s, sch.digit_depth),
        mantissa=mantissa_bits(dtype),
        safe=is_safe(L, s, sch.digit_depth, dtype, tau=sch.tau,
                     conditioning_slack_bits=conditioning_slack_bits),
    )
