"""The coded product C = A^T B of bounded integer matrices: its inputs, the
work a request counts, and the comparison that decides ``correct``.

Set-up makes ``operand_pool`` pairs (A, B) on the device from the seed,
entries uniform on ``{0..entry_max}`` of the configuration.  The window's
answers are sampled as they come (a uniform reservoir drawn from the seed,
plus the answer whose survivor set amplifies rounding most); once the
window has closed and the program is freed, each kept answer is compared
whole with the plain reference, exactly: the product is integer and
float64 holds it.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from coded_bench import accounting, reference
from coded_bench.traffic import seed_words

KEEP = 8            # answers kept by uniform reservoir sampling


def make_operands(pool: int, cfg: dict, seed: int, device: torch.device,
                  dtype=torch.float64) -> tuple:
    """(A, B): (pool, v, r) and (pool, v, t) integer-valued tensors drawn on
    the device from the seed, in two calls."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_words(seed, 1).generate_state(1, np.uint64)[0]) >> 1)
    hi = int(cfg["entry_max"]) + 1
    A = torch.randint(0, hi, (pool, cfg["v"], cfg["r"]), generator=gen,
                      device=device, dtype=dtype)
    B = torch.randint(0, hi, (pool, cfg["v"], cfg["t"]), generator=gen,
                      device=device, dtype=dtype)
    return A, B


class Sample:
    """A uniform reservoir of answers plus the one whose survivor set has the
    largest decode gain (gains tabled in set-up for every survivor set)."""

    def __init__(self, seed: int, z, taus):
        self.rng = np.random.default_rng(seed_words(seed, 4))
        self.kept: list = []
        self.worst = None
        self.gains = {(tau, mask): reference.decode_gain(z, tau, [mask])
                      for tau in set(taus)
                      for mask in itertools.product((0, 1), repeat=len(z))
                      if sum(mask) >= tau}

    def offer(self, i: int, pair: int, C, tau: int, masks) -> None:
        item = (i, pair, C)
        if len(self.kept) < KEEP:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < KEEP:
                self.kept[j] = item
        g = max(self.gains.get((tau, mask), float("inf")) for mask in masks)
        if self.worst is None or g > self.worst[0]:
            self.worst = (g, item)

    def items(self) -> list:
        items = {i: (i, pair, C) for i, pair, C in self.kept}
        if self.worst is not None:
            i, pair, C = self.worst[1]
            items[i] = (i, pair, C)
        return [items[i] for i in sorted(items)]


class Problem:
    """One run's operands and kept answers."""

    def __init__(self, ctx):
        self.cfg = ctx.cfg
        self.A, self.B = make_operands(int(ctx.mix["operand_pool"]), ctx.cfg,
                                       ctx.seed, ctx.device)
        self.seed = ctx.seed

    def inputs(self, pair: int = 0) -> tuple:
        """The operands of set ``pair``."""
        return self.A[pair], self.B[pair]

    def flops_per_request(self) -> float:
        """The counted work of one request (``accounting.request_flops``)."""
        return accounting.request_flops(self.cfg)

    def start(self, taus) -> None:
        """Table the decode gains of every survivor set the entry can serve."""
        self.sample = Sample(self.seed, reference.points(self.cfg["points"],
                                                         self.cfg["K"]), taus)

    def keep(self, req, answer, served) -> None:
        """Offer an answer to the sample; ``served`` is the entry's
        (tau, survivor masks) of the request."""
        tau, masks = served
        self.sample.offer(req.index, req.pair, answer, tau, masks)

    def judge(self, failed: int) -> tuple:
        """(correct, checks): each number compared with its limit."""
        refs: dict = {}
        gap = 0.0
        kept = self.sample.items()
        for _, pair, C in kept:
            if pair not in refs:
                refs[pair] = reference.product(self.A[pair], self.B[pair])
            gap = max(gap, reference.compare(C, refs[pair]))
        checks = {"max_abs_err": {"value": gap, "limit": 0.0},
                  "failed": {"value": failed, "limit": 0},
                  "compared": {"value": len(kept), "at_least": 1}}
        return gap <= 0.0 and failed == 0 and len(kept) >= 1, checks
