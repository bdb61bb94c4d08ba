"""Work of one coded request, counted from the configuration's shapes.

A request runs every stage for all K workers: each worker's encoded block
product is computed before the master learns who straggles, so the count
is the deployment's and not only the survivors'.  Each input byte is
counted read once and each output byte written once.
"""
from __future__ import annotations

from coded_bench import peaks


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def blocks(cfg: dict) -> tuple:
    """(bv, br, bt): the block sizes of the p x m grid of A and p x n of B."""
    return (_ceil_div(cfg["v"], cfg["p"]), _ceil_div(cfg["r"], cfg["m"]),
            _ceil_div(cfg["t"], cfg["n"]))


def worker_stage_flops(cfg: dict) -> float:
    """Encode of A and B for K workers plus their K block products."""
    bv, br, bt = blocks(cfg)
    K, p, m, n = cfg["K"], cfg["p"], cfg["m"], cfg["n"]
    products = K * 2.0 * bv * br * bt
    encode = K * 2.0 * (p * m * bv * br + p * n * bv * bt)
    return products + encode


def worker_stage_bytes(cfg: dict, itemsize: int = 8) -> float:
    """A and B read once, the K block products written once."""
    _, br, bt = blocks(cfg)
    return itemsize * (cfg["v"] * cfg["r"] + cfg["v"] * cfg["t"]
                       + cfg["K"] * br * bt)


def decode_flops(cfg: dict) -> float:
    """The (mn, K) decode panel applied to the K products."""
    _, br, bt = blocks(cfg)
    return 2.0 * cfg["m"] * cfg["n"] * cfg["K"] * br * bt


def decode_bytes(cfg: dict, itemsize: int = 8) -> float:
    """The K products read once and C written once."""
    _, br, bt = blocks(cfg)
    return itemsize * (cfg["K"] * br * bt + cfg["r"] * cfg["t"])


def request_flops(cfg: dict) -> float:
    """Everything one request computes: encode, K products, decode."""
    return worker_stage_flops(cfg) + decode_flops(cfg)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peaks.FP64_TENSOR_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
