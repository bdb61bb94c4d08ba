"""The few calls into the program that several entries share."""
from __future__ import annotations


def entry_bound_L(cfg: dict) -> int:
    """The paper's bound on every entry of C: v * max|A| * max|B| + 1."""
    return cfg["v"] * cfg["entry_max"] * cfg["entry_max"] + 1


def make_plan(cfg: dict):
    """The configuration's plan, through the port's own ``make_plan``."""
    from repro_torch.core import make_plan as port_make_plan

    return port_make_plan(cfg["scheme"], cfg["p"], cfg["m"], cfg["n"],
                          K=cfg["K"], L=entry_bound_L(cfg),
                          p_prime=cfg.get("p_prime", 1), points=cfg["points"])


def mask_key(mask) -> tuple:
    """A survivor mask as a tuple of 0/1."""
    return tuple(int(x != 0) for x in mask)


def mark_worker_stage(cm) -> None:
    """Put every call of the facade's worker stage (its executor's
    ``worker_products``: encode and the K block products) in a profiler
    range ``stage.worker``, which claims the device work launched in it."""
    from coded_bench import trace as tracing

    executor = cm._executor
    if not hasattr(executor.worker_products, "__wrapped__"):
        tracing.span_method(executor, "worker_products", "stage.worker")
