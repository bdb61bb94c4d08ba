"""Config registry.

Every architecture module defines CONFIG (the published geometry) and SMOKE
(a reduced same-family config for CPU tests), field for field as the
reference package's ``configs/`` define them.  The port serves the
architectures in ``PORTED_ARCHS``; the others (``musicgen_medium`` and
``qwen2_vl_72b``, which need embedding input, sinusoidal or multimodal
positions) raise ``NotImplementedError`` until their slice lands
(ROADMAP.md queue 1, item 8.4).  ``paper_matmul`` is
the paper's own coded-matmul experiment (``PaperMatmulConfig``, not a
``ModelConfig``): ``get_config`` serves it and ``list_archs`` leaves it out,
as in the reference package.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models import ModelConfig

__all__ = ["ARCH_IDS", "PORTED_ARCHS", "get_config", "get_smoke_config",
           "list_archs"]

ARCH_IDS = (
    "jamba_1_5_large_398b",
    "qwen3_moe_235b_a22b",
    "qwen2_moe_a2_7b",
    "qwen3_0_6b",
    "qwen2_0_5b",
    "gemma3_12b",
    "granite_3_8b",
    "rwkv6_3b",
    "musicgen_medium",
    "qwen2_vl_72b",
    "paper_matmul",
)
PORTED_ARCHS = ("jamba_1_5_large_398b", "qwen3_moe_235b_a22b", "qwen2_moe_a2_7b",
                "qwen3_0_6b", "qwen2_0_5b", "gemma3_12b", "granite_3_8b",
                "rwkv6_3b", "paper_matmul")


def _module(arch: str):
    if arch not in PORTED_ARCHS:
        if arch in ARCH_IDS:
            raise NotImplementedError(
                f"{arch} is not ported to repro_torch yet; the port serves "
                f"{PORTED_ARCHS} (see ROADMAP.md, queue 1, item 8.4)")
        raise ValueError(f"unknown architecture {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def list_archs() -> List[str]:
    """The model architectures the port serves."""
    return [a for a in PORTED_ARCHS if a != "paper_matmul"]
