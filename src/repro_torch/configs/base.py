"""Config registry.

Every architecture module defines CONFIG (the published geometry) and SMOKE
(a reduced same-family config for CPU tests), field for field as the
reference package's ``configs/`` define them.  The port trains and serves
all ten LM architectures; ``paper_matmul`` is the paper's own coded-matmul
experiment (``PaperMatmulConfig``, not a ``ModelConfig``): ``get_config``
serves it and ``list_archs`` leaves it out, as in the reference package.
A module registered as ``repro_torch.configs.<name>`` (as
``examples/torch_train_lm.py`` registers its own) loads by that name too.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.models import ModelConfig

__all__ = ["ARCH_IDS", "ShapeSpec", "SHAPES", "get_config", "get_smoke_config",
           "list_archs", "shape_applicable", "cells"]

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


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (batch, sequence, step kind) cell of the reference's dry-run
    grid (``launch/specs.py`` builds its abstract inputs)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def _module(arch: str):
    try:
        return importlib.import_module(f"repro_torch.configs.{arch}")
    except ModuleNotFoundError:
        raise ValueError(f"unknown architecture {arch!r}") from None


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def list_archs() -> List[str]:
    """The model architectures (every entry but ``paper_matmul``)."""
    return [a for a in ARCH_IDS if a != "paper_matmul"]


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """The reference's rule: ``long_500k`` only for sub-quadratic archs."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention arch has no "
                       "sub-quadratic path (DESIGN.md Sec. 8)")
    return True, ""


def cells(arch: str) -> List[Tuple[str, str]]:
    """The (arch, shape) cells of the dry-run grid for one architecture."""
    cfg = get_config(arch)
    return [(arch, s) for s in SHAPES if shape_applicable(cfg, s)[0]]
