"""Analytic model statistics: parameter counts and MODEL_FLOPS.

MODEL_FLOPS convention (the roofline's useful FLOPs), as in the reference:
  train    6 * N_active * D            (forward 2ND + backward 4ND)
  prefill  2 * N_active * D
  decode   2 * N_active * B            (one token per sequence)
with N_active the non-embedding parameters, MoE experts counted at
top_k / E.  The attention-score FLOPs (not in 6ND) are reported
separately.  Counts come from ``param_shapes`` (meta tensors: nothing is
allocated).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.models.lm import ModelConfig, param_shapes

__all__ = ["param_counts", "model_flops", "attention_score_flops"]


def _leaf_sizes(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_sizes(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaf_sizes(v, path + (str(i),))
    else:
        yield path, tree.numel()


def _is_moe_position(cfg: ModelConfig, path: Tuple[str, ...]) -> bool:
    try:
        pos = int(path[path.index("blocks") + 1])
    except (ValueError, IndexError):
        return False
    return cfg.pattern[pos][1] == "moe"


def param_counts(cfg: ModelConfig) -> Dict[str, float]:
    """total / embedding / non_embedding / active (MoE experts scaled by
    top_k / n_experts)."""
    total = emb = active = 0.0
    moe_scale = 1.0 if cfg.moe is None else cfg.moe.top_k / cfg.moe.n_experts
    for path, size in _leaf_sizes(param_shapes(cfg)):
        total += size
        if "embed" in path or "lm_head" in path:
            emb += size
            continue
        # the experts' tensors; a dense MLP has the same names, so only MoE
        # pattern positions of a MoE config count at top_k / E
        in_experts = ("ffn" in path and path[-1] in ("w_gate", "w_up", "w_down")
                      and cfg.moe is not None and "blocks" in path)
        active += size * moe_scale if in_experts and _is_moe_position(cfg, path) else size
    return {"total": total, "embedding": emb, "non_embedding": total - emb,
            "active": active}


def model_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    """The useful FLOPs of a train step, a prefill or a decode step."""
    n = param_counts(cfg)["active"]
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    if kind == "decode":
        return 2.0 * n * batch
    raise ValueError(kind)


def attention_score_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    """QK^T + PV FLOPs (causal: about S^2/2 each; windowed: about S*W)."""
    n_attn = sum(1 for m, _ in cfg.pattern if m == "attn")
    n_local = sum(1 for m, _ in cfg.pattern if m == "attn_local")
    reps = cfg.n_groups
    d_attn = cfg.n_heads * cfg.d_head
    w = cfg.window or seq
    if kind in ("train", "prefill"):
        full = 2 * 2 * (seq * seq / 2) * d_attn * batch
        local = 2 * 2 * (seq * min(w, seq)) * d_attn * batch
        fwd = reps * (n_attn * full + n_local * local)
        return 3 * fwd if kind == "train" else fwd
    if kind == "decode":
        full = 2 * 2 * seq * d_attn * batch
        local = 2 * 2 * min(w, seq) * d_attn * batch
        return reps * (n_attn * full + n_local * local)
    raise ValueError(kind)
