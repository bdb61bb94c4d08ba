"""The LM stack: a pattern of (mixer, ffn) blocks, served by prefill + decode.

An architecture is a repeating PATTERN of (mixer, ffn) blocks (Jamba's
1:7 attention:mamba interleave, RWKV's single (rwkv, rwkv_cmix) block)
repeated ``n_groups`` times.  The reference scans over groups with stacked
parameters; here the model is an ``nn.Module`` holding one ``Block`` per
layer, in execution order (layer ``g * len(pattern) + p`` is pattern
position p of group g), walked by a Python loop.

Three execution paths share the parameters:
  train_loss   - full-sequence forward and the chunked cross entropy, each
                 pattern group checkpointed (``cfg.remat``)
  prefill      - full-sequence forward, returns the last logits and the
                 serve cache (one dict of tensors per layer)
  decode_step  - one token, consumes and updates the cache

Mixers: ``attn`` and ``attn_local`` (sliding window, with a ring cache of
``window`` slots), ``mamba``, ``rwkv``.  FFNs: ``mlp``, ``moe`` (the dense
single-device path), ``rwkv_cmix``.  Positions: ``rope``, ``mrope``
(three position ids a token), ``sinusoidal`` (added to the input) or none.
Input: token ids, or embeddings (``input_mode="embeds"``: the stubbed
frontends of MusicGen and Qwen2-VL, with an untied ``lm_head`` and no
``embed`` table).
"""
from __future__ import annotations

import dataclasses
import functools
import types
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.core.numerics import resolve_device
from repro_torch.distributed.sharding import (
    current_rules,
    fsdp_gathered,
    recompute_context,
    shard,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.moe import MoEConfig, apply_moe, init_moe, moe_shapes

__all__ = ["ModelConfig", "Block", "LM", "init_params", "param_shapes",
           "params_from_jax", "grads_to_numpy", "cache_shapes", "init_cache",
           "cache_from_jax", "cache_to_numpy", "forward_hidden", "train_loss",
           "prefill", "decode_step"]

_MIXERS = ("attn", "attn_local", "mamba", "rwkv")
_FFNS = ("mlp", "moe", "rwkv_cmix")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    pattern: Tuple[Tuple[str, str], ...] = (("attn", "mlp"),)
    window: Optional[int] = None          # sliding window for attn_local
    qk_norm: bool = False
    qkv_bias: bool = False
    act: str = "swiglu"                   # swiglu | gelu
    pos: str = "rope"                     # rope | mrope | sinusoidal | none
    rope_theta: float = 1e6
    mrope_sections: Tuple[int, ...] = ()
    moe: Optional[MoEConfig] = None
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_dconv: int = 4
    mamba_kernel: bool = False   # prefill scan through the selective-scan kernel
    rwkv_kernel: bool = False    # prefill WKV through the WKV kernel
    rwkv_head_dim: int = 64
    input_mode: str = "tokens"            # tokens | embeds (stubbed frontend)
    tie_embeddings: bool = True
    eps: float = 1e-6
    dtype: str = "bfloat16"
    tp_pad: int = 16                      # pad rwkv heads to divide tp
    remat: bool = True
    remat_policy: str = "none"            # none | dots (save matmul outputs)
    proj_first: bool = False              # project-then-reshard attention
    q_chunk: int = 512
    kv_chunk: int = 1024
    loss_chunk: int = 512
    aux_coef: float = 0.01
    sub_quadratic: bool = False           # eligible for long_500k

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.name}: n_layers={self.n_layers} vs pattern {len(self.pattern)}"

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.d_head


def _check(cfg: ModelConfig) -> None:
    """Raises ValueError on a block kind, position or input mode the stack
    does not know."""
    for mixer, ffn in cfg.pattern:
        if mixer not in _MIXERS or ffn not in _FFNS:
            raise ValueError(f"{cfg.name}: unknown block ({mixer!r}, {ffn!r})")
    if cfg.pos not in ("rope", "mrope", "sinusoidal", "none"):
        raise ValueError(f"{cfg.name}: unknown positions {cfg.pos!r}")
    if cfg.input_mode not in ("tokens", "embeds"):
        raise ValueError(f"{cfg.name}: unknown input mode {cfg.input_mode!r}")


# ---------------------------------------------------------------------------
# parameters


def _param_dict(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class Block(nn.Module):
    """One layer: ``norm1``, ``mixer``, ``norm2`` and ``ffn`` parameter dicts
    (the reference's names), and the layer's kinds."""

    def __init__(self, mixer: str, ffn: str, params: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.mixer_kind, self.ffn_kind = mixer, ffn
        for name in ("norm1", "mixer", "norm2", "ffn"):
            setattr(self, name, _param_dict(params[name]))


class LM(nn.Module):
    """The model's parameters: ``embed`` (token input only), ``lm_head``
    (embedding input, or untied embeddings), ``blocks`` in execution order,
    and ``final_norm``; ``pattern_len`` blocks make a pattern group (layer
    ``g * pattern_len + p`` is position p of group g, the reference's
    stacking).  Built with ``requires_grad=False``; training turns
    gradients on (``make_train_step``)."""

    def __init__(self, embed, lm_head, blocks: List[Block], final_norm,
                 pattern_len: int = 1):
        super().__init__()
        self.pattern_len = pattern_len
        self.embed = None if embed is None else _param_dict(embed)
        self.lm_head = None if lm_head is None else _param_dict(lm_head)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _param_dict(final_norm)


def _has_embed(cfg: ModelConfig) -> bool:
    return cfg.input_mode == "tokens"


def _has_lm_head(cfg: ModelConfig) -> bool:
    return cfg.input_mode == "embeds" or not cfg.tie_embeddings


def _head_table(params: LM, cfg: ModelConfig) -> torch.Tensor:
    """The output head: the embedding table when tied to token input, else
    ``lm_head``."""
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        return params.embed["table"]
    return params.lm_head["table"]


def _init_mixer(cfg: ModelConfig, mixer: str, gen: torch.Generator):
    dt = cfg.param_dtype
    if mixer in ("attn", "attn_local"):
        return attn_mod.init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.d_head, cfg.qk_norm, cfg.qkv_bias, dt)
    if mixer == "mamba":
        return mamba_mod.init_mamba(gen, cfg.d_model, expand=cfg.mamba_expand,
                                    d_state=cfg.mamba_d_state,
                                    dconv=cfg.mamba_dconv, dtype=dt)
    return rwkv_mod.init_rwkv_tmix(gen, cfg.d_model, head_dim=cfg.rwkv_head_dim,
                                   tp_pad=cfg.tp_pad, dtype=dt)


def _init_ffn(cfg: ModelConfig, ffn: str, gen: torch.Generator):
    if ffn == "mlp":
        return L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.param_dtype)
    if ffn == "moe":
        return init_moe(gen, cfg.d_model, cfg.moe, ep_size=cfg.tp_pad,
                        dtype=cfg.param_dtype)
    return rwkv_mod.init_rwkv_cmix(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype)


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> LM:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the CUDA card unless the caller asks for the CPU), laid out and scaled
    as the reference's ``init_params`` lays them out (its values come from
    JAX's generator; carry them across with :func:`params_from_jax`).

    Raises:
        RuntimeError: with no device given and no CUDA card present.
        ValueError: for a config with an unknown block kind or mode.
    """
    _check(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    embed = (L.init_embedding(gen, cfg.vocab, d, cfg.param_dtype)
             if _has_embed(cfg) else None)
    lm_head = (L.init_embedding(gen, cfg.vocab, d, cfg.param_dtype)
               if _has_lm_head(cfg) else None)
    blocks = []
    for _ in range(cfg.n_groups):
        for mixer, ffn in cfg.pattern:
            blocks.append(Block(mixer, ffn, {
                "norm1": L.init_rmsnorm(d, device=dev),
                "mixer": _init_mixer(cfg, mixer, gen),
                "norm2": L.init_rmsnorm(d, device=dev),
                "ffn": _init_ffn(cfg, ffn, gen),
            }))
    return LM(embed, lm_head, blocks, L.init_rmsnorm(d, device=dev), len(cfg.pattern))


def _mixer_shapes(cfg: ModelConfig, mixer: str) -> dict:
    dt = cfg.param_dtype
    if mixer in ("attn", "attn_local"):
        return attn_mod.attn_shapes(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                    cfg.qk_norm, cfg.qkv_bias, dt)
    if mixer == "mamba":
        return mamba_mod.mamba_shapes(cfg.d_model, expand=cfg.mamba_expand,
                                      d_state=cfg.mamba_d_state, dconv=cfg.mamba_dconv,
                                      dtype=dt)
    return rwkv_mod.rwkv_tmix_shapes(cfg.d_model, head_dim=cfg.rwkv_head_dim,
                                     tp_pad=cfg.tp_pad, dtype=dt)


def _ffn_shapes(cfg: ModelConfig, ffn: str) -> dict:
    if ffn == "mlp":
        return L.mlp_shapes(cfg.d_model, cfg.d_ff, cfg.act, cfg.param_dtype)
    if ffn == "moe":
        return moe_shapes(cfg.d_model, cfg.moe, ep_size=cfg.tp_pad, dtype=cfg.param_dtype)
    return rwkv_mod.rwkv_cmix_shapes(cfg.d_model, cfg.d_ff, cfg.param_dtype)


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameters as meta-device tensors (no memory), in the reference's
    tree: ``embed`` / ``lm_head`` / ``final_norm`` dicts and ``blocks``, one
    dict per pattern position with leaves stacked ``(n_groups, ...)``.  The
    blocks' dicts list their keys sorted, as the reference's stacking
    (``jax.tree.map``) leaves them, so sums over the leaves add in its
    order."""
    _check(cfg)

    def meta(shapes: dict, lead=()) -> dict:
        return {k: torch.empty(lead + tuple(shape), dtype=dt, device="meta")
                for k, (shape, dt) in sorted(shapes.items())}

    vd = {"table": ((cfg.vocab, cfg.d_model), cfg.param_dtype)}
    norm = {"scale": ((cfg.d_model,), torch.float32)}
    tree = {}
    if _has_embed(cfg):
        tree["embed"] = meta(vd)
    if _has_lm_head(cfg):
        tree["lm_head"] = meta(vd)
    G = (cfg.n_groups,)
    tree["blocks"] = tuple(
        {"ffn": meta(_ffn_shapes(cfg, ffn), G), "mixer": meta(_mixer_shapes(cfg, mixer), G),
         "norm1": meta(norm, G), "norm2": meta(norm, G)}
        for mixer, ffn in cfg.pattern)
    tree["final_norm"] = meta(norm)
    return tree


def _from_numpy(x, device) -> torch.Tensor:
    """A numpy leaf as a tensor, bit for bit.  bfloat16 leaves (``ml_dtypes``
    arrays, which ``torch.from_numpy`` refuses) go through float32, which
    holds every bfloat16 value exactly."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a copy: the leaf may be read-only


def params_from_jax(cfg: ModelConfig, tree, *, device=None) -> LM:
    """The port's parameters from the reference's parameter pytree, given as
    numpy arrays with the reference's nesting: ``blocks`` is one dict per
    pattern position with leaves stacked ``(n_groups, ...)``.  Layer
    ``g * len(pattern) + p`` of the port is group g of position p.  Every
    value comes across bit for bit."""
    _check(cfg)
    dev = resolve_device(device)

    def leaves(d, g=None):
        return {k: _from_numpy(v if g is None else np.asarray(v)[g], dev)
                for k, v in d.items()}

    blocks = []
    for g in range(cfg.n_groups):
        for p, (mixer, ffn) in enumerate(cfg.pattern):
            pos = tree["blocks"][p]
            blocks.append(Block(mixer, ffn, {name: leaves(pos[name], g)
                                             for name in ("norm1", "mixer", "norm2", "ffn")}))
    embed = leaves(tree["embed"]) if "embed" in tree else None
    lm_head = leaves(tree["lm_head"]) if "lm_head" in tree else None
    return LM(embed, lm_head, blocks, leaves(tree["final_norm"]), len(cfg.pattern))


def grads_to_numpy(cfg: ModelConfig, params: LM) -> dict:
    """The parameters' gradients (``.grad``) in the reference's tree, the
    inverse of :func:`params_from_jax`'s layout: ``blocks`` one dict per
    pattern position with leaves stacked ``(n_groups, ...)``, as float32
    numpy arrays (bf16 gradients convert exactly)."""
    def grad(p: torch.Tensor) -> np.ndarray:
        return p.grad.float().cpu().numpy()

    tree = {top: {k: grad(v) for k, v in getattr(params, top).items()}
            for top in ("embed", "lm_head", "final_norm") if getattr(params, top) is not None}
    P = len(cfg.pattern)
    tree["blocks"] = tuple(
        {part: {name: np.stack([grad(getattr(params.blocks[g * P + p], part)[name])
                                for g in range(cfg.n_groups)])
                for name in getattr(params.blocks[p], part)}
         for part in ("norm1", "mixer", "norm2", "ffn")}
        for p in range(P))
    return tree


# ---------------------------------------------------------------------------
# the serve cache: one dict of tensors per layer


def _layer_cache_shapes(cfg: ModelConfig, mixer: str, B: int, S_max: int) -> dict:
    if mixer in ("attn", "attn_local"):
        # a local layer keeps a ring of the last ``window`` tokens
        S_c = min(cfg.window, S_max) if mixer == "attn_local" else S_max
        kv = ((B, S_c, cfg.n_kv_heads, cfg.d_head), cfg.param_dtype)
        return {"k": kv, "v": kv}
    if mixer == "mamba":
        return mamba_mod.mamba_state_shapes(B, cfg.d_model, expand=cfg.mamba_expand,
                                            d_state=cfg.mamba_d_state,
                                            dconv=cfg.mamba_dconv)
    return rwkv_mod.rwkv_state_shapes(B, cfg.d_model, head_dim=cfg.rwkv_head_dim,
                                      tp_pad=cfg.tp_pad)


def cache_shapes(cfg: ModelConfig, B: int, S_max: int) -> List[dict]:
    """Per layer, {name: (shape, dtype)} of the serve cache."""
    _check(cfg)
    return [_layer_cache_shapes(cfg, mixer, B, S_max)
            for _ in range(cfg.n_groups) for mixer, _ in cfg.pattern]


def init_cache(cfg: ModelConfig, B: int, S_max: int, *, device=None) -> List[dict]:
    """A zero serve cache on ``device`` (the CUDA card unless asked)."""
    dev = resolve_device(device)
    return [{k: torch.zeros(shape, dtype=dt, device=dev) for k, (shape, dt) in one.items()}
            for one in cache_shapes(cfg, B, S_max)]


def cache_from_jax(cfg: ModelConfig, tree, *, device=None) -> List[dict]:
    """The port's cache from the reference's (one dict per pattern
    position, leaves stacked ``(n_groups, ...)``, as numpy arrays)."""
    dev = resolve_device(device)
    return [{k: _from_numpy(np.asarray(v)[g], dev) for k, v in tree[p].items()}
            for g in range(cfg.n_groups) for p in range(len(cfg.pattern))]


def cache_to_numpy(cfg: ModelConfig, cache: List[dict]) -> tuple:
    """The cache in the reference's layout (one dict per pattern position,
    leaves stacked ``(n_groups, ...)``) as float32 numpy arrays (numpy has
    no bfloat16; the conversion is exact)."""
    P = len(cfg.pattern)
    return tuple(
        {k: np.stack([cache[g * P + p][k].float().cpu().numpy()
                      for g in range(cfg.n_groups)])
         for k in cache[p]}
        for p in range(P))


# ---------------------------------------------------------------------------
# input and position embeddings


def _embed_input(cfg: ModelConfig, params: LM, batch, pos_offset: int = 0) -> torch.Tensor:
    """The first residual (B, S, d): the token embeddings, or
    ``batch["embeds"]`` cast to the param dtype; with sinusoidal positions
    the table of positions ``pos_offset + [0, S)``, float32 cast to x's
    dtype, is added."""
    if cfg.input_mode == "tokens":
        x = L.embed(params.embed, batch["tokens"])
    else:
        x = shard(batch["embeds"].to(cfg.param_dtype), "dp", "sp", None)
    if cfg.pos == "sinusoidal":
        pe = L.sinusoidal_positions(x.shape[1], cfg.d_model, pos_offset, device=x.device)
        x = x + pe.to(x.dtype)[None]
    return x


def _cos_sin(cfg: ModelConfig, batch, S: int, device, pos_offset: int = 0):
    """The rotation of positions ``pos_offset + [0, S)``: cos/sin (S,
    d_head/2) float32 for ``rope``; for ``mrope`` of ``batch["pos_ids"]``
    (3, B, S) plus ``pos_offset``, (B, S, d_head/2); (None, None) otherwise
    (sinusoidal positions are added at the input)."""
    if cfg.pos == "rope":
        positions = torch.arange(S, device=device) + pos_offset
        return L.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta)
    if cfg.pos == "mrope":
        return L.mrope_cos_sin(batch["pos_ids"] + pos_offset, cfg.mrope_sections,
                               cfg.d_head, cfg.rope_theta)
    return None, None


# ---------------------------------------------------------------------------
# training


_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _for_compute(block: "Block"):
    """A block as its layer computes with it.  Without sharding rules, the
    block.  Under rules its parameters FSDP-gathered over the data
    dimensions (their tp split kept), as FSDP unshards a layer for its
    forward (the reference's compiler gathers them so; the gather's backward
    reduce-scatters the gradients to the shards), except the MoE experts,
    which the expert-parallel body gathers itself."""
    if current_rules() is None:
        return block
    moe = block.ffn_kind == "moe"
    return types.SimpleNamespace(
        mixer_kind=block.mixer_kind, ffn_kind=block.ffn_kind,
        **{part: {k: (v if moe and part == "ffn" and k in _EXPERT_LEAVES
                      else fsdp_gathered(v))
                  for k, v in getattr(block, part).items()}
           for part in ("norm1", "mixer", "norm2", "ffn")})


def _ffn(cfg: ModelConfig, block: "Block", h: torch.Tensor, state=None):
    """Returns (y, new ffn state or {}, the MoE aux loss or 0.0).  Serving
    drops the aux loss, as the reference does; training adds it to the
    loss."""
    if block.ffn_kind == "mlp":
        return L.apply_mlp(block.ffn, h, cfg.act), {}, 0.0
    if block.ffn_kind == "moe":
        y, aux = apply_moe(block.ffn, h, cfg.moe)
        return y, {}, aux
    y, state = rwkv_mod.rwkv_cmix_forward(block.ffn, h, state=state, return_state=True)
    return y, state, 0.0


def _window(cfg: ModelConfig, mixer: str) -> Optional[int]:
    return cfg.window if mixer == "attn_local" else None


def _mixer_train(cfg: ModelConfig, block: "Block", h: torch.Tensor, cos_sin):
    if block.mixer_kind in ("attn", "attn_local"):
        return attn_mod.attn_forward(block.mixer, h, cos_sin,
                                     window=_window(cfg, block.mixer_kind),
                                     q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    if block.mixer_kind == "mamba":
        return mamba_mod.mamba_forward(block.mixer, h, use_kernel=cfg.mamba_kernel)
    return rwkv_mod.rwkv_tmix_forward(block.mixer, h, head_dim=cfg.rwkv_head_dim,
                                      use_kernel=cfg.rwkv_kernel)


def _group_train(cfg: ModelConfig, blocks, cos_sin, x: torch.Tensor):
    """One pattern group: (x, the group's MoE aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in map(_for_compute, blocks):
        h = L.rmsnorm(block.norm1, x, cfg.eps)
        x = x + _mixer_train(cfg, block, h, cos_sin)
        h = L.rmsnorm(block.norm2, x, cfg.eps)
        y, _, a = _ffn(cfg, block, h)
        x = x + y
        aux = aux + a
    return x, aux


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the matrix products' outputs, recompute
    the rest (the reference's ``dots_with_no_batch_dims_saveable``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def forward_hidden(params: LM, cfg: ModelConfig, batch):
    """Full-sequence forward to the final norm: (x (B, S, d), the MoE aux
    loss summed over layers, float32).  With ``cfg.remat`` each pattern
    group runs under ``torch.utils.checkpoint`` (non-reentrant), as the
    reference checkpoints its scan body: the backward reruns the group's
    forward, the scan kernels included, and ``remat_policy="dots"`` keeps
    the matrix products' outputs instead of recomputing them."""
    _check(cfg)
    x = _embed_input(cfg, params, batch)
    cos_sin = _cos_sin(cfg, batch, x.shape[1], x.device)
    P = len(cfg.pattern)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.n_groups):
        body = functools.partial(_group_train, cfg, params.blocks[g * P:(g + 1) * P], cos_sin)
        if cfg.remat:
            policy = (functools.partial(create_selective_checkpoint_contexts, _save_dots)
                      if cfg.remat_policy == "dots" else None)
            x, a = checkpoint(body, x, use_reentrant=False,
                              context_fn=recompute_context(policy))
        else:
            x, a = body(x)
        aux = aux + a
    return L.rmsnorm(params.final_norm, x, cfg.eps), aux


def train_loss(params: LM, cfg: ModelConfig, batch) -> torch.Tensor:
    """Scalar LM loss (float32): the chunked cross entropy of ``batch
    ["labels"]`` plus, for MoE configs, ``aux_coef`` times the aux loss per
    layer.  batch: {"tokens" (B, S)} or {"embeds" (B, S, d)} (+ "pos_ids"
    (3, B, S) for mrope), and "labels" (B, S)."""
    x, aux = forward_hidden(params, cfg, batch)
    x = shard(x, "dp", None, None)
    loss = L.chunked_ce_loss(fsdp_gathered(_head_table(params, cfg)), x, batch["labels"],
                             chunk=cfg.loss_chunk)
    if cfg.moe is not None:
        loss = loss + cfg.aux_coef * aux / max(1, cfg.n_layers)
    return loss


# ---------------------------------------------------------------------------
# serving


def _prime_ring(k_full: torch.Tensor, W: int) -> torch.Tensor:
    """(B, S, KH, hd) full keys -> (B, W, KH, hd) ring holding the last W
    tokens at slots (t mod W); slots no token reached stay zero."""
    B, S, KH, hd = k_full.shape
    last = k_full[:, max(0, S - W):]
    if S < W:
        return torch.cat([last, last.new_zeros((B, W - S, KH, hd))], dim=1)
    # token S - W + i goes to slot (off + i) mod W: a rotation of the last W,
    # built from slices (the card's DTensor has no rule for an indexed write)
    off = (S - W) % W
    return last if off == 0 else torch.cat([last[:, W - off:], last[:, :W - off]], dim=1)


def _logits(params: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, d) -> (B, vocab) float32: the head's products accumulated in
    float32, as the reference's ``preferred_element_type=f32`` asks (bf16
    products are exact in float32, so upcasting first gives the same sum)."""
    return x.float() @ fsdp_gathered(_head_table(params, cfg)).float().T


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, batch, S_max: Optional[int] = None):
    """Full-sequence forward that also builds the serve cache.

    batch: {"tokens": (B, S) int} or {"embeds": (B, S, d)} (+ "pos_ids" (3,
    B, S) for mrope).  Returns (last logits (B, vocab) f32, cache); ``S_max``
    sizes the global attention cache (defaults to the
    prompt length), and a sliding-window layer's ring holds ``min(window,
    S_max)`` slots, primed with the prompt's last tokens.  With
    ``cfg.rwkv_kernel`` / ``cfg.mamba_kernel`` the scans run through the
    CUDA kernels (one launch per rwkv / mamba layer when the tensors lie on
    the card).
    """
    _check(cfg)
    x = _embed_input(cfg, params, batch)
    S = x.shape[1]
    S_max = S_max or S
    cos_sin = _cos_sin(cfg, batch, S, x.device)
    caches = []
    for block in map(_for_compute, params.blocks):
        h = L.rmsnorm(block.norm1, x, cfg.eps)
        if block.mixer_kind in ("attn", "attn_local"):
            window = _window(cfg, block.mixer_kind)
            y, (k, v) = attn_mod.attn_forward(block.mixer, h, cos_sin, window=window,
                                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                              return_kv=True)
            if window is not None:
                W = min(window, S_max)
                cache = {"k": _prime_ring(k, W), "v": _prime_ring(v, W)}
            else:
                cache = {}
                for name, t in (("k", k), ("v", v)):
                    pad = t.new_zeros((t.shape[0], S_max - S) + t.shape[2:])
                    cache[name] = shard(torch.cat([t, pad], 1), "dp", "sp", None, None)
        elif block.mixer_kind == "mamba":
            y, cache = mamba_mod.mamba_forward(block.mixer, h, return_state=True,
                                               use_kernel=cfg.mamba_kernel)
        else:
            y, cache = rwkv_mod.rwkv_tmix_forward(block.mixer, h,
                                                  head_dim=cfg.rwkv_head_dim,
                                                  return_state=True,
                                                  use_kernel=cfg.rwkv_kernel)
        x = x + y
        h = L.rmsnorm(block.norm2, x, cfg.eps)
        y, fstate, _ = _ffn(cfg, block, h)
        cache.update(fstate)
        x = x + y
        caches.append(cache)
    x = L.rmsnorm(params.final_norm, x, cfg.eps)
    return _logits(params, cfg, x[:, -1]), caches


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, cache: List[dict], batch, pos: int):
    """One-token serve step: batch {"tokens": (B, 1)} or {"embeds": (B, 1,
    d)} (+ "pos_ids" (3, B, 1) for mrope, to which ``pos`` is added), ``pos``
    the absolute position of this token.  Returns (logits (B, vocab) f32, new cache).
    Attention layers write their key and value into the cache tensors in
    place; the recurrent layers' states are new tensors.  No kernel runs
    here: the scans step from a carried state on the plain path, as in the
    reference."""
    _check(cfg)
    x = shard(_embed_input(cfg, params, batch, pos_offset=pos), "dp", None, None)
    cos_sin = _cos_sin(cfg, batch, 1, x.device, pos_offset=pos)
    new_cache = []
    for block, c in zip(map(_for_compute, params.blocks), cache):
        h = L.rmsnorm(block.norm1, x, cfg.eps)
        if block.mixer_kind in ("attn", "attn_local"):
            y, ck, cv = attn_mod.attn_decode_step(block.mixer, h, cos_sin, c["k"], c["v"],
                                                  pos, window=_window(cfg, block.mixer_kind))
            nc = {"k": ck, "v": cv}
        elif block.mixer_kind == "mamba":
            y, nc = mamba_mod.mamba_decode_step(block.mixer, h, c)
        else:
            y, nc = rwkv_mod.rwkv_tmix_forward(block.mixer, h, head_dim=cfg.rwkv_head_dim,
                                               state=c, return_state=True)
        x = x + y
        h = L.rmsnorm(block.norm2, x, cfg.eps)
        y, fstate, _ = _ffn(cfg, block, h, state=c)
        nc.update(fstate)
        x = x + y
        new_cache.append(nc)
    x = L.rmsnorm(params.final_norm, x, cfg.eps)
    return _logits(params, cfg, x[:, 0]), new_cache
