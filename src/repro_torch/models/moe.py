"""Mixture-of-Experts FFN: top-k routing with expert parallelism.

Two execution paths share one parameter layout, as in the reference
(``src/repro/models/moe.py``):

* ``dense`` - every expert computed for every token, combined with the
  top-k gates.  O(E/k) FLOP waste; the single-device path and the
  correctness oracle.
* ``ep`` - expert parallel, under sharding rules (``distributed.sharding``):
  on each rank's local shards (``shard_map_compat``), tokens are dispatched
  to the ranks owning their experts with a capacity-bounded all_to_all over
  the "model" ("ep") mesh dimension, the expert FFNs run as batched
  products on the local experts, and a second all_to_all returns the
  outputs to their source rank (sort-free cumsum positions, capacity
  drop).  Expert weights are also FSDP-sharded over the data dimensions and
  all-gathered inside the body.  The collectives are autograd-aware, so a
  train step runs through them.

Routing is softmax -> top-k -> renormalise (the Qwen3 / Mixtral
convention) in float32, with the Switch load-balance loss returned beside
the output.  Experts are padded to a multiple of the expert-parallel width
(``ep_size``); the padding experts' logits are masked before the top-k, so
no token reaches them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from functools import partial
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.distributed.sharding import (
    AxisRules,
    P,
    current_rules,
    mesh_sizes,
    replicated,
    shard,
    shard_map_compat,
)
from repro_torch.launch.mesh import classic_all_gather, classic_all_to_all
from repro_torch.models.layers import normal

__all__ = ["MoEConfig", "init_moe", "moe_shapes", "apply_moe"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0           # shared-expert width, in units of d_expert_ff
    capacity_factor: float = 1.25
    act: str = "swiglu"

    @property
    def e_pad(self) -> int:
        """Experts padded so the EP axis divides them (dummy experts are
        never routed to)."""
        return self.n_experts


def _e_padded(cfg: MoEConfig, ep_size: int) -> int:
    return int(math.ceil(cfg.n_experts / ep_size) * ep_size)


def init_moe(gen: torch.Generator, d: int, cfg: MoEConfig, ep_size: int = 1,
             dtype=torch.bfloat16):
    """Random MoE parameters on the generator's device: the router
    (d, E) float32, the experts (E, d, ff) / (E, ff, d) in ``dtype`` and,
    with ``n_shared``, the shared expert ``n_shared * d_expert_ff`` wide; E
    is ``n_experts`` padded to a multiple of ``ep_size``."""
    E = _e_padded(cfg, ep_size)
    ff = cfg.d_expert_ff
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p = {
        "router": normal(gen, (d, E), torch.float32, sc_in),
        "w_gate": normal(gen, (E, d, ff), dtype, sc_in),
        "w_up": normal(gen, (E, d, ff), dtype, sc_in),
        "w_down": normal(gen, (E, ff, d), dtype, sc_out),
    }
    if cfg.n_shared:
        ff_sh = cfg.n_shared * ff
        p["sh_gate"] = normal(gen, (d, ff_sh), dtype, sc_in)
        p["sh_up"] = normal(gen, (d, ff_sh), dtype, sc_in)
        p["sh_down"] = normal(gen, (ff_sh, d), dtype, sc_out)
    return p


def moe_shapes(d: int, cfg: MoEConfig, ep_size: int = 1, dtype=torch.bfloat16):
    """{name: (shape, dtype)} of :func:`init_moe`'s parameters."""
    E = _e_padded(cfg, ep_size)
    ff = cfg.d_expert_ff
    p = {
        "router": ((d, E), torch.float32),
        "w_gate": ((E, d, ff), dtype),
        "w_up": ((E, d, ff), dtype),
        "w_down": ((E, ff, d), dtype),
    }
    if cfg.n_shared:
        ff_sh = cfg.n_shared * ff
        p["sh_gate"] = ((d, ff_sh), dtype)
        p["sh_up"] = ((d, ff_sh), dtype)
        p["sh_down"] = ((ff_sh, d), dtype)
    return p


def _route(router_w: torch.Tensor, x_flat: torch.Tensor, cfg: MoEConfig):
    """x_flat (T, d) -> gates (T, k) float32, eids (T, k) int64, aux loss."""
    logits = x_flat.float() @ router_w                      # (T, E_pad)
    E = router_w.shape[1]
    if E > cfg.n_experts:           # mask the padding experts
        pad = torch.arange(E, device=logits.device) >= cfg.n_experts
        logits = torch.where(pad[None], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    top_p, eids = torch.topk(probs, cfg.top_k, dim=-1)
    gates = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # Switch aux loss: E * sum_e (fraction of tokens whose first choice is e
    # * mean probability of e)
    frac = F.one_hot(eids[:, 0], E).float().mean(0)
    aux = cfg.n_experts * torch.sum(frac * probs.mean(0))
    return gates, eids, aux


def _expert_ffn(w_gate, w_up, w_down, xs: torch.Tensor, act: str) -> torch.Tensor:
    """xs (E, C, d) -> (E, C, d): each expert's FFN on its own rows.  ``xs``
    may be a broadcast view (stride 0 over E): the batched products read it
    in place."""
    up = torch.bmm(xs, w_up)
    if act == "swiglu":
        g = torch.bmm(xs, w_gate)
        h = F.silu(g.float()).to(xs.dtype) * up
    else:
        h = F.gelu(up.float(), approximate="tanh").to(xs.dtype)
    return torch.bmm(h, w_down)


def _shared_ffn(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """The shared expert on x (T, d), or (B, S, d) under sharding rules,
    computed outside the expert-parallel body so its hidden dim
    tensor-parallelises like a normal MLP (and, as the MLP's, its output is
    laid out again explicitly: the card's DTensor cannot flatten (B, S) for
    the last product's backward when the gradient arrives sequence-sharded)."""
    up = x @ params["sh_up"]
    up = shard(up, "dp", None, "tp")
    if act == "swiglu":
        g = x @ params["sh_gate"]
        g = shard(g, "dp", None, "tp")
        h = F.silu(g.float()).to(x.dtype) * up
    else:
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return shard(h @ params["sh_down"], "dp", None, None)


def _moe_dense(params, x: torch.Tensor, cfg: MoEConfig):
    """Every expert on every token, combined by the top-k gates."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    gates, eids, aux = _route(params["router"], xf, cfg)
    E = params["w_gate"].shape[0]
    comb = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    comb.scatter_add_(1, eids, gates)                        # (T, E) weights
    all_out = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                          xf.expand(E, T, d), cfg.act)
    # the weights rounded to x's dtype before the combine, as the reference
    # rounds them
    y = torch.einsum("te,etd->td", comb.to(x.dtype), all_out)
    if cfg.n_shared:
        y = y + _shared_ffn(params, xf, cfg.act)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# expert-parallel path


_timing = threading.local()


@contextlib.contextmanager
def ep_timing():
    """Time the expert-parallel body's parts while the context is open:
    yields {"all_to_all": s, "experts": s, "calls": n, "slots": n, "kept":
    n}: host seconds of the two all_to_alls (dispatch and return) and of the
    expert products, each ended by a synchronize of the device, and the
    token-slots (tokens x top-k) routed and kept under the capacity on this
    rank.  Off (no synchronize) outside."""
    out = {"all_to_all": 0.0, "experts": 0.0, "calls": 0, "slots": 0, "kept": 0}
    prev = getattr(_timing, "acc", None)
    _timing.acc = out
    try:
        yield out
    finally:
        _timing.acc = prev


@contextlib.contextmanager
def _timed(part: str, device: torch.device):
    acc = getattr(_timing, "acc", None)
    if acc is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    acc[part] += time.perf_counter() - t0


class _ClassicAllToAll(torch.autograd.Function):
    """All-to-all of equal splits with the classic collective, its gradient
    the all-to-all of the output's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return classic_all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return classic_all_to_all(g, ctx.group), None


class _ClassicAllGather(torch.autograd.Function):
    """All-gather along ``dim`` with the classic collective; the gradient of
    a shard is the sum over the ranks of the gradient's chunk it became."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return classic_all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.group.size(), dim=ctx.dim)[ctx.group.rank()].contiguous(), None, None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal splits of dim 0 exchanged over ``group`` (chunk j to rank j,
    chunk i of the result from rank i), autograd-aware."""
    return _ClassicAllToAll.apply(x.contiguous(), group)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The shards of ``group`` concatenated along ``dim`` in rank order,
    autograd-aware."""
    return _ClassicAllGather.apply(x.contiguous(), dim, group)


class _MeanAcross(torch.autograd.Function):
    """The mean of a scalar over every rank of ``groups`` (the reference's
    ``pmean`` over each mesh dimension).  The result is replicated, so each
    rank's share of its gradient is the gradient over the rank count."""

    @staticmethod
    def forward(ctx, x, groups):
        n = 1
        y = x.detach().clone()
        for g in groups:
            dist.all_reduce(y, group=g)
            n *= dist.get_world_size(g)
        ctx.n = n
        return y / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _moe_ep_body(x, router_w, w_gate, w_up, w_down, *, cfg: MoEConfig, mesh,
                 ep_axis: str, dp_axes: Tuple[str, ...], capacity: int, ep: int):
    """The body on local shards: x (B_loc, S_loc, d) local tokens; expert
    weights (E_loc, d / dp, ff) - FSDP-gathered here; returns (y, aux)."""
    sizes = mesh_sizes(mesh)
    for ax in dp_axes:      # FSDP all-gather of the expert weights
        if sizes[ax] > 1:
            g = mesh.get_group(ax)
            w_gate = _all_gather(w_gate, 1, g)
            w_up = _all_gather(w_up, 1, g)
            w_down = _all_gather(w_down, 2, g)
    B_loc, S_loc, d = x.shape
    T = B_loc * S_loc
    xf = x.reshape(T, d)
    gates, eids, aux = _route(router_w, xf, cfg)              # (T, k)
    E = router_w.shape[1]
    E_loc = E // ep
    k = cfg.top_k

    flat_e = eids.reshape(-1)                                  # (T*k,)
    onehot = F.one_hot(flat_e, E)                              # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - 1                      # position in expert
    my_pos = pos.gather(1, flat_e[:, None])[:, 0]
    keep = my_pos < capacity                                   # capacity drop
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(k)

    # scatter the tokens into the (E, C, d) send buffer: one (e, c) a kept
    # token, so the sum adds each to zeros
    e_idx = torch.where(keep, flat_e, 0)
    c_idx = torch.where(keep, my_pos, 0)
    slot = e_idx * capacity + c_idx
    vals = torch.where(keep[:, None], xf[tok_idx], 0.0)
    send = xf.new_zeros((E * capacity, d)).index_add(0, slot, vals)

    group = mesh.get_group(ep_axis)
    # (ep, E_loc, C, d): chunk j to rank j; recv[src, e_loc] = the tokens
    # rank src sent to this rank's experts
    with _timed("all_to_all", x.device):
        recv = _all_to_all(send, group) if ep > 1 else send
    xs = recv.reshape(ep, E_loc, capacity, d).transpose(0, 1).reshape(E_loc, ep * capacity, d)
    with _timed("experts", x.device):
        ys = _expert_ffn(w_gate, w_up, w_down, xs, cfg.act)
    ret = ys.reshape(E_loc, ep, capacity, d).transpose(0, 1).reshape(E * capacity, d)
    with _timed("all_to_all", x.device):
        back = _all_to_all(ret, group) if ep > 1 else ret      # rows for OUR tokens again

    gathered = torch.where(keep[:, None], back[slot], 0.0)     # (T*k, d)
    w = (gates.reshape(-1) * keep).float()
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device).index_add(
        0, tok_idx, gathered.float() * w[:, None])
    y = y.to(x.dtype)
    # aux is a local mean; average it over every rank of the mesh
    aux = _MeanAcross.apply(aux, [mesh.get_group(a) for a in mesh.mesh_dim_names])
    acc = getattr(_timing, "acc", None)
    if acc is not None:
        acc["calls"] += 1
        acc["slots"] += int(keep.numel())
        acc["kept"] += int(keep.sum())
    return y.reshape(B_loc, S_loc, d), aux


def _moe_ep(params, x, cfg: MoEConfig, rules: AxisRules):
    mesh = rules.mesh
    sizes = mesh_sizes(mesh)
    ep_axis = rules.physical("ep")
    dp_phys = rules.physical("dp")
    dp_axes = tuple(dp_phys) if isinstance(dp_phys, tuple) else (dp_phys,)
    ep = sizes[ep_axis]
    dpN = math.prod(sizes[a] for a in dp_axes)
    B, S, _ = x.shape
    seq_shard = ep if S % ep == 0 else 1   # decode: S=1 cannot seq-shard
    b_shard = dpN if B % dpN == 0 else 1   # long-context decode: B=1
    T_loc = (B // b_shard) * (S // seq_shard)
    E = params["w_gate"].shape[0]
    capacity = max(1, int(math.ceil(cfg.capacity_factor * cfg.top_k * T_loc / E)))

    batch_spec = dp_axes if b_shard > 1 else None
    seq_spec = ep_axis if seq_shard > 1 else None
    # the router is replicated but each rank routes its own tokens: its
    # gradient is a partial sum over the dimensions the tokens are split on
    router_grad = tuple(
        Partial() if (name == ep_axis and seq_shard > 1)
        or (name in dp_axes and b_shard > 1) else Replicate()
        for name in mesh.mesh_dim_names)
    body = shard_map_compat(
        partial(_moe_ep_body, cfg=cfg, mesh=mesh, ep_axis=ep_axis, dp_axes=dp_axes,
                capacity=capacity, ep=ep),
        mesh=mesh,
        in_specs=(P(batch_spec, seq_spec, None),   # x: (B, S, d)
                  P(None, None),                   # router replicated
                  P(ep_axis, dp_axes, None),       # w_gate (E, d, ff)
                  P(ep_axis, dp_axes, None),       # w_up
                  P(ep_axis, None, dp_axes)),      # w_down (E, ff, d)
        out_specs=(P(batch_spec, seq_spec, None), P()),
        in_grad_placements=(None, router_grad, None, None, None))
    plain = not isinstance(x, DTensor)
    # a plain tensor under rules holds the whole (replicated) value
    args = [replicated(a, mesh) for a in (x, params["router"], params["w_gate"],
                                          params["w_up"], params["w_down"])]
    y, aux = body(*args)
    if cfg.n_shared:    # on the sequence gathered, as the MLP (the card's DTensor
        # cannot flatten (B, S) with S sharded)
        y = y + _shared_ffn(params, shard(args[0], "dp", None, None), cfg.act)
    if plain:
        return y.full_tensor(), aux.full_tensor()
    return y, aux


def apply_moe(params, x: torch.Tensor, cfg: MoEConfig):
    """x (B, S, d) -> (y (B, S, d), aux loss, a float32 scalar).  Chooses the
    expert-parallel path when a sharding-rules context is active (a DTensor
    ``x`` keeps its placements; a plain one is taken as replicated and gets
    plain results), the dense path otherwise."""
    rules = current_rules()
    if rules is None:
        return _moe_dense(params, x, cfg)
    return _moe_ep(params, x, cfg, rules)
