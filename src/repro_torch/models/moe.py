"""Mixture-of-Experts FFN: top-k routing, every expert on one device.

The dense path of the reference (``src/repro/models/moe.py``): every expert
is computed for every token and the outputs are combined with the top-k
gates, as the reference's single-device path (its correctness oracle)
does.  Routing is softmax -> top-k -> renormalise (the Qwen3 / Mixtral
convention) in float32, with the Switch load-balance loss returned beside
the output.  Experts are padded to a multiple of the expert-parallel width
(``ep_size``); the padding experts' logits are masked before the top-k, so
no token reaches them.

The expert-parallel path (the reference's ``_moe_ep``: capacity-bounded
all_to_all dispatch over a mesh) needs the sharding rules and raises
``NotImplementedError`` until they land (ROADMAP.md queue 1, item 8.6).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

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
    """The shared expert on x (T, d)."""
    up = x @ params["sh_up"]
    if act == "swiglu":
        g = x @ params["sh_gate"]
        h = F.silu(g.float()).to(x.dtype) * up
    else:
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return h @ params["sh_down"]


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


def apply_moe(params, x: torch.Tensor, cfg: MoEConfig, rules=None):
    """x (B, S, d) -> (y (B, S, d), aux loss, a float32 scalar).

    With no sharding rules (the port has none yet) the dense path runs;
    ``rules`` stands for the reference's active sharding-rules context,
    which selects its expert-parallel path.

    Raises:
        NotImplementedError: when ``rules`` is given.
    """
    if rules is not None:
        raise NotImplementedError(
            "the expert-parallel MoE path (_moe_ep) is not ported yet "
            "(ROADMAP.md queue 1, item 8.6)")
    return _moe_dense(params, x, cfg)
