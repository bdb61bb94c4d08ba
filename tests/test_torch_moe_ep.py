"""The port's expert-parallel MoE on a (2, 4) mesh of gloo CPU ranks.

Under ``axis_rules`` ``apply_moe`` takes the expert-parallel path: each
rank routes its (batch, sequence) shard of the tokens, dispatches them to
the ranks owning their experts with a capacity-bounded all_to_all over the
"model" dimension, runs its two local experts and sends the outputs back.
The parent holds it, in float32, against:
  * the JAX package's ``_moe_dense`` on the same parameters and tokens
    (numpy, from a seed), at capacity_factor 64 (no token dropped), within
    1e-4 of the largest value;
  * a plain single-process computation of the capacity rule over the same
    token partition, at a capacity that drops tokens (the mirror of the
    reference's ``test_ep_capacity_drops_tokens``, which only asks for a
    finite output): the same kept set, hence the same output;
  * the dense path's gradients (the port's ``_moe_dense`` through autograd)
    of the same loss at no drops, within 1e-4; also with a shared expert
    (``n_shared``, Qwen1.5-MoE's), computed beside the EP body on the
    sequence-gathered tokens.
The aux loss is the reference's: the mean over the ranks of each shard's
Switch loss.  The rank body is a module-level function (the ranks import
this module by name, without JAX); the spawn runs once, with a deadline.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import MoEConfig

SPAWN_TIMEOUT_S = 120
DATA, MODEL = 2, 4
B, S, D = 4, 8, 32
CFG = MoEConfig(n_experts=8, top_k=2, d_expert_ff=16, capacity_factor=64.0)
DROP_CF = 0.5     # capacity ceil(0.5 * 2 * 4 / 8) = 1 slot an expert a shard
CFG_SH = dataclasses.replace(CFG, n_shared=1)


def _arrays():
    rng = np.random.default_rng(0)
    E, ff = CFG.n_experts, CFG.d_expert_ff
    params = {"router": rng.normal(size=(D, E)) / math.sqrt(D),
              "w_gate": rng.normal(size=(E, D, ff)) / math.sqrt(D),
              "w_up": rng.normal(size=(E, D, ff)) / math.sqrt(D),
              "w_down": rng.normal(size=(E, ff, D)) / math.sqrt(ff)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    cot = rng.normal(size=(B, S, D)).astype(np.float32)
    sh = CFG_SH.n_shared * ff
    params_sh = {"sh_gate": rng.normal(size=(D, sh)) / math.sqrt(D),
                 "sh_up": rng.normal(size=(D, sh)) / math.sqrt(D),
                 "sh_down": rng.normal(size=(sh, D)) / math.sqrt(sh)}
    params_sh = dict(params, **{k: v.astype(np.float32) for k, v in params_sh.items()})
    return params, x, cot, params_sh


def _placed(mesh, arrays):
    """The parameters as DTensors laid out by the reference's rules (the
    experts on "model", FSDP on "data"), the tokens as a DTensor sharded
    (dp, sp), all requiring gradients."""
    from repro_torch.distributed.param_sharding import _leaf_axes
    from repro_torch.distributed.sharding import default_rules, placements, resolve_spec
    from torch.distributed.tensor import distribute_tensor
    rules = default_rules(mesh)
    params, x, cot = arrays[:3]

    def place(a, axes):
        t = torch.from_numpy(a)
        where = placements(mesh, resolve_spec(rules, t.shape, axes))
        return distribute_tensor(t, mesh, where, src_data_rank=None).requires_grad_()

    p = {k: place(v, _leaf_axes(k, v.ndim, False)) for k, v in params.items()}
    return rules, p, place(x, ("dp", "sp", None)), place(cot, ("dp", "sp", None))


def ep_rank(mesh, arrays):
    from repro_torch.distributed.sharding import axis_rules
    rules, params, x, cot = _placed(mesh, arrays)
    out = {}
    with axis_rules(rules):
        y, aux = moe_mod.apply_moe(params, x, CFG)
        loss = (y * cot).sum()
        grads = torch.autograd.grad(loss, [x, *params.values()])
        out["y"] = y.full_tensor().detach()
        out["aux"] = float(aux.full_tensor())
        out["grads"] = [g.full_tensor().detach() for g in grads]
        with torch.no_grad():
            y_drop, _ = moe_mod.apply_moe(params, x, dataclasses.replace(
                CFG, capacity_factor=DROP_CF))
        out["y_drop"] = y_drop.full_tensor()
    _, params_sh, x, cot = _placed(mesh, (arrays[3], *arrays[1:3]))
    with axis_rules(rules):
        y, _ = moe_mod.apply_moe(params_sh, x, CFG_SH)
        grads = torch.autograd.grad((y * cot).sum(), [x, *params_sh.values()])
        out["y_sh"] = y.full_tensor().detach()
        out["grads_sh"] = [g.full_tensor().detach() for g in grads]
    return out if mesh.get_rank() == 0 else None


@pytest.fixture(scope="module")
def ranks():
    arrays = _arrays()
    outs = mesh_mod.spawn_mesh(ep_rank, data=DATA, model=MODEL, device="cpu",
                               args=(arrays,), timeout_s=SPAWN_TIMEOUT_S)
    assert not any(v for o in outs for v in o.launches.values())
    return arrays, outs[0].result


def _rel(got, exp) -> float:
    return float((got - exp).abs().max()) / float(exp.abs().max())


def test_ep_matches_the_jax_dense_path(ranks):
    import jax.numpy as jnp

    from repro.models.moe import MoEConfig as JMoEConfig
    from repro.models.moe import _moe_dense as jmoe_dense
    (params, x, _, _), got = ranks
    jcfg = JMoEConfig(**dataclasses.asdict(CFG))
    y, _ = jmoe_dense({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jcfg)
    exp = torch.from_numpy(np.asarray(y))
    assert torch.isfinite(got["y"]).all()
    assert _rel(got["y"], exp) < 1e-4


def _shards(t: torch.Tensor):
    """The (batch, sequence) shards of the EP path's token partition:
    batch over the DATA ranks, sequence over the MODEL ranks."""
    for bs in torch.chunk(t, DATA, dim=0):
        for ss in torch.chunk(bs, MODEL, dim=1):
            yield ss


def test_capacity_drops_tokens_as_the_plain_rule_keeps_them(ranks):
    """Each shard routes its own tokens; an expert keeps the first
    ``capacity`` token-slots that pick it, in flattened (token, k) order;
    a dropped slot adds nothing.  Computed here in one process."""
    (params, x, _, _), got = ranks
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    xt = torch.from_numpy(x)
    T_loc = (B // DATA) * (S // MODEL)
    cap = max(1, int(math.ceil(DROP_CF * CFG.top_k * T_loc / CFG.n_experts)))
    exp, dropped = torch.zeros_like(xt), 0
    exp_shards = list(_shards(exp))
    for xs, ys in zip(_shards(xt), exp_shards):
        xf = xs.reshape(-1, D)
        gates, eids, _ = moe_mod._route(p["router"], xf, CFG)
        seen = [0] * CFG.n_experts
        out = torch.zeros_like(xf)
        for t in range(xf.shape[0]):
            for j in range(CFG.top_k):
                e = int(eids[t, j])
                if seen[e] < cap:
                    h = moe_mod._expert_ffn(p["w_gate"][e:e + 1], p["w_up"][e:e + 1],
                                            p["w_down"][e:e + 1], xf[None, t:t + 1], CFG.act)
                    out[t] += gates[t, j] * h[0, 0]
                else:
                    dropped += 1
                seen[e] += 1
        ys.copy_(out.reshape(ys.shape))
    assert dropped > 0
    assert torch.isfinite(got["y_drop"]).all()
    assert _rel(got["y_drop"], exp) < 1e-4


def _dense_grads(params, x, cot, cfg):
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = moe_mod._moe_dense(p, xt, cfg)
    return y.detach(), p, torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                              [xt, *p.values()])


def test_ep_gradient_matches_the_dense_gradient(ranks):
    (params, x, cot, _), got = ranks
    _, p, exp = _dense_grads(params, x, cot, CFG)
    for name, g, e in zip(["x", *p], got["grads"], exp):
        assert _rel(g, e) < 1e-4, name


def test_ep_shared_expert_matches_the_dense_path(ranks):
    """Qwen1.5-MoE's shared expert beside the EP body (on the sequence
    gathered over "model", its hidden dim over tp): output and gradients
    as the dense path's."""
    (_, x, cot, params_sh), got = ranks
    y, p, exp = _dense_grads(params_sh, x, cot, CFG_SH)
    assert _rel(got["y_sh"], y) < 1e-4
    for name, g, e in zip(["x", *p], got["grads_sh"], exp):
        assert _rel(g, e) < 1e-4, name


def test_aux_is_the_mean_of_each_shards_switch_loss(ranks):
    (params, x, _, _), got = ranks
    router = torch.from_numpy(params["router"])
    auxes = [float(moe_mod._route(router, xs.reshape(-1, D), CFG)[2])
             for xs in _shards(torch.from_numpy(x))]
    assert got["aux"] == pytest.approx(np.mean(auxes), rel=1e-5)
