"""The port's MoE FFN (on the CPU) against the JAX package's dense path.

The same numpy inputs, from seeds, go through ``repro.models.moe`` and
``repro_torch.models.moe``: the router, the grouped expert FFN, the shared
expert, the dense combine and ``apply_moe``, in float32 (1e-4) and in
bfloat16 (5e-2), as max |port - ref| / max |ref|.

Top-k near-ties: the two frameworks' float32 router products may differ in
the last bit, which can swap the k-th and (k+1)-th expert of a token whose
two probabilities nearly tie.  Routing is therefore held exactly (expert
ids, and gates to float32 rounding) on every token whose gap between those
two probabilities exceeds ``GAP``; the tokens under it are counted and
printed (none in these cases so far).
"""
import dataclasses
import inspect
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore

import jax
import jax.numpy as jnp

from repro.models import moe as jmoe
from repro_torch.distributed.sharding import axis_rules, default_rules
from repro_torch.models import moe
from repro_torch.models.moe import MoEConfig

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GAP = 1e-5

j_route = jax.jit(jmoe._route, static_argnums=2)
j_apply = jax.jit(jmoe.apply_moe, static_argnums=2)
j_experts = jax.jit(jmoe._expert_ffn, static_argnums=4)
j_shared = jax.jit(jmoe._shared_ffn, static_argnums=2)


def _rel(got, exp) -> float:
    got = got.float().numpy()
    exp = np.asarray(exp, np.float32)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    return float(np.max(np.abs(got - exp)) / (np.max(np.abs(exp)) + 1e-12))


def _pair(x, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    j = jnp.asarray(x, JDT[dtype])
    return j, torch.from_numpy(np.array(j, np.float32)).to(TDT[dtype])


def _jcfg(cfg: MoEConfig) -> jmoe.MoEConfig:
    return jmoe.MoEConfig(**dataclasses.asdict(cfg))


def _params(rng, d, cfg: MoEConfig, ep_size, dtype):
    """MoE parameters from numpy in the reference's layout and scales:
    (JAX dict, port dict); the router float32 in both."""
    E = moe._e_padded(cfg, ep_size)
    ff = cfg.d_expert_ff
    sc_in, sc_out = 1 / math.sqrt(d), 1 / math.sqrt(ff)
    shapes = {"router": ((d, E), sc_in), "w_gate": ((E, d, ff), sc_in),
              "w_up": ((E, d, ff), sc_in), "w_down": ((E, ff, d), sc_out)}
    if cfg.n_shared:
        ff_sh = cfg.n_shared * ff
        shapes |= {"sh_gate": ((d, ff_sh), sc_in), "sh_up": ((d, ff_sh), sc_in),
                   "sh_down": ((ff_sh, d), sc_out)}
    jp, tp = {}, {}
    for name, (shape, sc) in shapes.items():
        jp[name], tp[name] = _pair(sc * rng.standard_normal(shape),
                                   "float32" if name == "router" else dtype)
    return jp, tp


def _gaps(x_flat: np.ndarray, router: np.ndarray, cfg: MoEConfig) -> np.ndarray:
    """Per token, the gap between its k-th and (k+1)-th routing
    probability (float64, padding experts masked)."""
    logits = x_flat.astype(np.float64) @ router.astype(np.float64)
    logits[:, cfg.n_experts:] = -np.inf
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = -np.sort(-(p / p.sum(-1, keepdims=True)), axis=-1)
    k = cfg.top_k
    return p[:, k - 1] - p[:, k] if k < p.shape[1] else np.full(len(p), np.inf)


def _check_routing(label, gates, eids, jgates, jeids, gaps):
    """Expert ids equal and gates within float32 rounding on every token
    whose gap exceeds GAP; returns the number of near-tie tokens."""
    far = gaps > GAP
    np.testing.assert_array_equal(eids.numpy()[far], np.asarray(jeids)[far])
    # the softmax and the renormalisation round in another order: 1 ulp
    np.testing.assert_allclose(gates.numpy()[far], np.asarray(jgates)[far], rtol=1e-6)
    n_near = int((~far).sum())
    print(f"{label}: {n_near} of {len(gaps)} tokens within {GAP} of a top-k tie "
          f"(smallest gap {gaps.min():.3e})")
    return n_near


ROUTES = [  # (n_experts, top_k, ep_size): E padded to a multiple of ep_size
    (8, 2, 1), (6, 2, 4), (16, 2, 16), (60, 4, 16), (128, 8, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_experts,top_k,ep_size", ROUTES)
def test_route_matches_jax(n_experts, top_k, ep_size, dtype):
    """Gates, expert ids and the Switch aux loss on 64 tokens."""
    rng = np.random.default_rng(n_experts * 10 + top_k)
    cfg = MoEConfig(n_experts=n_experts, top_k=top_k, d_expert_ff=8)
    d, T = 32, 64
    jp, tp = _params(rng, d, cfg, ep_size, "float32")
    xj, xt = _pair(rng.standard_normal((T, d)), dtype)
    gates, eids, aux = moe._route(tp["router"], xt, cfg)
    jgates, jeids, jaux = j_route(jp["router"], xj, _jcfg(cfg))
    assert gates.dtype == torch.float32 and gates.shape == (T, top_k)
    assert eids.shape == (T, top_k) and int(eids.max()) < n_experts
    gaps = _gaps(np.asarray(xj, np.float32), np.asarray(jp["router"]), cfg)
    _check_routing(f"route E={n_experts} k={top_k} {dtype}", gates, eids, jgates, jeids,
                   gaps)
    torch.testing.assert_close(gates.sum(-1), torch.ones(T))
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_expert_and_shared_ffn_match_jax(act, dtype):
    rng = np.random.default_rng(3)
    cfg = MoEConfig(n_experts=4, top_k=2, d_expert_ff=24, n_shared=2, act=act)
    d, C = 16, 10
    jp, tp = _params(rng, d, cfg, 1, dtype)
    xj, xt = _pair(rng.standard_normal((4, C, d)), dtype)
    got = moe._expert_ffn(tp["w_gate"], tp["w_up"], tp["w_down"], xt, act)
    exp = j_experts(jp["w_gate"], jp["w_up"], jp["w_down"], xj, act)
    assert got.dtype == TDT[dtype]
    assert _rel(got, exp) < TOL[dtype]              # f32 <= 2.4e-7, bf16 <= 7.7e-3
    got = moe._shared_ffn(tp, xt[0], act)
    exp = j_shared(jp, xj[0], act)
    assert got.shape == (C, d) and _rel(got, exp) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_experts,top_k,n_shared,act", [
    (4, 2, 0, "swiglu"), (6, 2, 2, "swiglu"), (8, 2, 0, "gelu"), (16, 4, 1, "swiglu")])
def test_apply_moe_matches_jax(n_experts, top_k, n_shared, act, dtype):
    """The dense path end to end: (y, aux) on (2, 24, d) tokens."""
    rng = np.random.default_rng(n_experts + 100 * n_shared)
    cfg = MoEConfig(n_experts=n_experts, top_k=top_k, d_expert_ff=24,
                    n_shared=n_shared, act=act)
    d = 32
    jp, tp = _params(rng, d, cfg, 1, dtype)
    xj, xt = _pair(rng.standard_normal((2, 24, d)), dtype)
    y, aux = moe.apply_moe(tp, xt, cfg)
    jy, jaux = j_apply(jp, xj, _jcfg(cfg))
    gaps = _gaps(np.asarray(xj, np.float32).reshape(-1, d), np.asarray(jp["router"]), cfg)
    _check_routing(f"apply_moe E={n_experts} {dtype}",
                   *moe._route(tp["router"], xt.reshape(-1, d), cfg)[:2],
                   *j_route(jp["router"], xj.reshape(-1, d), _jcfg(cfg))[:2], gaps)
    assert y.dtype == TDT[dtype] and y.shape == xt.shape
    assert _rel(y, jy) < TOL[dtype]                 # f32 <= 3.6e-7, bf16 <= 7.9e-3
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    # the reference's oracle: each token's own top-k experts, one at a time
    if dtype == "float32":
        gates, eids, _ = moe._route(tp["router"], xt.reshape(-1, d), cfg)
        xf = xt.reshape(-1, d)
        per_token = torch.stack([
            sum(gates[t, j] * moe._expert_ffn(tp["w_gate"][e:e + 1], tp["w_up"][e:e + 1],
                                              tp["w_down"][e:e + 1], xf[t][None, None],
                                              act)[0, 0]
                for j, e in enumerate(eids[t].tolist()))
            for t in range(xf.shape[0])])
        if n_shared:
            per_token = per_token + moe._shared_ffn(tp, xf, act)
        assert _rel(y.reshape(-1, d), per_token.numpy()) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_experts_are_never_chosen(dtype):
    """n_experts=6 padded to E=8 (ep_size 4).  The padding experts' router
    columns are made the largest, so only the mask keeps tokens off them."""
    rng = np.random.default_rng(11)
    cfg = MoEConfig(n_experts=6, top_k=2, d_expert_ff=16, n_shared=1)
    d = 32
    jp, tp = _params(rng, d, cfg, 4, dtype)
    assert tp["router"].shape == (d, 8) and tp["w_gate"].shape[0] == 8
    router = np.asarray(jp["router"]).copy()
    router[:, 6:] = 10.0
    jp["router"], tp["router"] = _pair(router, "float32")
    xj, xt = _pair(np.abs(rng.standard_normal((2, 16, d))), dtype)
    gates, eids, _ = moe._route(tp["router"], xt.reshape(-1, d), cfg)
    assert int(eids.max()) < 6
    comb = torch.zeros(32, 8).scatter_add_(1, eids, gates)
    assert not comb[:, 6:].any()
    y, aux = moe.apply_moe(tp, xt, cfg)
    jy, jaux = j_apply(jp, xj, _jcfg(cfg))
    assert _rel(y, jy) < TOL[dtype]
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    # without the mask the padding experts would win every token
    unmasked = dataclasses.replace(cfg, n_experts=8)
    assert bool((moe._route(tp["router"], xt.reshape(-1, d), unmasked)[1] >= 6).all())


@pytest.mark.parametrize("n_experts,ep_size,n_shared", [(4, 1, 0), (6, 4, 2), (60, 16, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_and_shapes_match_jax(n_experts, ep_size, n_shared, dtype):
    cfg = MoEConfig(n_experts=n_experts, top_k=2, d_expert_ff=12, n_shared=n_shared)
    d = 16
    ref = jax.eval_shape(lambda k: jmoe.init_moe(k, d, _jcfg(cfg), ep_size, JDT[dtype]),
                         jax.random.PRNGKey(0))
    ref_shapes = jmoe.moe_shapes(d, _jcfg(cfg), ep_size, JDT[dtype])
    gen = torch.Generator().manual_seed(0)
    own = moe.init_moe(gen, d, cfg, ep_size=ep_size, dtype=TDT[dtype])
    shapes = moe.moe_shapes(d, cfg, ep_size=ep_size, dtype=TDT[dtype])
    assert set(own) == set(ref) == set(shapes) == set(ref_shapes)
    for name, leaf in ref.items():
        assert tuple(own[name].shape) == leaf.shape == shapes[name][0], name
        assert own[name].dtype == shapes[name][1] == getattr(torch, leaf.dtype.name), name
        assert ref_shapes[name].shape == leaf.shape and ref_shapes[name].dtype == leaf.dtype
    assert own["router"].dtype == torch.float32


def test_expert_parallel_path_raises_naming_the_roadmap():
    """The expert-parallel path is ported (ROADMAP.md item 8.6), so nothing
    raises naming the item any more: ``apply_moe`` has the reference's
    signature (no ``rules`` argument) and takes the EP path from the active
    sharding rules; on a one-rank mesh (a fake group in this process) its
    output and aux loss are the dense path's.  The path on a (2, 4) mesh is
    held to the JAX package in ``tests/test_torch_moe_ep.py``."""
    cfg = MoEConfig(n_experts=4, top_k=2, d_expert_ff=8, capacity_factor=4.0)
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe(gen, 8, cfg, dtype=torch.float32)
    x = torch.randn((2, 4, 8), generator=gen)
    with pytest.raises(TypeError):
        moe.apply_moe(params, x, cfg, rules=object())
    assert "item 8.6" not in inspect.getsource(moe)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        with axis_rules(default_rules(mesh)), moe.ep_timing() as split:
            y, aux = moe.apply_moe(params, x, cfg)
    finally:
        dist.destroy_process_group()
    assert split["calls"] == 1 and split["kept"] == split["slots"] == 2 * 4 * cfg.top_k
    y_dense, aux_dense = moe._moe_dense(params, x, cfg)
    torch.testing.assert_close(y, y_dense, rtol=1e-5, atol=1e-6)
    assert float(aux) == pytest.approx(float(aux_dense), rel=1e-6)
