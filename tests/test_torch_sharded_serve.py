"""Serving on a mesh: ``make_prefill_step(cfg, rules, S_max)`` and
``make_serve_step(cfg, rules)`` on a (2, 2) mesh of gloo CPU ranks, the
parameters sharded by the reference's rules, against the same steps on one
device.  SMOKE Qwen3 (the attention cache sharded over the sequence, each
token written into the rank whose shard holds its slot), RWKV-6 and Jamba
(the expert-parallel MoE; a decode token cannot be sequence-sharded, so
every rank routes the whole batch), float32, ``tp_pad=4``: a prefill of 16
tokens and three greedy decode steps.  The prefill's logits hold within
1e-5 of the largest; the decode steps' within 1e-3 with the same greedy
tokens: the serve states ``shift_t``, ``shift_c`` and ``conv`` are bf16 in
any config (as in the reference), so a last-bit difference of the two
layouts can round a state one bf16 step apart, which a free-running decode
chain carries on (Jamba: 1.2e-6, 1.7e-5, 1.0e-4, 1.6e-4 over the four
calls).  One spawn for the three, with a deadline."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as mesh_mod

ARCHS = ("qwen3_0_6b", "rwkv6_3b", "jamba_1_5_large_398b")
SPAWN_TIMEOUT_S = 150
B, S, STEPS = 4, 16, 3


def _serve(arch: str, mesh=None) -> list:
    from repro_torch.distributed.param_sharding import shard_params
    from repro_torch.distributed.sharding import default_rules
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", tp_pad=4)
    rules = None if mesh is None else default_rules(mesh)
    params = init_params(cfg, seed=0, device="cpu")
    if rules is not None:
        shard_params(params, rules)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
    logits, cache = make_prefill_step(cfg, rules, S_max=S + STEPS)(params, {"tokens": toks})
    out = [logits]
    serve = make_serve_step(cfg, rules)
    for i in range(STEPS):
        logits, cache = serve(params, cache, {"tokens": out[-1].argmax(-1)[:, None]}, S + i)
        out.append(logits)
    return [o.full_tensor() if hasattr(o, "full_tensor") else o for o in out]


def serve_rank(mesh):
    return {arch: _serve(arch, mesh) for arch in ARCHS}


@pytest.fixture(scope="module")
def ranks():
    outs = mesh_mod.spawn_mesh(serve_rank, data=2, model=2, device="cpu",
                               timeout_s=SPAWN_TIMEOUT_S)
    return outs[0].result


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_one_device(ranks, arch):
    for i, (got, exp) in enumerate(zip(ranks[arch], _serve(arch))):
        bound = 1e-5 if i == 0 else 1e-3
        assert float((got - exp).abs().max()) <= bound * float(exp.abs().max()), (arch, i)
        assert torch.equal(got.argmax(-1), exp.argmax(-1)), (arch, i)
