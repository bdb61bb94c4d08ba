"""Dot-FLOP parity of the port's accounting with the reference's
``analyze_hlo``, train steps (SMOKE, B = 2, S = 64, one device).

The port's train step does more dot FLOPs than the reference's by two
named terms, each pinned here from the config:

* **the head's recompute**, 2 B S d V: ``chunked_ce_loss`` runs each loss
  chunk under ``torch.utils.checkpoint``, so the backward recomputes the
  head product; the reference's ``lax.scan`` saves its residuals;
* **unit contractions**: the backward of three contracting einsums gives
  one gradient as an outer product, which autograd dispatches as a ``bmm``
  with a contraction of length 1 and XLA's simplifier rewrites as a
  broadcast multiply (no dot in the HLO): the chunked WKV's ``y``
  (2 B S H dk dv a RWKV layer), the chunked selective scan's ``y``
  (2 B S d_inner d_state a Mamba layer) and the dense MoE combine
  (2 B S E d an MoE layer).

Nothing else differs: the totals minus these terms are equal.  Jamba's
case is in ``test_torch_dryrun_train_jamba.py`` (its compile alone takes
half a minute).
"""
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.models.rwkv6 import _heads
from test_torch_dryrun_parity import B, S, jax_dot_flops, port_cell


def head_recompute(cfg) -> int:
    return 2 * B * S * cfg.d_model * cfg.vocab


def unit_contractions(cfg) -> int:
    """The outer products the port's backward dispatches as dots."""
    total = 0
    for _ in range(cfg.n_groups):
        for mixer, ffn in cfg.pattern:
            if mixer == "rwkv":       # H heads of dk = dv = head_dim
                H = _heads(cfg.d_model, cfg.rwkv_head_dim, cfg.tp_pad)
                total += 2 * B * S * H * cfg.rwkv_head_dim ** 2
            if mixer == "mamba":
                total += 2 * B * S * cfg.mamba_expand * cfg.d_model * cfg.mamba_d_state
            if ffn == "moe":
                total += 2 * B * S * cfg.moe.n_experts * cfg.d_model
    return total


CASES = [
    # arch, reference dot FLOPs, head recompute, unit contractions
    ("qwen3_0_6b", 106_954_752, 8_388_608, 0),
    ("rwkv6_3b", 127_401_984, 8_388_608, 524_288),
]


def check_train(arch, ref, head, unit):
    cfg = get_smoke_config(arch)
    assert head_recompute(cfg) == head and unit_contractions(cfg) == unit
    assert jax_dot_flops(arch, "train", {}) == ref
    assert port_cell(arch, "train", {})["dot_flops"] == ref + head + unit


@pytest.mark.parametrize("arch,ref,head,unit", CASES, ids=[c[0] for c in CASES])
def test_train_dot_flops_differ_by_the_named_terms(arch, ref, head, unit):
    check_train(arch, ref, head, unit)
