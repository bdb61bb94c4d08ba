"""``train_loss`` and every gradient leaf of the port (on the CPU) against
the JAX package's, for the SMOKE configs with MoE FFNs, sliding windows,
the selective scan and rotary attention (``tests/test_torch_train.py``
holds the others and the method; this file keeps each file's run under a
minute).  Jamba goes through the selective-scan kernel's path
(``MambaScanFused``; its plain version here, the reference's Pallas
forward in interpret mode).  Tolerances: the loss within 1e-5, every
gradient leaf within 1e-3 of its largest value, in float32.
"""
import pytest

from test_torch_train import _assert_train_matches


@pytest.mark.parametrize("arch,kernel", [
    ("jamba_1_5_large_398b", True), ("qwen3_0_6b", False), ("qwen2_0_5b", False),
    ("gemma3_12b", False), ("qwen2_moe_a2_7b", False), ("qwen3_moe_235b_a22b", False)])
def test_train_loss_and_grads_match_jax(rng, arch, kernel):
    _assert_train_matches(rng, arch, kernel)
