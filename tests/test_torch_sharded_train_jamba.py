"""One sharded train step of SMOKE Jamba (``tp_pad=4``, float32) on a
(2, 4) mesh of gloo CPU ranks against the JAX package's single-device step
(``test_torch_sharded_train.py``'s recipe and bounds; 8 x 32 tokens, to
keep the file under a minute): the selective scan
runs on each rank's (batch over dp, d_inner over tp) shard through its
plain version on the CPU, the MoE FFNs through the expert-parallel path
(SMOKE's capacity_factor 4.0 drops no token at top-2 of 4 experts).

``aux_coef`` is 0 in both packages: the expert-parallel aux loss is, by the
reference's definition, the mean over the ranks of each shard's Switch
loss, which is not the dense path's loss over all tokens (its equality to
that mean is held in ``tests/test_torch_moe_ep.py``)."""
from test_torch_sharded_train import run_and_compare


def test_jamba_sharded_step_matches_the_jax_single_device_step(tmp_path):
    run_and_compare("jamba_1_5_large_398b", tmp_path, seq=32, aux_coef=0.0)
