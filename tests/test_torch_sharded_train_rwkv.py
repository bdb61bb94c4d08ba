"""One sharded train step of SMOKE RWKV-6 (``tp_pad=4``, float32) on a
(2, 4) mesh of gloo CPU ranks against the JAX package's single-device step
(``test_torch_sharded_train.py``'s recipe and bounds): the WKV scan runs on
each rank's (batch over dp, heads over tp) shard, through its plain
version on the CPU."""
from test_torch_sharded_train import run_and_compare


def test_rwkv6_sharded_step_matches_the_jax_single_device_step(tmp_path):
    run_and_compare("rwkv6_3b", tmp_path)
