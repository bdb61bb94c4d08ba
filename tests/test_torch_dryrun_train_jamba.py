"""Jamba's train step against the reference's ``analyze_hlo``: the terms of
``test_torch_dryrun_train.py`` (the head's recompute, and the unit
contractions of its seven Mamba layers and four dense MoE layers), in a
file of its own to keep each file under a minute.
"""
from test_torch_dryrun_train import check_train


def test_jamba_train_dot_flops_differ_by_the_named_terms():
    # 7 x 2 B S d_inner d_state + 4 x 2 B S E d = 3_670_016 + 262_144
    check_train("jamba_1_5_large_398b", 771_948_544, 8_388_608, 3_932_160)
