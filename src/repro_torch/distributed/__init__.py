"""Distribution: the elastic pool policy, the coded on-mesh layer and
integer-grid gradient compression.

The reference's ``sharding.py`` and ``param_sharding.py`` (logical axis
rules mapping LM parameters onto mesh axes) belong with the sharded LM
paths and are not ported here.
"""
from repro_torch.distributed.coded import CodedLinearPlan, coded_matmul_mesh
from repro_torch.distributed.compression import (
    compressed_psum,
    dequantize_tree,
    error_feedback_update,
    quantize_tree,
)
from repro_torch.distributed.elastic import CodedElasticPolicy, plan_shrink

__all__ = ["CodedElasticPolicy", "plan_shrink", "CodedLinearPlan",
           "coded_matmul_mesh", "quantize_tree", "dequantize_tree",
           "compressed_psum", "error_feedback_update"]
