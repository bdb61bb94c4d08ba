"""Distribution: mesh axes and sharding rules, the elastic pool policy, the
coded on-mesh layer and integer-grid gradient compression."""
from repro_torch.distributed.coded import CodedLinearPlan, coded_matmul_mesh
from repro_torch.distributed.compression import (
    compressed_psum,
    dequantize_tree,
    error_feedback_update,
    quantize_tree,
)
from repro_torch.distributed.elastic import CodedElasticPolicy, plan_shrink
from repro_torch.distributed.sharding import (
    AxisRules,
    axis_rules,
    current_rules,
    logical_sharding,
    shard,
)

__all__ = ["AxisRules", "axis_rules", "current_rules", "logical_sharding", "shard",
           "CodedElasticPolicy", "plan_shrink", "CodedLinearPlan",
           "coded_matmul_mesh", "quantize_tree", "dequantize_tree",
           "compressed_psum", "error_feedback_update"]
