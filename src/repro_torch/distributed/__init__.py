"""Distribution: the elastic pool policy the control plane hands off to.

Only ``elastic.py`` is ported so far (numpy only); the mesh sharding and the
coded on-mesh runtime of the reference's ``distributed/`` are not.
"""
from repro_torch.distributed.elastic import CodedElasticPolicy, plan_shrink

__all__ = ["CodedElasticPolicy", "plan_shrink"]
