"""Core: the paper's coded-matmul schemes, decoding, bounds, plans, and the
straggler simulator."""
from repro_torch.core.api import (
    CodedMatmulPlan,
    coded_matmul,
    encode_blocks,
    extend_plan,
    fused_worker_products,
    make_plan,
    plan_from_arrays,
    shrink_plan,
    uncoded_matmul,
    worker_products,
)
from repro_torch.core.bounds import (
    BoundsReport,
    choose_s,
    conservative_L,
    is_safe,
    plan_p_prime,
)
from repro_torch.core.decoding import (
    DecodePanel,
    DecodePanelCache,
    decode,
    decode_masked,
    decode_with_panel,
    decode_with_weights,
    digit_extract,
    make_decode_panel,
)
from repro_torch.core.numerics import DEFAULT_DTYPE, resolve_device, resolve_dtype
from repro_torch.core.partition import GridSpec, block_decompose, block_recompose, unpad
from repro_torch.core.points import extend_points, make_points
from repro_torch.core.schemes import (
    EntangledBoundedScheme,
    PolynomialCodeYu,
    Scheme,
    TradeoffScheme,
    make_scheme,
)
from repro_torch.core.simulator import (
    LatencyModel,
    WorkerTimes,
    completion_quantile,
    masked_completion_cdf,
    masked_completion_mean,
    masked_completion_quantile,
    simulate_completion,
)

__all__ = [
    "CodedMatmulPlan", "coded_matmul", "make_plan", "plan_from_arrays", "encode_blocks",
    "uncoded_matmul", "worker_products", "fused_worker_products",
    "extend_plan", "shrink_plan",
    "BoundsReport", "choose_s", "conservative_L", "is_safe", "plan_p_prime",
    "decode", "decode_masked", "digit_extract",
    "DecodePanel", "DecodePanelCache", "decode_with_panel",
    "decode_with_weights", "make_decode_panel",
    "DEFAULT_DTYPE", "resolve_device", "resolve_dtype",
    "GridSpec", "block_decompose", "block_recompose", "unpad",
    "extend_points", "make_points",
    "EntangledBoundedScheme", "PolynomialCodeYu", "Scheme", "TradeoffScheme",
    "make_scheme",
    "LatencyModel", "WorkerTimes", "simulate_completion",
    "completion_quantile", "masked_completion_cdf",
    "masked_completion_mean", "masked_completion_quantile",
]
