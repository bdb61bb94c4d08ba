"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates).

The rates assume the card's full 700 W power limit; a run reports the
card's limit beside every share of them.
"""

FP64_TENSOR_FLOPS = 67e12     # FP64 tensor core, FLOP/s
HBM_BYTES_PER_S = 3.35e12     # HBM3, bytes/s
