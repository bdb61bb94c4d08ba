#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout (needs one NVIDIA Hopper card, nvcc):

    python3 chip_smoke.py [--seed N]

Phases, each raising on failure:

1. device  - the card's name and power limit, CUDA version;
2. build   - nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
             (one process per source, all at once) and prints ``-Xptxas -v``;
             ``cuobjdump -sass`` must show DMMA (FP64 tensor-core)
             instructions in every float64 kernel behind
             ``repro_fused_worker_f64`` (its cluster form too) and
             ``repro_matmul_t_f64``; the scan
             kernels' registers and spills are printed, and the selective
             scan's SASS must hold MUFU.EX2 (its one-op exponentials); the
             per-chunk decode's (kernel 3) registers and spills are printed,
             and its float64 bulk-copy instances must hold UBLKCP; so are
             the registers and spills of the bf16/f16 instances of kernels
             1, 4 and 5, and every bf16/f16 TMA instance of kernels 1 and 5
             must hold HGMMA (wgmma) and UTMALDG (TMA loads), every
             16-byte-form instance of kernel 4 LDG.E.128 and STG.E.128 and
             no spills;
3. kernels - each kernel against its plain PyTorch version on the card, at a
             ragged small shape and at the main path's shapes; kernels 1 and
             5 also with K=1 and with a row stride that is (16-byte copies)
             and is not (one-element copies) 16-byte aligned, integer inputs
             exactly and random ones to a tolerance; kernel 3 in both copy
             forms (bulk copies on aligned chunk bounds, one-element
             loads on odd ones), exactly;
4. main    - ``CodedMatmul(plan)`` on the default "fused" backend serves
             requests at the paper's geometry (bec p=m=n=2, K=10,
             equispaced points, v=r=t=8000, float64, entries in {0..15})
             under rotating erasure patterns; every C must equal A^T B
             element for element, every request must launch each of its
             path's kernels as often as the path says (kernel 1 in its
             float64 cluster form every time), and the pipeline memo must
             not rebuild;
   4b staged  - the same requests on the "staged" backend (encode kernel
             twice, block-matmul kernel once per worker, decode kernel);
   4c partial - ``CodedMatmul(plan, sub_tasks=4)`` under fractional
             progress vectors (fused kernel, per-chunk decode kernel), one
             Q=1 binary request (the binary decode kernel), and one
             worker_stage + decode_stage pair;
   4d captured - ``CodedMatmul.capture`` puts one request of each path
             (fused, staged, partial Q=4) into a CUDA graph with a device
             mask (progress) buffer: the traced kinds, whose decode panel
             is solved on the card.  Launches are counted at the eager
             warm-up and at the capture (twice a request's), none at a
             replay, and printed on 4d's own line, out of the kernels
             line's counts.  The graph is replayed under phase 4's erasures (4c's
             progress vectors), each written into the buffer; every replay
             must equal A^T B and the concrete request's C, and its
             CUDA-event time is printed beside the concrete request's wall.
             The bunched set (workers 0-5 erased) is replayed too and both
             paths' max errors printed, not gated.  torch.profiler lists one
             replay's device work: our kernels as in a concrete request,
             besides them only the panel's launches, no host copy; the
             replay's device time is split into kernels, panel and the
             erase and recompose;
5. times   - each kernel, its plain version and one PyTorch call computing
             the same function, timed with CUDA events at the main path's
             shapes, beside the least time the card could take; kernels 1
             and 5 also as TFLOP/s and share of the FP64 tensor peak, and
             the encode's share of kernel 1 (kernel 1 - K x kernel 5);
             kernel 1 in float64 also in its tile form on the same
             operands, in its cluster form at P=Q=1 (one block a side: the
             same FLOP, a quarter of the raw bytes), and the clusters the
             card holds at once;
             kernel 3 also as GB/s and share of its bound, against its floor
             (the run fails above it), at Q=1 beside kernel 2 on the
             same Y, and its 16-row instance (mn 16, 20 and 24; K 10 and
             40) exactly against the plain version and timed;
6. rwkv    - LM serving: RWKV-6 3B whole (``configs/rwkv6_3b.py``, bf16,
             random weights from the seed) with the WKV kernel, 4 prompts of
             1024 tokens then 16 greedy tokens; prefill logits against the
             plain chunked WKV on the same weights (in float32, and in bf16
             to the run's bf16 rounding scale), prefill(1024) + one decode
             step against prefill(1025), 32 WKV launches per prefill and
             none per decode step;
7. obs     - observability on the main path: one fused request per erasure
             pattern with ``repro_torch.obs`` off, then on (a fresh facade),
             plus one staged and one partial request with it on; obs-on C
             bit-identical to obs-off C and to A^T B, one pipeline build per
             kind, ``executable_cache_size`` flat, ``kernel.call`` equal to
             the launch deltas, one panel miss per pattern; the kernel spans
             beside phase 5's times, the walls on vs off, and the Perfetto and
             Prometheus dumps written, read back, checked and rendered;
8. paper   - the paper's experiments at its own v = 8000 through the port's
             benches: Table I (``benchmarks/torch_table1_error.py``, fused
             kernels and the plain reference on the card; the bound-15 control
             row must be exact), Fig. 1 (``torch_fig1_latency.py`` on
             ``configs/paper_matmul.py``; bec flat through 6 stragglers and up
             at 7, polycode up from 2) and the p' tradeoff sweep
             (``torch_tradeoff_sweep.py``, 8000 columns);
   6b jamba - the same for Jamba-1.5-Large at full width, cut to one
             pattern group (8 layers: 1 attention + 7 Mamba) with every FFN
             the dense MLP (the MoE layers cut), through the selective-scan
             kernel (7 launches per prefill);
9. control - the adaptive control plane (``repro_torch.control``): 9a
             replays the 13 checked-in control golden traces
             (``tests/golden``) on the fused and the staged kernels, each
             with an empty ``Trace.diff`` and every step exact; 9b serves
             ``configs/paper_matmul.py``'s 8000^2 geometry (K=10, float64,
             entries in [-2, 2]) through ``AdaptiveServer`` on a bec/polycode
             ``PlanLadder`` of fused kernels: heavy_tail (binary erasure),
             crawler (``sub_tasks=4``) and the elastic pool_resize recipe
             (shrink 10 -> 7 onto bec, grow to 9 with polycode back), every
             C equal to A^T B, each step's launches as its path says, no
             pipeline build outside a handoff; 9c repeats the heavy_tail run
             at the main path's entries {0..15}, printing each step's
             exactness beside its decode panel's gain (not gated); then the
             control bench twin (``benchmarks/torch_control_bench.py``) runs
             its ``--check`` gates on the fused kernels;
10. serve  - the multi-tenant serve tier (``repro_torch.serve``) and the
             serving CLI: 10a replays the golden serve trace
             (``tests/golden/serve_heavy_tail.jsonl``) on the fused and the
             staged kernels, diff empty, every batch exact and every product
             bit-identical to a synchronous facade call; 10b serves the CLI's
             tier geometry at v = 8000 (grid (4, 2, 1), K=12, A and B 8000 x
             4000 float64, entries in [-4, 4], L = conservative_L(8000, 4, 4):
             s = 2^18, bec infeasible) on fused kernels with buckets
             (1, 2, 4, 8): DEFAULT_SPEC's three tenants under heavy_tail, 12
             requests each, pipelined, then back to back (max_batch=1), then
             sub_tasks=4 under crawler, on one ladder; no pipeline build after
             prewarm, each batch launching ``bucket`` of the worker and the
             decode kernel, every batch exact (the oracle on the card, outside
             the wall) and every product bit-identical to a synchronous facade
             call at its batch's rung and erasure; it prints each batch's wall
             and panel gain, each run's wall and completions per second, the
             begin_step host time, the serve.* spans, the peak memory and the
             simulated tenant table; 10c calls ``coded_serve.main`` in its
             modes (the tier at v = 8000, exact) and runs the serve bench
             twin's ``--check`` gates on the fused kernels;
11. mesh   - the mesh backend: ``launch/mesh.py::spawn_mesh`` starts a
             (1, 10) mesh, ten ranks sharing the one card over gloo (the
             worker products staged through pinned host memory), each rank
             one coded worker of the main path's geometry with A and B made
             from the seed by the card's generator; four fused binary
             requests (phase 4's erasures), four partial Q=4 requests
             (phase 4c's progress vectors), one staged request, and one
             "traced" and one ("partial-traced", 4) request (a device mask
             and progress that no host reads; the panels solved on every
             rank) through ``CodedMatmul(plan, "mesh")``.  Every rank's C must equal A^T B
             and be bit-identical to the local fused facade's C (digests
             from the parent), each request must launch on every rank
             kernels 1 and 2 (or 3), or 4 twice, 5 and 2, and each kind
             build one pipeline; rank 0 prints each request's wall (host
             clock between two barriers, ended by a synchronize) split into
             the product and decode (CUDA events) and the gather (host
             clock), and every rank's peak memory.  The ranks' launches join
             the ``kernels`` line.

Phase 3h holds the bf16 and f16 instances of kernels 1, 4 and 5 against
their plain versions (FP32 sums, each result rounded once to its output
dtype) at a ragged shape and at the main path's (K=10, P=Q=4, 4000^2
blocks), with a 16-byte aligned row stride (16-byte copies) and an odd one
(2-byte loads): integer inputs in [-4, 4] exactly (also with float32
output), random normal ones within 2e-2 of the largest value; kernel 4
also on ragged rows of widths 264 and 520 (P = 20, K = 17), each case
checked to take the form its layout picks (16 bytes on aligned rows whose
width is a multiple of 8, else one element).  Phase 4h
drives the worker stage at the paper's geometry in bf16 and in f16
through the public ``ops`` entry points (normal coefficients and operands
from the seed):
``ops.fused_worker`` once, ``ops.encode`` twice and ``ops.matmul_t`` once
per worker, counts set to 0 just before each dtype and read just after;
those launches are the half entries' in the ``kernels`` line.  The fused
Y must equal the staged Y bit for bit, and kernel 4 must take its 16-byte
form.  Phase 5h
times each half kernel, its plain version and one PyTorch call (cuBLAS's
reduced-precision reductions off) beside its bound at the bf16/f16 tensor
peak and the HBM rate; kernel 4 also as GB/s beside one torch copy of as
many bytes (a measured ceiling; the port never calls it).  Phase 6c
serves ``granite_3_8b``, ``qwen3_0_6b`` and ``qwen2_0_5b`` whole (bf16
weights from the seed, rotary positions, the traffic of phase 6, no kernel
on their path), gated on prefill(1024) + decode against prefill(1025) and
finite logits, printing prefill and
decode times, tokens/s, parameters and peak memory; Granite is freed
before phase 6d runs ``examples/torch_serve_lm.py`` on the card: the smoke
Qwen3 served, then its coded lm_head on a (2, 4) mesh of eight ranks
sharing the card (100% argmax agreement, zero drift, every rank launching
kernels 1 and 2 twice; the ranks' launches join the ``kernels`` line).
Phases 6e-6h run after 6d and launch no kernel (no Pallas kernel lies on
their path in the reference either).  6e serves ``gemma3_12b`` whole (40
sliding-window layers of window 1024 with ring caches, 8 global) on 4
prompts of 2048 tokens, gated as 6c: prefill(2048) + a decode step at
position 2048, through the rings, against prefill(2049).  6f serves
``qwen2_moe_a2_7b`` whole and 6g ``qwen3_moe_235b_a22b`` at full width cut
to 8 layers, on the dense MoE path; their bf16 decode-vs-prefill(1025)
distance is printed with the last token's routing flips between the two
paths (each must lie at a near-tie), and the gate runs in float32 within
1e-3 (Qwen3 on its first 4 layers).  6h runs Jamba-1.5-Large's expert
layer alone at full width (``apply_moe``, 16 experts top-2 of d_ff 24576)
on the 4 x 1024 prefill's tokens and on a 4-token batch, held on 64
tokens from the seed against each token's own top-2 experts summed in
float32 (5e-2).  Each prints its parameters, bytes, times, tokens/s and
peak memory beside the card's name and power limit.

Phases 6i-6j and 12a-12d run last.  6i serves ``musicgen_medium`` whole
and 6j ``qwen2_vl_72b`` at full width cut to 32 of 80 layers (embedding
input through the serve CLI's stub frontend, sinusoidal and multimodal
positions, no kernel on their path), on the traffic of phase 6; gates: the
position table on the card against the CPU's, prefill(960) + 64 decode
steps on the known inputs against prefill(1024) (multimodal position ids
arange on the three axes) within 5e-2 in bf16 and 1e-3 in float32 (6j on
its first 4 layers), finite logits.  12a holds ``WkvFused`` (kernel 7
forward) at RWKV6-3B's shapes and ``MambaScanFused`` (kernel 6 forward) at
a Jamba mamba layer's against autograd through the plain scans, every
input's gradient within 1e-3, and times the forward kernel and the
backward apart.  12b trains ``rwkv6_3b`` whole through ``make_train_step``
(4 steps of 4 x 1024 tokens from ``make_pipeline``; per step ms, tokens/s
and the share of the bf16 peak that ``model_flops`` makes; peak memory;
kernel 7 twice a layer a step, remat recomputing the forward), after its
kernel path is held against the plain one in float32 on 4 layers (loss
1e-4, every gradient leaf 1e-3).  12c trains ``qwen3_0_6b`` whole the same
way, and Jamba's SMOKE config through kernel 6 against its plain path.
12d runs the trainer CLI (6 steps checkpointing every 3; the checkpoint of
step 3 checked to be the reference's layout, its manifest keys and one leaf
per stacked leaf; resumed from it, its losses equal) and
``examples/torch_train_lm.py --quick`` on the card.  Their launches join
the ``kernels`` line.

Phase 3c (after 3b) holds, on the card, each shape past a cap the kernels
once had (not the TPU kernels) against its plain version: the polycode K=100 plan's
(64, 100) float64 decode panel (51,200 bytes) and a (300, 100) one past the
card's per-block shared memory through kernels 2 and 3 (row slabs), 200
chunks through kernel 3 (groups of 128, aligned, odd and stacked bounds),
P = Q = 80 blocks through kernels 1 and 4 in float64 and bf16 (kernel 4
also with a 256,000-byte panel: slabs of workers), WKV at dk 128, 256, 96
and 320 and dv 256, and the selective scan at s 64, 24 and 100; the decode
bit for bit, the rest within phase 3/3b's tolerances; its launches (each
row slab, chunk group, worker slab and scan group counts) join the
``kernels`` line.

Phases 13a-13b run last, on ranks sharing the card over gloo
(``launch/mesh.py``; the all_to_all and the DTensor collectives cross host
memory: a stand-in for NCCL).  13a runs Jamba-1.5-Large's expert layer at
full width expert-parallel on a (1, 4) mesh (4 of the 16 experts a rank,
CUDA IPC views of the parent's weights) on 6h's 4 x 1024 tokens
(sequence-sharded four ways) and a 4-token decode batch: at
capacity_factor E/k no token-slot drops and the output holds to
``_moe_dense``'s on the same tokens (5e-2, 6h's bound); at the config's
1.25 the dropped share is printed; the all_to_all and the expert products
are timed apart, and each rank's peak memory printed.  13b runs one
``make_train_step(cfg, ocfg, rules)`` step on a (2, 2) mesh of four ranks
(FSDP + TP + EP by the reference's rules, float32, 4 x 1024 tokens from
``make_pipeline``) of Qwen3-0.6B at full width cut to 4 of 28 layers,
RWKV6-3B at full width cut to 2 of 32 layers (kernel 7 per shard) and
Jamba's SMOKE config (kernel 6 per shard, EP; aux_coef 0, as the EP aux
loss is by definition not the dense one), each against the single-device
step on the card: the loss and the gradient norm within 1e-4 relative,
each gradient leaf (taken in a pass of its own before the step) within
1e-3 of its largest value, every parameter after the step within 1e-2; it
prints the step times, the peak memory and the scan launches per rank,
which join the ``kernels`` line.

Phase 14 runs after 13b: the dry run's accounting
(``launch/hlo_analysis.py``, ``launch/dryrun.py``) on the card.  One real
train step each of 12c's Qwen3-0.6B and 12b's RWKV6-3B (kernel 7; 4 x
1024 tokens, after ``reset_peak_memory_stats``) runs under the accounting,
while child processes trace the same steps on one device with
``trace_cell`` on CUDA fake tensors (no memory, no launch): the dot FLOPs
and dot counts must be equal, kernel 7 a custom op 64 times in both (and
64 launches), and the predicted peak (arguments + the step's peak
allocation) within 10% of ``max_memory_allocated``; it prints
dot_flops / model_flops.  Two production cells trace on the fake 16 x 16
mesh (256 ranks, the child's fake process group): qwen3_0_6b x train_4k
and rwkv6_3b x prefill_32k with the WKV kernel, printing GiB, dot FLOPs
and collective bytes a device, the dominant roofline term at the H100
figures and the trace time.  RWKV6-3B's and Jamba's prefills (phases 6,
6b, through the kernels' custom ops) print beside their times from before
the custom ops.

Phases 7-11 run after phase 5b and before the LM phases.  Phase 3b holds
the WKV and selective-scan kernels against their plain versions at the LM
prefill's shapes, at ragged shapes and (the selective
scan) at the Jamba initialisation's long-memory regime; phase 5b times them
beside their bounds (the selective scan's also beside the MUFU time of its
one-op exponentials), the previous design's times and their floors.  Each
path's launch counts are set to 0 just before it and read just after.
The line before the last is a JSON object describing every kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(1, str(Path(__file__).resolve().parent / "examples"))

import dataclasses  # noqa: E402
import gc  # noqa: E402
import re  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks import (  # noqa: E402
    torch_control_bench,
    torch_fig1_latency,
    torch_serve_bench,
    torch_table1_error,
    torch_tradeoff_sweep,
)
from benchmarks.torch_obs_util import CompileWatch  # noqa: E402
from benchmarks.torch_roofline import mem_gib, terms  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.chaos import Trace, make_scenario  # noqa: E402
from repro_torch.chaos.golden import (  # noqa: E402
    GOLDEN_GRID,
    GOLDEN_K,
    GOLDEN_L,
    golden_names,
    replay_golden,
)
from repro_torch.configs import SHAPES, ShapeSpec, get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.paper_matmul import CONFIG as PAPER  # noqa: E402
from repro_torch.control import AdaptiveServer, ExpectedLatencyPolicy, PlanLadder  # noqa: E402
from repro_torch.core import bounds, make_plan  # noqa: E402
from repro_torch.core.partition import block_decompose  # noqa: E402
from repro_torch.kernels import _build, coded_decode, coded_fused, mamba_scan, ops, ref  # noqa: E402
from repro_torch.data import make_pipeline  # noqa: E402
from repro_torch.launch import coded_serve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import spawn_mesh  # noqa: E402
from repro_torch.launch.serve import _make_batch, generate  # noqa: E402
from repro_torch.launch.hlo_analysis import OpAccounting  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import to_batch  # noqa: E402
from repro_torch.models import cache_shapes, decode_step, init_params, prefill  # noqa: E402
from repro_torch.models import param_shapes  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import train_loss  # noqa: E402
from repro_torch.models.mamba import MambaScanFused, mamba_scan_backward  # noqa: E402
from repro_torch.models.moe import apply_moe, init_moe  # noqa: E402
from repro_torch.models.rwkv6 import WkvFused, wkv_backward  # noqa: E402
from repro_torch.models.stats import model_flops, param_counts  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.obs import export, report  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    CodedMatmul,
    ErasurePattern,
    PartialPattern,
    chunk_bounds,
)
from repro_torch.serve import (  # noqa: E402
    DEFAULT_SPEC,
    GOLDEN_SERVE_OVERHEAD_S,
    ServeTier,
    ServeTrace,
    golden_serve_result,
    parse_tenant_spec,
)
from repro_torch.serve.trace import golden_operands, with_golden_meta  # noqa: E402
import torch_serve_lm  # noqa: E402  (examples/torch_serve_lm.py)
import torch_train_lm  # noqa: E402  (examples/torch_train_lm.py)

# Published H100 SXM peaks at 700 W (NVIDIA data sheet).
PEAK_FP64_TENSOR = 67e12     # FLOP/s, FP64 on the tensor cores (DMMA)
PEAK_FP64_VECTOR = 34e12     # FLOP/s, FP64 outside the tensor cores
PEAK_FP32 = 67e12            # FLOP/s, FP32 outside the tensor cores
PEAK_BF16_TENSOR = 989.4e12  # FLOP/s, dense bf16 and f16 on the tensor cores
PEAK_HBM = 3.35e12           # bytes/s

# The paper's geometry (configs/paper_matmul.py) at entry bound 15, which is
# exact in float64 (the paper's entry bound 50 is not: see ROADMAP.md).
MAIN = dataclasses.replace(PAPER, entry_max=15)
V, R, T = MAIN.v, MAIN.r, MAIN.t
ENTRY_MAX = MAIN.entry_max
# Survivor sets bunched at one end of [-1, 1] amplify rounding in the decode
# (erasing workers 0-5 multiplies it by 243 and is inexact even here); these
# patterns amplify it by at most 15.2.
ERASURES = ([0, 2, 4, 6, 8, 9], [1, 3, 5, 7, 9], [], [2, 3, 4, 5, 6, 7])
BUNCHED = [0, 1, 2, 3, 4, 5]  # panel gain 243: inexact at 8000^2 (ROADMAP.md)
# Partial stragglers at Q=4 sub-tasks: completed chunks per worker, each
# vector spanning (>= tau=4 workers per chunk) with every chunk's panel gain
# (max row sum of |W|) at most 10.0, picked with the panel cache on the CPU.
Q_SUB = 4
PROGRESS = ([4, 1, 4, 0, 0, 1, 3, 4, 1, 4], [3, 3, 2, 2, 1, 2, 3, 0, 2, 3],
            [4, 0, 2, 1, 2, 0, 2, 4, 2, 0], [3, 3, 3, 3, 3, 3, 0, 3, 3, 3])
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# bf16 / f16 kernels 1, 4 and 5 (FP32 sums, each result rounded once to its
# output dtype) against their plain versions: random normal inputs within
# 2e-2 of the largest value (tests/test_kernels.py's bf16 bound), integer
# inputs in [-4, 4] exactly (every partial sum an integer below 2^24).
HALF = (torch.bfloat16, torch.float16)
HALF_TOL = 2e-2
HALF_NAME = {torch.bfloat16: "bf16", torch.float16: "f16"}
HALF_KERNELS = ("fused_worker", "encode", "matmul_t")
# Floors for the tensor-core kernels 5 and 1, printed beside the phase-5
# times: kernel 5 twice as fast as the FMA kernel it replaced (8.986 ms on
# an H100 80GB HBM3 at 700 W); kernel 1 in float64 below its tile form
# (75.8-76.4 ms there) with room above its cluster form (51.2 ms there)
FLOOR_MS = {"matmul_t": 4.5, "fused_worker": 60.0}
# Kernel 3 at Q=4, K=10, E=16e6 float64 (bounds form): 67% of its 0.535 ms
# bytes bound; the design before its redesign took 1.092 ms (this script on
# an H100 80GB HBM3 at 700 W).  Missing it fails the run.
FLOOR_MS["decode_partial"] = 0.80
DECODE_PARTIAL_BEFORE_MS = 1.092
# The scan kernels at the LM prefill shapes: the previous design's times (WKV
# a block per (batch, head) and a thread per value column, the scan an
# accurate expf per state; this script on an H100 80GB HBM3 at 700 W) and
# the floors of the present design, half and two thirds of those
SCAN_BEFORE_MS = {"wkv_scan": 1.401, "mamba_scan": 0.945}
SCAN_FLOOR_MS = {"wkv_scan": 0.70, "mamba_scan": 0.63}
SMS = 132                    # H100 SXM streaming multiprocessors
MUFU_EX2_PER_CLOCK = 16      # per SM, compute capability 9.0 (CUDA C Programming Guide)
# Phase 9: the checked-in control golden traces, and the golden recipe's
# constant per-rung overheads (units of one worker step), which keep the
# rung sequence at 8000^2 deterministic (measured overheads carry noise).
GOLDEN_DIR = Path(__file__).resolve().parent / "tests" / "golden"
PAPER_OVERHEAD_S = {"bec": 2.0, "polycode": 0.1}
# Phase 10: the serve CLI's tier geometry (``launch/coded_serve.py``) at the
# paper's inner dimension v = 8000: grid (4, 2, 1), K = 12, r = t = v/2,
# entries in [-4, 4] and L = conservative_L(v, 4, 4) (s = 2^18, bec
# infeasible), DEFAULT_SPEC's three tenants, 12 requests each.
TIER_GRID, TIER_K, TIER_ENTRY = (4, 2, 1), 12, 4
TIER_BUCKETS = (1, 2, 4, 8)
TIER_REQUESTS = 12
# Phase 11: a (1, K) mesh of K = 10 ranks sharing the one card (gloo; NCCL
# refuses two ranks of a communicator on one GPU), operands from their own
# seed; the outer deadline of the spawned ranks.
MESH_SEED = 11
MESH_TIMEOUT_S = 300
KERNELS = ("fused_worker", "decode", "encode", "matmul_t", "decode_partial",
           "mamba_scan", "wkv_scan")
# the dense-attention configs served whole in phase 6c, largest first
DENSE_ARCHS = ("granite_3_8b", "qwen3_0_6b", "qwen2_0_5b")

# LM serving traffic (phases 6, 6b): 4 prompts of 1024 tokens, 16 greedy
# tokens each; the scan kernels are held at the prefill's shapes.
LM_BATCH, LM_PROMPT, LM_GEN = 4, 1024, 16
WKV_SHAPE = dict(B=LM_BATCH, S=LM_PROMPT, H=48, dk=64)       # rwkv6_3b, tp_pad 16
MAMBA_SHAPE = dict(B=LM_BATCH, S=LM_PROMPT, d=16384, s=16)   # jamba d_inner, d_state
LM_TOL = 5e-2       # the reference's decode-vs-full-forward bound (bf16)
# Kernel against plain prefill logits on the same weights.  In bf16 two
# correct float32 scans round the model's bf16 activations differently and
# random layers amplify that: computing the plain path's scans in float64
# moves RWKV-6 3B's bf16 logits by 6.7e-2 (``python -m
# repro_torch.launch.lm_precision``), above the 5e-2 a bf16 bound would
# allow.  So the kernel is held in float32 (the weights upcast exactly),
# where rounding starts at 1e-7, and in bf16 to the bf16 rounding scale
# measured in the same run (plain bf16 vs plain float32).
LM_F32_TOL = 1e-3
SCAN_TOL = 1e-4     # max |kernel - plain| / max |plain|, float32
# Phase 6e: Gemma-3-12B's prompts.  At 1024 tokens its band (window 1024)
# would mask nothing in the prefill; at 2048 the later q chunks' key range
# starts past key 0 and the ring caches are primed with more tokens than
# slots, so prefill(2048) + decode against prefill(2049) holds the ring.
GEMMA_PROMPT = 2048
# Phase 6g: Qwen3-MoE-235B-A22B at full width, cut in depth to fit the card
# (8 x 2.49 B parameters + 1.24 B of embedding and head, 42 GB in bf16).
QWEN3_MOE_LAYERS = 8
# Phases 6f-6g: the MoE configs' decode-vs-prefill gate.  In bf16 the two
# paths' router inputs differ by bf16 rounding, which moves router logits by
# more than some tokens' top-k gap (60-128 experts from random routers), so
# the last token can take another expert in one path and the logits then
# move by more than LM_TOL: each such flip must lie within twice the two
# paths' router-logit difference for that token (only a near-tie can flip),
# and the bf16 logits are held to LM_TOL only when nothing flipped.  The
# gate proper runs again in float32 (the weights upcast exactly), held to
# LM_F32_TOL: Qwen1.5-MoE whole (61 GB), Qwen3-MoE on its first 4 layers
# (its 8 hold 85 GB in float32, more than the card).
QWEN3_MOE_F32_LAYERS = 4
# Phase 6h: Jamba's expert layer alone, against each token's own top-k
# experts summed in float32, one expert at a time, on tokens drawn from the
# seed.  The layer rounds to bf16 four times on the way (up, gate, the
# SwiGLU product, each expert's output) and once more at the combine, with
# the gates themselves rounded to bf16 (as the reference rounds them):
# the bf16 bound of the LM checks.
MOE_CHECK_TOKENS = 64
MOE_TOL = 5e-2
# The device of phases 6i-6j and 12a-12d (a name, so the phases can be
# rehearsed on the CPU at SMOKE size before a chip run).
CARD = "cuda"
# Phases 6i-6j: the embedding-input configs.  Qwen2-VL-72B at full width cut
# in depth to fit the card (32 x 0.874 B parameters + the 1.25 B-row head,
# 58.7 GB in bf16; 80 layers hold 143 GB), its float32 gate on its first 4
# layers.  The gate: prefill(960) + 64 decode steps on the known inputs
# against prefill(1024), both lengths multiples of 64 (an odd length runs the
# chunked attention one query at a time).  The position tables on the card
# against the CPU's: each frequency is a float32 exp or pow that the two
# devices may round one ulp apart, which moves the angle of position p by up
# to p * 2^-23 of the frequency (at most 1), and sin/cos by as much: the
# bound is the largest position times 2^-22 (two ulps).
QWEN2_VL_LAYERS = 32
QWEN2_VL_F32_LAYERS = 4
EMBEDS_GATE = (960, 1024)
TABLE_ULPS = 2 ** -22
# Phases 12a-12d: training.  The scans' gradients (kernel forward, plain
# PyTorch backward) against autograd through the plain versions, and a
# model's kernel train path against its plain one in float32, every
# gradient leaf: within 1e-3 of its largest value (the reference's float32
# tests hold its custom VJPs to 1e-4 at small sizes); the loss within 1e-4.
# RWKV-6 3B and Qwen3-0.6B train whole, 4 steps of 4 x 1024 tokens; the
# RWKV kernel-vs-plain gate on its first 4 layers in float32; Jamba's SMOKE
# config through kernel 6 at 4 x 256 tokens.
GRAD_TOL = 1e-3
TRAIN_LOSS_TOL = 1e-4
TRAIN_STEPS = 4
RWKV_GATE_LAYERS = 4
JAMBA_SMOKE_SEQ = 256
# Phases 13a-13b: the mesh paths on ranks sharing the card over gloo.
EP_RANKS = 4
EP_TIMEOUT_S = 600
SHARDED_QWEN_LAYERS = 4
SHARDED_RWKV_LAYERS = 2
SHARDED_SEQ = 1024
SHARDED_PARAM_TOL = 1e-2
# 13b's gradients: the norm within 1e-4 relative (the CPU tests' bound); each
# leaf's largest |difference| within 1e-3 of its largest |gradient|, which a
# halved (0.5), zeroed or doubled (1) or sign-flipped (2) leaf fails
SHARDED_GRAD_NORM_TOL = 1e-4
SHARDED_GRAD_TOL = 1e-3
SHARDED_TIMEOUT_S = 600
# Phase 14: the dry run's accounting on the card.  The real train steps of
# 12b/12c (4 x 1024 tokens) under launch/hlo_analysis.py's accounting beside
# trace_cell's fake trace of the same step on one device (dot FLOPs and
# counts equal, the predicted peak within 10% of the measured one), and two
# production cells on the fake 16 x 16 mesh.  The traces are host work and
# run in child processes beside the real steps.
DRYRUN_MEM_TOL = 0.10
DRYRUN_CELLS = (("qwen3_0_6b", "train_4k", {}), ("rwkv6_3b", "prefill_32k",
                                                 {"rwkv_kernel": True}))
DRYRUN_TIMEOUT_S = 600
# RWKV6-3B's and Jamba's prefills (phases 6, 6b; PERF.md 5) before kernels
# 7 and 6 became torch.library custom ops
PLAIN_CALL_PREFILL_MS = {"rwkv6_3b": 116.93, "jamba group": 141.55}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def launch_counts() -> dict:
    """``ops.launch_counts()`` by kernel, without the count of kernel 1's
    float64 cluster form (a share of kernel 1's launches, which phase 4
    checks on its own: every request there takes it)."""
    counts = ops.launch_counts()
    del counts[ops.CLUSTER_LAUNCHES]
    return counts


def cluster_launches() -> int:
    return ops.launch_counts()[ops.CLUSTER_LAUNCHES]


def time_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def cm_mask(plan, erased) -> np.ndarray:
    mask = np.ones(plan.K)
    mask[erased] = 0
    return mask


def rel_err(out: torch.Tensor, exp: torch.Tensor) -> tuple:
    err = float((out - exp).abs().max())
    return err, err / (float(exp.abs().max()) + 1e-30)


def device_phase() -> dict:
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  device {name}  "
          f"count {torch.cuda.device_count()}")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    print(f"clocks.max.sm {clock} MHz")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 / f16 library calls reduce in float32, as the kernels do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    return {"name": name, "smi": smi.splitlines()[0], "sm_clock_hz": float(clock) * 1e6}


def build_phase() -> None:
    phase("2 build")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # the FP64 products must run on the tensor cores: DMMA in the machine
    # code of every float64 kernel the two entry points launch
    for name, entry in (("coded_fused", "repro_fused_worker_f64"),
                        ("block_matmul", "repro_matmul_t_f64")):
        counts = {}
        for section in _build.sass(name).split("Function : ")[1:]:
            kernel = kernel_name(section.split("\n", 1)[0])
            if "<double" in kernel or "fused_worker_cluster_kernel" in kernel:
                counts[kernel] = section.count("DMMA")
        print(f"{entry}: DMMA instructions per float64 kernel {counts}")
        # two copy widths; kernel 1 also with a head of block offsets of
        # compile-time (64) or run-time (0) size, and its cluster form
        want = 5 if name == "coded_fused" else 2
        check(len(counts) == want and all(counts.values()),
              f"{entry}: a float64 kernel without DMMA instructions: {counts}")
    for name in ("wkv_scan", "mamba_scan"):
        print(f"{name}: {ptxas_summary(logs[name]) or 'built before this run'}")
    # the bf16 / f16 instances of kernels 1, 4 and 5
    for name in ("coded_fused", "coded_encode", "block_matmul"):
        half = [k for k in ptxas_summary(logs[name]).split("; ")
                if "<bf16" in k or "<half" in k]
        print(f"{name} bf16/f16 instances: {'; '.join(half) or 'built before this run'}")
    # their TMA form must load through the Tensor Memory Accelerator (UTMALDG)
    # and multiply on Hopper's warpgroup MMA (HGMMA): every 16-bit instance
    # (four output types; kernel 1 also in its grouped plan)
    for name, instances in (("coded_fused", 8), ("block_matmul", 4)):
        counts = {}
        for section in _build.sass(name).split("Function : ")[1:]:
            kernel = kernel_name(section.split("\n", 1)[0])
            if "_tma_kernel<" in kernel:
                counts[kernel] = (section.count("HGMMA"), section.count("UTMALDG"))
        print(f"{name}: (HGMMA, UTMALDG) instructions per bf16/f16 TMA kernel {counts}")
        check(len(counts) == instances and all(h and u for h, u in counts.values()),
              f"{name}: a bf16/f16 TMA kernel without HGMMA or UTMALDG: {counts}")
    # kernel 4's 16-byte form must load and store 16 bytes an instruction
    # (LDG.E.128 and STG.E.128, any cache suffix), without spills: every
    # bf16/f16 instance (P = 1-8 resident, any P in groups)
    wide = {}
    for section in _build.sass("coded_encode").split("Function : ")[1:]:
        kernel = kernel_name(section.split("\n", 1)[0])
        if kernel.startswith("encode_vector_kernel<"):
            wide[kernel] = tuple(len(re.findall(rf"\b{op}\.E(?:\.[A-Z]+)*\.128\b", section))
                                 for op in ("LDG", "STG"))
    print(f"coded_encode: (LDG.E.128, STG.E.128) instructions per 16-byte-form kernel {wide}")
    check(len(wide) == 18 and all(ld and st for ld, st in wide.values()),
          f"coded_encode: a 16-byte-form kernel without 16-byte loads or stores: {wide}")
    regs = [k for k in ptxas_summary(logs["coded_encode"]).split("; ")
            if k.startswith("encode_vector_kernel<")]
    print(f"coded_encode 16-byte form: {'; '.join(regs) or 'built before this run'}")
    check(all(k.endswith(" 0/0 bytes spill stores/loads") for k in regs),
          f"coded_encode: a 16-byte-form kernel spills: {regs}")
    # the selective scan's exponentials must be one MUFU op each
    ex2 = {kernel_name(section.split("\n", 1)[0]): section.count("MUFU.EX2")
           for section in _build.sass("mamba_scan").split("Function : ")[1:]}
    print(f"mamba_scan: MUFU.EX2 instructions per kernel {ex2}")
    check(len(ex2) == len(mamba_scan.S_INSTANCES) and all(ex2.values()),
          f"mamba_scan: a kernel without MUFU.EX2: {ex2}")
    # kernel 3's bulk-copy form must copy through the bulk-copy engine
    print(f"coded_decode: {ptxas_summary(logs['coded_decode']) or 'built before this run'}")
    blk = {kernel_name(head): section.count("UBLKCP")
           for section in _build.sass("coded_decode").split("Function : ")[1:]
           if "decode_partial" in (head := section.split("\n", 1)[0])}
    print(f"coded_decode: UBLKCP (bulk copy) instructions per kernel 3 instance {blk}")
    f64_bulk = [n for k, n in blk.items() if k.startswith("decode_partial_kernel<double, bulk")]
    check(len(f64_bulk) == 2 and all(f64_bulk),
          f"coded_decode: a float64 bulk instance without UBLKCP: {blk}")


_TYPES = {"d": "double", "f": "float", "6__half": "half", "13__nv_bfloat16": "bf16"}


def kernel_name(mangled: str) -> str:
    """The "name<template args>" of a mangled kernel template instance:
    element types (double, float, half, bf16), bools (kernel 3's copy form)
    and ints, read from the start of the template arguments."""
    m = re.search(r"\d+([a-z_]+_kernel)I(\S+)", mangled)
    if not m:
        return mangled.strip()
    args, rest = [], m.group(2)
    token = re.compile(r"d|f|6__half|13__nv_bfloat16|S\d*_|Lb([01])E|Li(\d+)E")
    while (t := token.match(rest)):
        if t.group(1) is not None:
            args.append("bulk" if t.group(1) == "1" else "element")
        elif t.group(2) is not None:
            args.append(t.group(2))
        else:   # a type, or a substitution naming the type before it
            args.append(_TYPES.get(t.group(0), args[-1] if args else "?"))
        rest = rest[t.end():]
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas_summary(log: str) -> str:
    """``-Xptxas -v``'s registers and spills per kernel instance, as
    "kernel<template ints>: N registers, S/L bytes spill stores/loads"."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)} bytes spill stores/loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return "; ".join(out)


def fused_inputs(plan, A, B, dtype):
    g = plan.scheme.grid
    ca = torch.as_tensor(plan.coeff_a.reshape(plan.K, -1), dtype=dtype, device="cuda")
    cb = torch.as_tensor(plan.coeff_b.reshape(plan.K, -1), dtype=dtype, device="cuda")
    return (ca, cb, block_decompose(A.to(dtype), g.p, g.m),
            block_decompose(B.to(dtype), g.p, g.n))


def check_close(name: str, out: torch.Tensor, exp: torch.Tensor, dtype) -> float:
    err, rel = rel_err(out, exp)
    print(f"{name} {dtype} {tuple(out.shape)}: max abs err {err:.3e}, rel {rel:.3e}")
    check(out.shape == exp.shape and rel < TOL[dtype], f"{name} {dtype} rel err {rel}")
    return err


def check_exact(name: str, out: torch.Tensor, exp: torch.Tensor) -> float:
    err = float((out - exp).abs().max()) if out.numel() else 0.0
    print(f"{name} {tuple(out.shape)}: max abs err {err}")
    check(torch.equal(out, exp), f"{name} differs by {err}")
    return err


def with_row_stride(x: torch.Tensor, stride: str) -> torch.Tensor:
    """x's values in a view whose row stride is a 16-byte multiple
    ("aligned") or an odd number of elements ("odd")."""
    width = x.shape[-1]
    step = 16 // x.element_size()
    ld = -(-width // step) * step if stride == "aligned" else width | 1
    buf = torch.zeros((*x.shape[:-1], ld), dtype=x.dtype, device=x.device)
    buf[..., :width] = x
    return buf[..., :width]


def copy_width(*operands: torch.Tensor) -> int:
    """The copy width the wrappers of kernels 1 and 5 pick for these
    (block-stacked) operands."""
    return coded_fused.copy_bytes(operands[0].element_size(), *(
        (x.data_ptr(), coded_fused._block_offsets(x)[0] if x.ndim > 2 else (0,),
         x.stride(-2)) for x in operands))


def encode_form(blocks: torch.Tensor) -> int:
    """The form the wrapper of kernel 4 picks for ``blocks`` (*grid, rows,
    cols): 16 (16-byte loads and stores) or one element."""
    offsets, row_stride = coded_fused._block_offsets(blocks)
    return coded_fused.encode_width(blocks.element_size(), blocks.shape[-1],
                                    (blocks.data_ptr(), offsets, row_stride))


def edge_cases(gen, dtype) -> None:
    """Kernels 1 and 5 at the new design's edges: K=1 (the mesh caller's
    single coefficient row) on ragged 129 x 257 blocks, and a row stride
    that is 16-byte aligned beside an odd one, so both copy widths run;
    integer inputs exactly, random inputs to TOL."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def ints(*shape):       # every sum an integer below 2^24: exact in float32
        return torch.randint(-9, 10, shape, generator=gen, device="cuda").to(dtype)

    for stride in ("aligned", "odd"):
        for data, make in (("random", rand), ("integer", ints)):
            ca, cb = make(1, 4), make(1, 4)
            a = with_row_stride(make(4, 129, 257), stride)
            b = with_row_stride(make(4, 129, 65), stride)
            label = f"fused_worker K=1 {stride} rows ({copy_width(a, b)}-byte copies) {data}"
            out, exp = ops.fused_worker(ca, cb, a, b), ref.fused_worker_ref(ca, cb, a, b)
            if data == "integer":
                check_exact(f"{label} {dtype}", out, exp)
            else:
                check_close(label, out, exp, dtype)
            a = with_row_stride(make(300, 257), stride)
            b = with_row_stride(make(300, 65), stride)
            label = f"matmul_t {stride} rows ({copy_width(a, b)}-byte copies) {data}"
            out, exp = ops.matmul_t(a, b), ref.matmul_t_ref(a, b)
            if data == "integer":
                check_exact(f"{label} {dtype}", out, exp)
            else:
                check_close(label, out, exp, dtype)


def kernels_phase(plan, A, B, gen) -> dict:
    """Each kernel against its plain version; returns the main-shape errors."""
    phase("3 kernels against their plain versions")
    errs = {}
    K = plan.K
    for dtype in (torch.float64, torch.float32):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

        def ints(*shape):
            return torch.randint(-9, 10, shape, generator=gen, device="cuda").to(dtype)

        # ragged small shapes: every dimension off the 64-wide tiles and the
        # 256-wide thread blocks; random inputs at a relative tolerance (the
        # sums run in another order), integer inputs exactly
        x = dict(ca=rand(3, 5), cb=rand(3, 3), a=rand(5, 129, 257), b=rand(3, 129, 65))
        check_close("fused_worker ragged", ops.fused_worker(x["ca"], x["cb"], x["a"], x["b"]),
                    ref.fused_worker_ref(x["ca"], x["cb"], x["a"], x["b"]), dtype)
        c, blocks = rand(7, 5), rand(5, 37, 1031)
        check_close("encode ragged", ops.encode(c, blocks),
                    ref.encode_ref(c, blocks.reshape(5, -1)).reshape(7, 37, 1031), dtype)
        c, blocks = ints(7, 5), ints(5, 37, 1031)
        check_exact(f"encode {dtype} ragged integer", ops.encode(c, blocks),
                    ref.encode_ref(c, blocks.reshape(5, -1)).reshape(7, 37, 1031))
        a, b = rand(300, 257), rand(300, 65)
        check_close("matmul_t ragged", ops.matmul_t(a, b), ref.matmul_t_ref(a, b), dtype)
        a, b = ints(300, 257), ints(300, 65)
        check_exact(f"matmul_t {dtype} ragged integer", ops.matmul_t(a, b),
                    ref.matmul_t_ref(a, b))
        edge_cases(gen, dtype)
        # main-path shapes: the plan's coefficients on strided 4000^2 block
        # views (fused, encode), one worker's coded blocks (matmul_t)
        args = fused_inputs(plan, A, B, dtype)
        ca, cb, a4, b4 = args
        print(f"main-path block views: {copy_width(a4, b4)}-byte copies")
        # integer coefficients in {0, 1} keep every sum of the integer
        # blocks below 2^24, so both dtypes must match exactly
        ci = torch.randint(0, 2, ca.shape, generator=gen, device="cuda").to(dtype)
        check_exact(f"fused_worker {dtype} main integer", ops.fused_worker(ci, ci, a4, b4),
                    ref.fused_worker_ref(ci, ci, a4, b4))
        check_exact(f"matmul_t {dtype} main integer (strided 4000^2 blocks)",
                    ops.matmul_t(a4[0, 0], b4[0, 0]), ref.matmul_t_ref(a4[0, 0], b4[0, 0]))
        out = ops.fused_worker(*args)
        err = check_close("fused_worker main", out, ref.fused_worker_ref(*args), dtype)
        if dtype == torch.float64:
            errs["fused_worker"] = err
            Y = out
        del out
        at = ops.encode(ca, a4)
        err = check_close("encode main", at,
                          ref.encode_ref(ca, a4.reshape(ca.shape[1], -1)).reshape(at.shape),
                          dtype)
        errs.setdefault("encode", err)
        bt = ops.encode(cb, b4)
        err = check_close("matmul_t main", ops.matmul_t(at[K - 1], bt[K - 1]),
                          ref.matmul_t_ref(at[K - 1], bt[K - 1]), dtype)
        errs.setdefault("matmul_t", err)
        del args, ca, cb, a4, b4, at, bt
    # decode: Y from the integer main-path products, six workers erased
    mask = cm_mask(plan, ERASURES[0])
    W = torch.as_tensor(plan.make_panel_cache().get(mask).W, device="cuda")
    Yf = (Y * torch.as_tensor(mask, device="cuda")[:, None, None]).reshape(K, -1)
    for extract in (True, False):
        err = check_exact(f"decode float64 extract={extract} {tuple(W.shape)} x",
                          ops.decode(W, Yf, plan.s, extract=extract),
                          ref.decode_ref(W, Yf, plan.s, extract))
        errs["decode"] = max(err, errs.get("decode", 0.0))
    del Yf
    # decode_partial: the same products erased chunk by chunk under a real
    # progress pattern, as the runtime holds them (Y (K, E), chunks of rows:
    # aligned bounds, the bulk-copy form); then erased by column chunks whose
    # bounds are odd (the one-element form)
    pat = PartialPattern.from_progress(K, Q_SUB, np.asarray(PROGRESS[1]) / Q_SUB)
    cmask = torch.as_tensor(pat.chunk_masks, device="cuda")
    W_stack = torch.as_tensor(plan.make_panel_cache().get_partial(pat.chunk_masks),
                              device="cuda")
    rows = chunk_bounds(Y.shape[1], Q_SUB)
    aligned = [b * Y.shape[2] for b in rows]
    odd = [0, *(b + 2 * q + 1 for q, b in enumerate(aligned[1:-1])), aligned[-1]]
    Y = Y.reshape(K, -1)
    for label, cols in (("aligned", aligned), ("odd", odd)):
        Yc = Y.clone()
        for q in range(Q_SUB):
            Yc[:, cols[q]:cols[q + 1]].mul_(cmask[q][:, None])
        widths = [b1 - b0 for b0, b1 in zip(cols, cols[1:])]
        form = ("bulk-copy" if coded_decode.bulk_copies(8, (Yc.data_ptr(),), cols[:-1],
                                                        (Yc.shape[1],), widths)
                else "one-element")
        check(form == ("bulk-copy" if label == "aligned" else "one-element"),
              f"decode_partial {label} bounds take the {form} form")
        for extract in (True, False):
            err = check_exact(f"decode_partial float64 {label} bounds {cols} ({form} form) "
                              f"extract={extract} Q={Q_SUB} {tuple(W_stack.shape)} x",
                              ops.decode_partial(W_stack, Yc, plan.s, extract=extract,
                                                 bounds=cols),
                              ref.decode_partial_ref(W_stack, Yc, plan.s, extract, cols))
            errs["decode_partial"] = max(err, errs.get("decode_partial", 0.0))
        del Yc
    return errs


def half_shapes() -> tuple:
    """(label, K, P, Q, v, r, t): a ragged small shape and the main path's
    (K=10 workers, P=Q=4 blocks of 4000 x 4000)."""
    g = MAIN
    return (("ragged", 3, 5, 3, 129, 257, 65),
            ("main", g.K, g.p * g.m, g.p * g.n, V // g.p, R // g.m, T // g.n))


def half_check(label: str, out: torch.Tensor, exp: torch.Tensor, data: str) -> float:
    """A bf16/f16 kernel against its plain version on the same inputs:
    integer inputs exactly (bits; an overflow to inf in f16 must be the
    same inf), random ones within HALF_TOL of the largest value.  Returns
    the max abs error (0 where both are the same inf)."""
    torch.cuda.synchronize()
    check(out.shape == exp.shape and out.dtype == exp.dtype,
          f"{label}: {out.dtype} {tuple(out.shape)} against {exp.dtype} {tuple(exp.shape)}")
    diff = torch.where(out == exp, 0.0, (out.float() - exp.float()).abs())
    err = float(diff.max()) if out.numel() else 0.0
    rel = err / (float(exp.float().abs().max()) + 1e-30) if out.numel() else 0.0
    print(f"{label}: max abs err {err:.3e}, rel {rel:.3e}")
    if data == "integer":
        check(torch.equal(out, exp), f"{label} differs by {err}")
    else:
        check(rel < HALF_TOL, f"{label} rel err {rel}")
    return err


def half_kernels_phase(gen) -> dict:
    """3h: the bf16 and f16 instances of kernels 1, 4 and 5 against their
    plain versions at a ragged shape and at the main path's, with a row
    stride that is 16-byte aligned (16-byte copies) and one that is not
    (plain 2-byte loads), integer inputs in [-4, 4] exactly (kernels 1 and
    5 also with float32 output) and random normal ones to HALF_TOL.
    Returns the main shape's max abs error (random inputs) per entry."""
    phase("3h bf16/f16 kernels 1, 4 and 5 against their plain versions")
    errs = {}
    for dtype in HALF:
        tag = HALF_NAME[dtype]

        def make(data, *shape):
            if data == "integer":
                return torch.randint(-4, 5, shape, generator=gen, device="cuda").to(dtype)
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        for label, K, P, Q, v, r, t in half_shapes():
            for stride in ("aligned", "odd"):
                for data in ("random", "integer"):
                    ca, cb = make(data, K, P), make(data, K, Q)
                    a = with_row_stride(make(data, P, v, r), stride)
                    b = with_row_stride(make(data, Q, v, t), stride)
                    width = copy_width(a, b)
                    check(width == (16 if stride == "aligned" else 2),
                          f"{tag} {stride} rows take {width}-byte copies")
                    form = encode_form(a)
                    check(form == (16 if stride == "aligned" and r % 8 == 0 else 2),
                          f"{tag} {stride} rows of width {r}: kernel 4 takes the {form}-byte form")
                    name = f"{tag} {label} ({K}, {P}, {Q}, {v}, {r}, {t}) {stride} rows " \
                           f"({width}-byte copies) {data}"
                    found = {
                        "fused_worker": half_check(
                            f"fused_worker {name}", ops.fused_worker(ca, cb, a, b),
                            ref.fused_worker_ref(ca, cb, a, b), data),
                        "encode": half_check(
                            f"encode ({form}-byte form) {name}", ops.encode(ca, a),
                            ref.encode_ref(ca, a.reshape(P, -1)).reshape(K, v, r), data),
                        "matmul_t": half_check(
                            f"matmul_t {name}", ops.matmul_t(a[0], b[0]),
                            ref.matmul_t_ref(a[0], b[0]), data)}
                    if data == "integer":   # the float32 sums themselves
                        f32 = torch.float32
                        half_check(f"fused_worker {name} out float32",
                                   ops.fused_worker(ca, cb, a, b, out_dtype=f32),
                                   ref.fused_worker_ref(ca, cb, a, b, f32), data)
                        half_check(f"matmul_t {name} out float32",
                                   ops.matmul_t(a[0], b[0], out_dtype=f32),
                                   ref.matmul_t_ref(a[0], b[0], f32), data)
                    elif label == "main":
                        for kernel, err in found.items():
                            key = f"{kernel}_{tag}"
                            errs[key] = max(err, errs.get(key, 0.0))
                    del ca, cb, a, b
        # kernel 4 on ragged rows of a width that is a multiple of 8 (the
        # 16-byte form where the row stride is aligned), past a group of 8
        # raw loads (P = 20) and past groups of 4 workers (K = 17)
        for K, P, v, r in ((10, 4, 129, 264), (17, 20, 37, 520)):
            for stride in ("aligned", "odd"):
                for data in ("random", "integer"):
                    c = make(data, K, P)
                    a = with_row_stride(make(data, P, v, r), stride)
                    form = encode_form(a)
                    check(form == (16 if stride == "aligned" else 2),
                          f"{tag} {stride} rows of width {r}: kernel 4 takes the {form}-byte form")
                    half_check(f"encode ({form}-byte form) {tag} ({K}, {P}, {v}, {r}) {stride} "
                               f"rows {data}", ops.encode(c, a),
                               ref.encode_ref(c, a.reshape(P, -1)).reshape(K, v, r), data)
                    del c, a
    torch.cuda.empty_cache()
    return errs


def half_operands(plan, dtype, seed: int) -> tuple:
    """The half-precision worker stage's operands at the plan's geometry:
    coefficient tables (K, P), (K, Q) and A, B (8000 x 8000) standard normal
    from the seed in ``dtype``, A and B as strided block views.  (The plan's
    own coefficients carry powers of the digit base s = 2^22, beyond f16's
    range: exact coded products are float64 work.)"""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = plan.scheme.grid
    ca = torch.randn((plan.K, g.p * g.m), generator=gen, device="cuda").to(dtype)
    cb = torch.randn((plan.K, g.p * g.n), generator=gen, device="cuda").to(dtype)
    A = torch.randn((V, R), generator=gen, device="cuda").to(dtype)
    B = torch.randn((V, T), generator=gen, device="cuda").to(dtype)
    return ca, cb, block_decompose(A, g.p, g.m), block_decompose(B, g.p, g.n)


def half_path_phase(plan, seed: int) -> dict:
    """4h: the worker stage at the paper's geometry in bf16 and f16 through
    the public ``ops`` entry points, fused (kernel 1) and staged (kernel 4
    twice, kernel 5 once per worker), counts set to 0 just before each
    dtype's run and read just after it."""
    phase("4h bf16/f16 worker stage through ops (fused and staged)")
    K = plan.K
    out = {}
    for dtype in HALF:
        tag = HALF_NAME[dtype]
        ca, cb, a4, b4 = half_operands(plan, dtype, seed)
        forms = [encode_form(x) for x in (a4, b4)]
        check(forms == [16, 16], f"4h {tag}: kernel 4 takes the {forms}-byte forms, not 16")
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Y = ops.fused_worker(ca, cb, a4, b4)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        at, bt = ops.encode(ca, a4), ops.encode(cb, b4)
        Ys = torch.stack([ops.matmul_t(at[k], bt[k]) for k in range(K)])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = launch_counts()
        want = dict.fromkeys(counts, 0) | {"fused_worker": 1, "encode": 2, "matmul_t": K}
        check(counts == want, f"4h {tag} launched {counts}, not {want}")
        exp = ref.fused_worker_ref(ca, cb, a4, b4)
        finite = bool(torch.isfinite(Y).all()) and bool(torch.isfinite(Ys).all())
        _, rel_f = rel_err(Y.float(), exp.float())
        _, rel_s = rel_err(Ys.float(), exp.float())
        same = same_bits(Y, Ys)
        print(f"4h {tag} worker stage (K={K}, {tuple(a4.shape)} blocks, "
              f"{copy_width(a4, b4)}-byte copies, kernel 4 in its {forms[0]}-byte form): "
              f"fused {(t1 - t0) * 1e3:.2f} ms wall, "
              f"staged {(t2 - t1) * 1e3:.2f} ms wall; Y {tuple(Y.shape)} {Y.dtype}, finite "
              f"{finite}; rel err against the plain version: fused {rel_f:.3e}, staged "
              f"{rel_s:.3e} (bound {HALF_TOL}); fused and staged bit-identical {same}; "
              f"launches {nonzero(counts)}")
        check(finite and Y.shape == (K, R // plan.scheme.grid.m, T // plan.scheme.grid.n),
              f"4h {tag}: Y {tuple(Y.shape)} not finite")
        check(rel_f < HALF_TOL and rel_s < HALF_TOL,
              f"4h {tag}: worker stage rel err {rel_f}, {rel_s}")
        check(same, f"4h {tag}: the fused Y is not the staged Y bit for bit")
        out[tag] = {"counts": counts}
        del ca, cb, a4, b4, Y, at, bt, Ys, exp
        torch.cuda.empty_cache()
    return out


def half_times_phase(plan, seed: int, smi: str) -> dict:
    """5h: each bf16/f16 kernel, its plain version and one PyTorch call
    computing the same function (cuBLAS's reduced-precision reductions
    off), CUDA-event means at the main path's shapes, beside the least time
    the card could take at its bf16/f16 tensor peak and HBM rate."""
    phase("5h bf16/f16 kernel times")
    K = plan.K
    g = plan.scheme.grid
    out = {}
    for dtype in HALF:
        tag = HALF_NAME[dtype]
        ca, cb, a4, b4 = half_operands(plan, dtype, seed)
        P, Q = ca.shape[1], cb.shape[1]
        v, r, t = a4.shape[-2], a4.shape[-1], b4.shape[-1]
        ca3, cb3 = ca.reshape(K, g.p, g.m), cb.reshape(K, g.p, g.n)

        def bound(flops, nbytes):
            t_ops, t_bytes = flops / PEAK_BF16_TENSOR, nbytes / PEAK_HBM
            return {"bound_ms": max(t_ops, t_bytes) * 1e3,
                    "bound_by": "operations" if t_ops > t_bytes else "bytes"}

        def library_fused():
            at = torch.einsum("kpm,pmvr->kvr", ca3, a4)
            bt = torch.einsum("kpn,pnvt->kvt", cb3, b4)
            return torch.bmm(at.transpose(1, 2), bt)

        fused = dict(ms=time_ms(lambda: ops.fused_worker(ca, cb, a4, b4), 3),
                     plain_ms=time_ms(lambda: ref.fused_worker_ref(ca, cb, a4, b4), 3),
                     library_ms=time_ms(library_fused, 3))
        flops = 2 * K * r * t * v + 2 * K * (P * v * r + Q * v * t)
        fused |= bound(flops, 2 * (P * v * r + Q * v * t + K * r * t + K * (P + Q)))
        stack = a4.reshape(P, -1)
        E = v * r
        enc = dict(ms=time_ms(lambda: ops.encode(ca, a4), 20),
                   plain_ms=time_ms(lambda: ref.encode_ref(ca, stack), 20),
                   library_ms=time_ms(lambda: torch.matmul(ca, stack), 20))
        enc_bytes = 2 * (P * E + K * E + K * P)
        enc |= bound(2 * K * P * E, enc_bytes)
        # a yardstick, not used by the port: one device-to-device copy that
        # moves as many bytes (half read, half written)
        src = torch.empty(enc_bytes // 2, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        copy_ms = time_ms(lambda: dst.copy_(src), 20)
        del src, dst
        print(f"encode_{tag} ({encode_form(a4)}-byte form): {enc_bytes:.4g} B in "
              f"{enc['ms']:.4f} ms = {enc_bytes / enc['ms'] / 1e6:.1f} GB/s, "
              f"{enc['bound_ms'] / enc['ms']:.1%} of its {enc['bound_ms']:.4f} ms bound at "
              f"{PEAK_HBM / 1e9:.0f} GB/s; a torch copy of as many bytes {copy_ms:.4f} ms = "
              f"{enc_bytes / copy_ms / 1e6:.1f} GB/s (the practical ceiling measured here); "
              f"on {smi}")
        del stack
        at, bt = ops.encode(ca, a4), ops.encode(cb, b4)
        a1, b1 = at[0], bt[0]
        mm = dict(ms=time_ms(lambda: ops.matmul_t(a1, b1), 5),
                  plain_ms=time_ms(lambda: ref.matmul_t_ref(a1, b1), 5),
                  library_ms=time_ms(lambda: a1.T @ b1, 5))
        mm |= bound(2 * v * r * t, 2 * (v * r + v * t + r * t))
        for kernel, row, flop in (("fused_worker", fused, flops), ("encode", enc, 2 * K * P * E),
                                  ("matmul_t", mm, 2 * v * r * t)):
            rate = flop / (row["ms"] * 1e-3)
            print(f"{kernel}_{tag}: kernel {row['ms']:.4f} ms ({rate / 1e12:.2f} TFLOP/s, "
                  f"{rate / PEAK_BF16_TENSOR:.1%} of the {tag} tensor peak, "
                  f"{rate / PEAK_FP32:.1%} of the FP32 CUDA-core peak), bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {row['bound_ms'] / row['ms']:.1%} "
                  f"of it), plain {row['plain_ms']:.3f} ms, library {row['library_ms']:.4f} ms; "
                  f"on {smi}")
            out[f"{kernel}_{tag}"] = row
        del ca, cb, a4, b4, at, bt, a1, b1
        torch.cuda.empty_cache()
    return out


def wkv_inputs(gen, B, S, H, dk, dv=None):
    """Random f32 WKV inputs made as tests/test_kernels.py makes them:
    w = exp(-exp(N(0, 1))) in (0, 1), k, v, r, u standard normal."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)
    return (torch.exp(-torch.exp(rand(B, S, H, dk))), rand(B, S, H, dk),
            rand(B, S, H, dv or dk), rand(B, S, H, dk), rand(H, dk))


def mamba_inputs(gen, B, S, d, s, jamba_init=False):
    """Random f32 selective-scan inputs made as tests/test_kernels.py makes
    them: dt = softplus(N(0, 1)), A_log uniform in [0.1, 1).  With
    ``jamba_init``, the long-memory regime of the Jamba initialisation
    (models/mamba.py: dt_bias -4.6, A_log = log(1..s), D = 1): dt =
    softplus(N(0, 0.25) - 4.6), near 0.01, so the decays are 0.84-0.99."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)
    if jamba_init:
        A_log = torch.log(torch.arange(1, s + 1, dtype=torch.float32, device=gen.device))
        return (torch.nn.functional.softplus(0.5 * rand(B, S, d) - 4.6), rand(B, S, d),
                rand(B, S, s), rand(B, S, s), A_log.expand(d, s).contiguous(),
                torch.ones(d, device=gen.device))
    return (torch.nn.functional.softplus(rand(B, S, d)), rand(B, S, d),
            rand(B, S, s), rand(B, S, s),
            torch.rand((d, s), generator=gen, device=gen.device) * 0.9 + 0.1, rand(d))


def check_scan(name: str, out, exp) -> float:
    """All three outputs within SCAN_TOL of the plain version; returns the
    largest abs error."""
    worst = 0.0
    for label, o, e in zip(("y", "state_fin", "state_bounds"), out, exp):
        err, rel = rel_err(o, e)
        print(f"{name} {label} {tuple(o.shape)}: max abs err {err:.3e}, rel {rel:.3e}")
        check(o.shape == e.shape and rel <= SCAN_TOL, f"{name} {label} rel err {rel}")
        worst = max(worst, err)
    return worst


def caps_phase(gen, smi: str) -> dict:
    """Phase 3c: each shape just past a cap the kernels once had,
    against its plain version on the same inputs: the decode bit for bit
    (integer panels and products, so every sum is exact in any order),
    the float kernels within phase 3/3b's tolerances.  Returns the launches
    (the counts are set to 0 first)."""
    phase("3c shapes past the old caps against their plain versions")
    print(f"on {smi}")
    ops.reset_launch_counts()

    def ints(shape, lo, hi, dtype=torch.float64):
        return torch.randint(lo, hi + 1, shape, generator=gen, device="cuda").to(dtype)

    # kernels 2 and 3: the polycode K=100 plan's panel, (64, 100) float64 =
    # 51,200 bytes (past the old 48 KB), and a (300, 100) panel (240,000
    # bytes) past the card's per-block shared memory: decoded in row slabs
    poly = make_plan("polycode", 1, 8, 8, K=100, L=16)
    mn, K = poly.scheme.grid.m * poly.scheme.grid.n, poly.K
    E = 3 * 4096 + 5
    for rows in (mn, 300):
        W, Y = ints((rows, K), -4, 4), ints((K, E), -1000, 1000)
        for extract in (True, False):
            check_exact(f"decode panel ({rows}, {K}) {W.numel() * 8} bytes extract={extract}",
                        ops.decode(W, Y, poly.s, extract=extract),
                        ref.decode_ref(W, Y, poly.s, extract))
        W_stack = ints((4, rows, K), -4, 4)
        for bounds in ([0, 4096, 8192, 10000, E], [0, 4095, 8191, 10001, E]):
            check_exact(f"decode_partial panel ({rows}, {K}) Q=4 bounds {bounds}",
                        ops.decode_partial(W_stack, Y, poly.s, bounds=bounds),
                        ref.decode_partial_ref(W_stack, Y, poly.s, True, bounds))
    # kernel 3: sub_tasks = 200 chunks (past the old 128), aligned and odd
    W_stack = ints((200, 4, 10), -4, 4)
    Y = ints((10, 200 * 512 + 7), -1000, 1000)
    E = Y.shape[1]
    for label, bounds in (("aligned", [0, *range(512, 200 * 512, 512), E]),
                          ("odd", [0, *range(511, 199 * 512, 512), E])):
        check_exact(f"decode_partial Q=200 {label} bounds",
                    ops.decode_partial(W_stack, Y, 2.0 ** 20, bounds=bounds),
                    ref.decode_partial_ref(W_stack, Y, 2.0 ** 20, True, bounds))
    Ys = ints((200, 10, 640), -1000, 1000)
    check_exact("decode_partial Q=200 stacked", ops.decode_partial(W_stack, Ys, 2.0 ** 20),
                ref.decode_partial_ref(W_stack, Ys, 2.0 ** 20, True))
    # kernels 1 and 4: P = Q = 80 blocks a side (past the old 64), float64
    # and bf16; kernel 4 also with a float64 panel past the card's shared
    # memory (K = 400: 256,000 bytes, encoded in slabs of workers)
    for dtype in (torch.float64, torch.bfloat16):
        for data in ("random", "integer"):
            def make(*shape):
                if data == "integer":
                    return ints(shape, -3, 3, dtype)
                return torch.randn(shape, generator=gen, device="cuda").to(dtype)
            ca, cb = make(6, 80), make(6, 80)
            a, b = make(8, 10, 64, 96), make(10, 8, 64, 80)
            out, exp = ops.fused_worker(ca, cb, a, b), ref.fused_worker_ref(ca, cb, a, b)
            name = f"fused_worker P=Q=80 {data}"
            if dtype == torch.bfloat16:
                half_check(f"{name} bf16", out, exp, data)
            elif data == "integer":
                check_exact(f"{name} float64", out, exp)
            else:
                check_close(name, out, exp, dtype)
            for Kc in (7, 400):
                c = make(Kc, 80)
                out = ops.encode(c, a)
                exp = ref.encode_ref(c, a.reshape(80, -1)).reshape(out.shape)
                name = f"encode P=80 K={Kc} ({Kc * 80 * a.element_size()}-byte panel) {data}"
                if dtype == torch.bfloat16:
                    half_check(f"{name} bf16", out, exp, data)
                elif data == "integer":
                    check_exact(f"{name} float64", out, exp)
                else:
                    check_close(name, out, exp, dtype)
    # kernel 7: dk = 128 and 256 (new instances), 96 (padded to 128), 320
    # (rows in groups of 256), dv = 256 (past the old 128)
    for dk, dv in ((128, 64), (64, 256), (128, 256), (96, 80), (320, 64)):
        x = wkv_inputs(gen, B=2, S=200, H=3, dk=dk, dv=dv)
        check_scan(f"wkv_scan dk={dk} dv={dv}", ops.wkv_scan(*x), ref.wkv_scan_ref(*x))
    # kernel 6: s = 64 (a new instance), 24 (padded to 32), 100 (in groups)
    for s_ in (64, 24, 100):
        x = mamba_inputs(gen, B=2, S=300, d=200, s=s_)
        check_scan(f"mamba_scan s={s_}", ops.mamba_scan(*x), ref.mamba_scan_ref(*x))
    counts = launch_counts()
    print(f"3c launches {nonzero(counts)}")
    return {"counts": counts}


def scan_kernels_phase(gen) -> dict:
    """Kernels 6 and 7 against their plain versions at the LM prefill's
    shapes, at ragged shapes (chunk halved, d off the thread block, dv off
    the 32-column groups) and, for kernel 6, at the Jamba initialisation."""
    phase("3b scan kernels against their plain versions")
    errs = {}
    x = wkv_inputs(gen, B=2, S=1000, H=5, dk=64)           # chunk 64 -> 8
    check_scan("wkv_scan ragged S=1000", ops.wkv_scan(*x), ref.wkv_scan_ref(*x))
    x = wkv_inputs(gen, B=2, S=1000, H=5, dk=64, dv=72)    # groups of 32, 32, 8
    check_scan("wkv_scan ragged S=1000 dv=72", ops.wkv_scan(*x), ref.wkv_scan_ref(*x))
    x = wkv_inputs(gen, **WKV_SHAPE)
    errs["wkv_scan"] = check_scan("wkv_scan main", ops.wkv_scan(*x), ref.wkv_scan_ref(*x))
    x = mamba_inputs(gen, B=2, S=1000, d=1000, s=16)       # chunk 128 -> 8
    check_scan("mamba_scan ragged S=1000 d=1000", ops.mamba_scan(*x),
               ref.mamba_scan_ref(*x))
    x = mamba_inputs(gen, **MAMBA_SHAPE)
    errs["mamba_scan"] = check_scan("mamba_scan main", ops.mamba_scan(*x),
                                    ref.mamba_scan_ref(*x))
    x = mamba_inputs(gen, **MAMBA_SHAPE, jamba_init=True)
    errs["mamba_scan"] = max(errs["mamba_scan"], check_scan(
        "mamba_scan main, Jamba init", ops.mamba_scan(*x), ref.mamba_scan_ref(*x)))
    return errs


def scan_times_phase(gen, dev: dict) -> dict:
    phase("5b scan kernel times")
    out = {}
    B, S, H, dk = (WKV_SHAPE[k] for k in ("B", "S", "H", "dk"))
    x = wkv_inputs(gen, **WKV_SHAPE)
    nc = S // ref.scan_chunk(S, 64)
    nbytes = 4 * (4 * B * S * H * dk + H * dk + B * S * H * dk
                  + (1 + nc) * B * H * dk * dk)
    flops = 7 * B * S * H * dk * dk        # per state entry and step: mul, 3 FMA
    out["wkv_scan"] = dict(ms=time_ms(lambda: ops.wkv_scan(*x), 20),
                           plain_ms=time_ms(lambda: ref.wkv_scan_ref(*x), 3),
                           library_ms=None)
    out["wkv_scan"] |= scan_bound(flops, nbytes)
    print(f"wkv_scan (B={B}, S={S}, H={H}, dk=dv={dk}): {flops:.4g} FLOP, {nbytes:.4g} B; "
          f"bound {out['wkv_scan']['bound_ms']:.4f} ms ({out['wkv_scan']['bound_by']}); "
          f"kernel {out['wkv_scan']['ms']:.4f} ms, plain {out['wkv_scan']['plain_ms']:.3f} ms; "
          f"no single PyTorch call computes the scan")
    del x
    B, S, d, s = (MAMBA_SHAPE[k] for k in ("B", "S", "d", "s"))
    x = mamba_inputs(gen, **MAMBA_SHAPE)
    nc = S // ref.scan_chunk(S, 128)
    nbytes = 4 * (2 * B * S * d + 2 * B * S * s + d * s + d + B * S * d
                  + (1 + nc) * B * d * s)
    flops = 7 * B * S * d * s + 3 * B * S * d   # dt*A, FMA x2, mul; dt*x, D*x FMA
    n_exp = B * S * d * s
    out["mamba_scan"] = dict(ms=time_ms(lambda: ops.mamba_scan(*x), 20),
                             plain_ms=time_ms(lambda: ref.mamba_scan_ref(*x), 3),
                             library_ms=None)
    out["mamba_scan"] |= scan_bound(flops, nbytes)
    # The MUFU time of this design (every exponential one MUFU.EX2): a design
    # figure, not a bound, since a kernel may take part of the exponentials
    # to the FMA pipes
    mufu_ms = n_exp / (SMS * MUFU_EX2_PER_CLOCK * dev["sm_clock_hz"]) * 1e3
    print(f"mamba_scan (B={B}, S={S}, d={d}, s={s}): {flops:.4g} FLOP + {n_exp:.4g} exp, "
          f"{nbytes:.4g} B; bound {out['mamba_scan']['bound_ms']:.4f} ms "
          f"({out['mamba_scan']['bound_by']}); the MUFU time of this design ({SMS} SMs x "
          f"{MUFU_EX2_PER_CLOCK} MUFU.EX2 per clock x clocks.max.sm "
          f"{dev['sm_clock_hz'] / 1e6:.0f} MHz) {mufu_ms:.4f} ms; kernel "
          f"{out['mamba_scan']['ms']:.4f} ms, plain {out['mamba_scan']['plain_ms']:.3f} ms; "
          f"no single PyTorch call computes the scan; on {dev['smi']}")
    for name in ("wkv_scan", "mamba_scan"):
        t = out[name]
        print(f"{name}: {t['ms']:.4f} ms (previous design: {SCAN_BEFORE_MS[name]} ms, "
              f"{SCAN_BEFORE_MS[name] / t['ms']:.2f}x), {t['bound_ms'] / t['ms']:.1%} of its "
              f"bound; floor {SCAN_FLOOR_MS[name]} ms "
              f"{'met' if t['ms'] <= SCAN_FLOOR_MS[name] else 'MISSED'}")
        check(t["ms"] <= SCAN_FLOOR_MS[name],
              f"{name} {t['ms']:.4f} ms misses its floor {SCAN_FLOOR_MS[name]} ms")
    return out


def scan_bound(flops: float, nbytes: float) -> dict:
    """The least time for the work: FP32 operations at the non-tensor peak
    against the bytes at the HBM rate."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_HBM
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def lm_rel(out: torch.Tensor, exp: torch.Tensor) -> float:
    return float((out - exp).abs().max()) / (float(exp.abs().max()) + 1e-30)


def counted(fn):
    """fn's result and the kernel launches it made (ended by a synchronize)."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


@contextlib.contextmanager
def routing_log(calls: list):
    """Record each MoE routing of the block: (expert ids, router logits)."""
    route = moe_mod._route

    def logged(router_w, x_flat, mcfg):
        out = route(router_w, x_flat, mcfg)
        calls.append((out[1], x_flat.float() @ router_w))
        return out

    moe_mod._route = logged
    try:
        yield calls
    finally:
        moe_mod._route = route


def routing_flips(dec_calls, full_calls, S_full: int, n_experts: int) -> list:
    """The last tokens that took other experts in the decode step than in
    prefill(S_full), per MoE layer: (layer, batch row, the prefill's top-k
    gap in router logits, twice the two paths' largest router-logit
    difference for that token: a flip needs the gap below it)."""
    out = []
    for layer, ((e_d, l_d), (e_f, l_f)) in enumerate(zip(dec_calls, full_calls)):
        last = torch.arange(e_d.shape[0], device=e_d.device) * S_full + S_full - 1
        e_f, l_f = e_f[last], l_f[last, :n_experts]
        k = e_d.shape[1]
        same = (e_d.sort(-1).values == e_f.sort(-1).values).all(-1)
        top = l_f.sort(-1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        bound = 2 * (l_d[:, :n_experts] - l_f).abs().amax(-1)
        out += [(layer, b, float(gap[b]), float(bound[b]))
                for b in torch.nonzero(~same).flatten().tolist()]
    return out


def decode_vs_prefill(params, cfg, toks, S: int, label: str, scan: dict) -> tuple:
    """prefill(S) + one decode step, and prefill(S + 1): (prefill logits,
    decode logits, prefill(S + 1) logits, the flips of the last token's
    routing between the two paths)."""
    (logits, cache), steps = counted(
        lambda: prefill(params, cfg, {"tokens": toks[:, :S]}, S_max=S + 1))
    check(steps == scan, f"{label} prefill launched {steps}")
    with routing_log([]) as dec_calls:
        (dec, _), steps = counted(lambda: decode_step(params, cfg, cache,
                                                      {"tokens": toks[:, S:]}, S))
    check(not steps, f"{label} decode step launched {steps}")
    del cache
    with routing_log([]) as full_calls:
        (full, _), steps = counted(lambda: prefill(params, cfg, {"tokens": toks}))
    check(steps == scan, f"{label} prefill({S + 1}) launched {steps}")
    flips = (routing_flips(dec_calls, full_calls, S + 1, cfg.moe.n_experts)
             if cfg.moe is not None else [])
    return logits, dec, full, flips


def moe_gates(label: str, cfg, params, toks, S: int, rel_df: float, flips: list,
              f32_layers=None) -> None:
    """6f-6g: the bf16 decode-vs-prefill result with its routing flips, then
    the gate in float32 (see QWEN3_MOE_F32_LAYERS)."""
    shown = [f"layer {lay} row {b}: gap {g:.3e} <= {bd:.3e}" for lay, b, g, bd in flips]
    print(f"{label} bf16 routing: {len(flips)} last-token expert flips between decode and "
          f"prefill({S + 1}) {shown}; decode vs prefill({S + 1}) rel {rel_df:.3e} (bound "
          f"{LM_TOL}, held only without flips)")
    check(all(g <= bd for _, _, g, bd in flips),
          f"{label}: a routing flip beyond the two paths' router-logit difference {flips}")
    if not flips:
        check(rel_df <= LM_TOL, f"{label}: decode vs prefill({S + 1}) rel {rel_df}")
    n32 = f32_layers or cfg.n_layers
    if n32 < cfg.n_layers:
        del params.blocks[n32:]
        print(f"cut: the float32 gate keeps the first {n32} of the {cfg.n_layers} layers "
              f"(float32 weights of {cfg.n_layers} layers exceed the card)")
    gc.collect()
    torch.cuda.empty_cache()
    params.float()      # every bf16 value is exact in float32
    cfg32 = dataclasses.replace(cfg, n_layers=n32, dtype="float32")
    n32_params = sum(p.numel() for p in params.parameters())
    _, dec, full, flips32 = decode_vs_prefill(params, cfg32, toks, S, label, {})
    rel32 = lm_rel(dec, full)
    finite = bool(torch.isfinite(dec).all()) and bool(torch.isfinite(full).all())
    print(f"{label} float32 gate ({n32} layers, {n32_params / 1e9:.3f} B parameters, "
          f"{n32_params * 4 / 1e9:.1f} GB): prefill({S}) + decode vs prefill({S + 1}) rel "
          f"{rel32:.3e} (bound {LM_F32_TOL}); routing flips {len(flips32)}; logits finite "
          f"{finite}")
    check(finite, f"{label}: float32 logits not finite")
    check(rel32 <= LM_F32_TOL, f"{label}: float32 decode vs prefill({S + 1}) rel {rel32}")


def lm_phase(label: str, cfg, kernel, n_scan: int, seed: int, smi: str,
             prompt: int = LM_PROMPT, f32_layers=None) -> dict:
    """Serve ``cfg`` on the card: random weights from the seed, 4 prompts of
    ``prompt`` tokens, 16 greedy tokens; then the decode-vs-prefill and
    kernel-vs-plain checks.  ``kernel`` names the scan wrapper the prefill
    must launch ``n_scan`` times; with ``kernel=None`` (attention-only
    models) nothing may launch and there is no kernel to hold.  An MoE
    config's gate runs as ``moe_gates`` says, an embedding-input config's as
    ``embeds_gates`` says (``f32_layers``: the depth of the float32 gate)."""
    S = prompt
    plain_cfg = dataclasses.replace(cfg, rwkv_kernel=False, mamba_kernel=False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"{label}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
          f"parameters ({n_bytes / 1e9:.2f} GB), random from seed {seed} in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, S + 1), generator=gen, device="cuda")
    prompts = toks[:, :S]

    # the serving run: prefill, then 15 decode steps; counts 0 just before
    ops.reset_launch_counts()
    generate(cfg, params, prompts, 2)                       # warm-up
    ops.reset_launch_counts()
    tokens, stats = generate(cfg, params, prompts, LM_GEN)
    counts = launch_counts()
    want = dict.fromkeys(counts, 0) | ({kernel: n_scan} if kernel else {})
    check(counts == want, f"{label} serving launched {counts}, not {want}")
    check(tokens.shape == (LM_BATCH, LM_GEN) and bool(((tokens >= 0)
                                                       & (tokens < cfg.vocab)).all()),
          f"{label}: generated tokens {tuple(tokens.shape)} out of range")
    dec_ms = stats["decode_s"] * 1e3 / stats["decode_steps"]
    tok_s = LM_BATCH * stats["decode_steps"] / stats["decode_s"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label} serve: prefill {stats['prefill_s'] * 1e3:.2f} ms "
          f"({LM_BATCH}x{S} tokens), decode {dec_ms:.2f} ms per step "
          f"({tok_s:.1f} tokens/s at batch {LM_BATCH}); {n_params / 1e9:.3f} B parameters; "
          f"peak device memory {peak:.2f} GiB; launches {counts}; "
          f"first tokens {tokens[0, :8].tolist()}; on {smi}")

    result = {"counts": counts, "prefill_ms": stats["prefill_s"] * 1e3,
              "decode_ms": dec_ms, "tok_s": tok_s, "params": n_params, "peak_gib": peak,
              "prompt": S}
    if cfg.input_mode == "embeds":
        embeds_gates(label, cfg, params, toks, f32_layers)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return result
    # prefill(S) + one decode step against prefill(S + 1), in bf16
    scan = {kernel: n_scan} if kernel else {}
    logits_k, dec, full, flips = decode_vs_prefill(params, cfg, toks, S, label, scan)
    rel_df = lm_rel(dec, full)
    if kernel is None:
        finite = all(bool(torch.isfinite(x).all()) for x in (logits_k, dec, full))
        bound = "see the routing line" if cfg.moe is not None else LM_TOL
        print(f"{label} checks: prefill({S}) + decode vs prefill({S + 1}) "
              f"rel {rel_df:.3e} (bound {bound}); logits finite {finite}")
        check(finite, f"{label}: logits not finite")
        del logits_k, dec, full
        if cfg.moe is not None:
            moe_gates(label, cfg, params, toks, S, rel_df, flips, f32_layers)
        else:
            check(rel_df <= LM_TOL, f"{label}: decode vs prefill({S + 1}) rel {rel_df}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return result
    del full
    # the kernel against the plain chunked path on the same weights: in bf16,
    # and in float32 with the weights upcast in place (exactly)
    (logits_p, _), steps = counted(lambda: prefill(params, plain_cfg, {"tokens": prompts}))
    check(not steps, f"{label} plain prefill launched {steps}")
    rel_kp = lm_rel(logits_k, logits_p)
    params.float()      # every bf16 value is exact in float32
    (logits32_k, _), steps = counted(
        lambda: prefill(params, dataclasses.replace(cfg, dtype="float32"), {"tokens": prompts}))
    check(steps == {kernel: n_scan}, f"{label} float32 prefill launched {steps}")
    logits32_p, _ = prefill(params, dataclasses.replace(plain_cfg, dtype="float32"),
                            {"tokens": prompts})
    rel32_kp = lm_rel(logits32_k, logits32_p)
    bf16_scale = lm_rel(logits_p, logits32_p)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (logits_k, logits_p, dec, logits32_k, logits32_p))
    agree = float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean())
    print(f"{label} checks: prefill({S}) + decode vs prefill({S + 1}) rel "
          f"{rel_df:.3e} (bound {LM_TOL}); prefill logits kernel vs plain: float32 rel "
          f"{rel32_kp:.3e} (bound {LM_F32_TOL}), bf16 rel {rel_kp:.3e} (bound: the bf16 "
          f"rounding scale, plain bf16 vs plain float32 rel {bf16_scale:.3e}); argmax "
          f"agreement kernel vs plain (bf16) {agree:.2f}; logits finite {finite}")
    check(finite, f"{label}: logits not finite")
    check(rel_df <= LM_TOL, f"{label}: decode vs prefill({S + 1}) rel {rel_df}")
    check(rel32_kp <= LM_F32_TOL, f"{label}: float32 kernel vs plain logits rel {rel32_kp}")
    check(rel_kp <= bf16_scale, f"{label}: bf16 kernel vs plain logits rel {rel_kp} "
          f"exceeds the bf16 rounding scale {bf16_scale}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return result


def rwkv_phase(seed: int, smi: str) -> dict:
    phase("6 RWKV-6 3B serve (whole)")
    cfg = dataclasses.replace(get_config("rwkv6_3b"), rwkv_kernel=True)
    heads = cfg.d_model // cfg.rwkv_head_dim
    print(f"config rwkv6_3b: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {heads} wkv heads of {cfg.rwkv_head_dim} padded to "
          f"{-(-heads // cfg.tp_pad) * cfg.tp_pad} (tp_pad {cfg.tp_pad}); nothing cut; "
          f"rwkv_kernel=True")
    return lm_phase("rwkv6_3b", cfg, "wkv_scan", cfg.n_layers, seed, smi)


def jamba_phase(seed: int, smi: str) -> dict:
    phase("6b Jamba-1.5-Large, one pattern group at full width")
    full = get_config("jamba_1_5_large_398b")
    cfg = dataclasses.replace(full, n_layers=len(full.pattern), moe=None,
                              pattern=tuple((m, "mlp") for m, _ in full.pattern),
                              mamba_kernel=True)
    print(f"config jamba_1_5_large_398b: d_model {cfg.d_model}, d_inner "
          f"{cfg.mamba_expand * cfg.d_model}, d_state {cfg.mamba_d_state}, "
          f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads of {cfg.d_head}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; mamba_kernel=True")
    print(f"cut: n_layers {full.n_layers} -> {cfg.n_layers} (one pattern group: "
          f"1 attention + 7 Mamba layers)")
    moe_pos = [i for i, (_, f) in enumerate(full.pattern) if f == "moe"]
    print(f"cut: FFN 'moe' at pattern positions {moe_pos} -> the dense 'mlp' "
          f"(swiglu, d_ff {cfg.d_ff}); moe {full.moe} -> None")
    e_bytes = 3 * full.moe.n_experts * full.d_model * full.moe.d_expert_ff * 2
    print(f"why the stand-in stays: each of the group's {len(moe_pos)} expert layers holds "
          f"{e_bytes / 1e9:.1f} GB in bf16, {len(moe_pos) * e_bytes / 1e9:.1f} GB beside the "
          f"rest of the group, above the card's 80 GB; phase 6h serves one expert layer "
          f"alone, and the group with experts across ranks waits for ROADMAP.md item 8.6")
    n_mamba = sum(m == "mamba" for m, _ in cfg.pattern) * cfg.n_groups
    return lm_phase("jamba group", cfg, "mamba_scan", n_mamba, seed, smi)


def dense_phase(seed: int, smi: str) -> dict:
    """6c: the dense-attention configs whole (rotary positions, GQA; no
    kernel on the LM path), largest first."""
    phase("6c dense-attention configs served whole")
    out = {}
    for arch in DENSE_ARCHS:
        cfg = get_config(arch)
        print(f"config {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads of {cfg.d_head}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab}, rope theta {cfg.rope_theta:g}, qk_norm "
              f"{cfg.qk_norm}, qkv_bias {cfg.qkv_bias}, tied head {cfg.tie_embeddings}; "
              f"nothing cut")
        out[arch] = lm_phase(arch, cfg, None, 0, seed, smi)
    return out


def gemma_phase(seed: int, smi: str) -> dict:
    """6e: Gemma-3-12B whole: 40 sliding-window layers with ring caches and 8
    global ones, prompts of 2048 tokens."""
    phase("6e Gemma-3-12B served whole (sliding-window attention)")
    start = time.perf_counter()
    cfg = get_config("gemma3_12b")
    n_local = sum(m == "attn_local" for m, _ in cfg.pattern) * cfg.n_groups
    S_max = GEMMA_PROMPT + LM_GEN
    shapes = cache_shapes(cfg, LM_BATCH, S_max)
    kinds = [m for _ in range(cfg.n_groups) for m, _ in cfg.pattern]
    cache_gb = {kind: sum(np.prod(shape) * 2 for one, m in zip(shapes, kinds) if m == kind
                          for shape, _ in one.values()) / 1e9
                for kind in ("attn", "attn_local")}
    print(f"config gemma3_12b: {cfg.n_layers} layers ({n_local} sliding-window of "
          f"{cfg.window} tokens, {cfg.n_layers - n_local} global), d_model {cfg.d_model}, "
          f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads of {cfg.d_head}, qk_norm "
          f"{cfg.qk_norm}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied head "
          f"{cfg.tie_embeddings}; nothing cut; {LM_BATCH} prompts of {GEMMA_PROMPT} tokens: "
          f"the band starts past key 0 and the rings are primed past their {cfg.window} "
          f"slots; caches at S_max {S_max}: global {cache_gb['attn']:.2f} GB, rings "
          f"{cache_gb['attn_local']:.2f} GB")
    out = lm_phase("gemma3_12b", cfg, None, 0, seed, smi, prompt=GEMMA_PROMPT)
    print(f"phase 6e: {time.perf_counter() - start:.1f} s")
    return out


def moe_lm_phase(seed: int, smi: str) -> dict:
    """6f, 6g: the MoE configs on the dense single-device path: Qwen1.5-MoE
    whole, Qwen3-MoE-235B at full width cut in depth."""
    out = {}
    for tag, arch, n_layers, f32_layers in (
            ("6f", "qwen2_moe_a2_7b", None, None),
            ("6g", "qwen3_moe_235b_a22b", QWEN3_MOE_LAYERS, QWEN3_MOE_F32_LAYERS)):
        full = get_config(arch)
        cfg = full if n_layers is None else dataclasses.replace(full, n_layers=n_layers)
        mc = cfg.moe
        E = moe_mod._e_padded(mc, cfg.tp_pad)
        phase(f"{tag} {arch} served {'whole' if n_layers is None else 'cut in depth'} "
              f"(MoE FFN, dense path)")
        start = time.perf_counter()
        print(f"config {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
              f"query / {cfg.n_kv_heads} kv heads of {cfg.d_head}, qk_norm {cfg.qk_norm}, "
              f"qkv_bias {cfg.qkv_bias}, vocab {cfg.vocab}, tied head {cfg.tie_embeddings}; "
              f"{mc.n_experts} experts top-{mc.top_k} of d_ff {mc.d_expert_ff} padded to {E} "
              f"(tp_pad {cfg.tp_pad}; the padding is never routed), shared expert "
              f"{mc.n_shared * mc.d_expert_ff or 'none'}; every expert computed for every "
              f"token (the reference's single-device path)")
        if n_layers is not None:
            experts = 3 * E * cfg.d_model * mc.d_expert_ff * 2 * full.n_layers
            print(f"cut: n_layers {full.n_layers} -> {cfg.n_layers} (full width; the "
                  f"experts of {full.n_layers} layers alone hold {experts / 1e9:.0f} GB in bf16)")
        out[arch] = lm_phase(arch, cfg, None, 0, seed, smi, f32_layers=f32_layers)
        print(f"phase {tag}: {time.perf_counter() - start:.1f} s")
    return out


def jamba_moe_phase(seed: int, smi: str) -> dict:
    """6h: Jamba-1.5-Large's expert layer alone at full width (d 8192, 16
    experts top-2 of d_ff 24576): ``apply_moe`` on the 4 x 1024 prefill's
    tokens and a 4-token decode batch, held against each token's own top-k
    experts summed in float32."""
    phase("6h Jamba-1.5-Large expert layer at full width")
    start = time.perf_counter()
    full = get_config("jamba_1_5_large_398b")
    mc, d = full.moe, full.d_model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_moe(gen, d, mc, ep_size=full.tp_pad, dtype=full.param_dtype)
    n_params = sum(p.numel() for p in params.values())
    n_bytes = sum(p.numel() * p.element_size() for p in params.values())
    E = params["w_gate"].shape[0]
    print(f"jamba expert layer: d_model {d}, {mc.n_experts} experts top-{mc.top_k} of d_ff "
          f"{mc.d_expert_ff} (E = {E}), {n_params / 1e9:.3f} B parameters ({n_bytes / 1e9:.2f} "
          f"GB), random from seed {seed}; cut: the rest of the model (one MoE layer alone)")
    xgen = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn((LM_BATCH, LM_PROMPT, d), generator=xgen, device="cuda",
                    dtype=full.param_dtype)
    x_dec = torch.randn((LM_BATCH, 1, d), generator=xgen, device="cuda",
                        dtype=full.param_dtype)
    ops.reset_launch_counts()
    with torch.inference_mode():
        y, aux = apply_moe(params, x, mc)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(not any(counts.values()), f"6h apply_moe launched {counts}")
        pre_ms = time_ms(lambda: apply_moe(params, x, mc), 3)
        dec_ms = time_ms(lambda: apply_moe(params, x_dec, mc), 10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    flops = 3 * 2 * E * LM_BATCH * LM_PROMPT * d * mc.d_expert_ff
    # the check: each drawn token's own top-k experts, one expert at a time,
    # in float32, with routing from float64 logits
    T = LM_BATCH * LM_PROMPT
    idx = torch.randperm(T, generator=xgen, device="cuda")[:MOE_CHECK_TOKENS]
    xs = x.reshape(T, d)[idx].float()
    logits = xs.double() @ params["router"].double()
    logits[:, mc.n_experts:] = -torch.inf           # the padding experts, if any
    top = torch.softmax(logits, dim=-1).topk(mc.top_k + 1, dim=-1)
    gap = float((top.values[:, mc.top_k - 1] - top.values[:, mc.top_k]).min())
    gates = (top.values[:, :mc.top_k] / top.values[:, :mc.top_k].sum(-1, keepdim=True)).float()
    eids = top.indices[:, :mc.top_k]
    exp = torch.zeros_like(xs)
    for e in range(E):
        rows, slot = torch.nonzero(eids == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = xs[rows]
        h = torch.nn.functional.silu(xe @ params["w_gate"][e].float()) * (
            xe @ params["w_up"][e].float())
        exp.index_add_(0, rows, gates[rows, slot, None] * (h @ params["w_down"][e].float()))
    got = y.reshape(T, d)[idx].float()
    rel = lm_rel(got, exp)
    finite = bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux))
    print(f"6h apply_moe: prefill-sized call ({LM_BATCH}x{LM_PROMPT} tokens) {pre_ms:.2f} ms "
          f"({flops / (pre_ms * 1e-3) / 1e12:.1f} TFLOP/s of {flops:.3e} FLOP, every expert "
          f"on every token; {T / (pre_ms * 1e-3):.0f} tokens/s), decode batch ({LM_BATCH} "
          f"tokens) {dec_ms:.2f} ms ({LM_BATCH / (dec_ms * 1e-3):.1f} tokens/s; "
          f"{n_bytes / (dec_ms * 1e-3) / 1e12:.2f} TB/s of weights); peak device memory "
          f"{peak:.2f} GiB; aux loss {float(aux):.4f}; on {smi}")
    print(f"6h check: {MOE_CHECK_TOKENS} tokens from seed {seed + 1}, bf16 apply_moe against "
          f"the float32 sum of each token's own top-{mc.top_k} experts: max rel "
          f"{rel:.3e} (bound {MOE_TOL}); smallest top-{mc.top_k} probability gap {gap:.3e}; "
          f"output finite {finite}")
    check(finite, "6h apply_moe output not finite")
    check(rel <= MOE_TOL, f"6h apply_moe against the per-token expert sum: rel {rel}")
    del params, x, y, xs, exp
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 6h: {time.perf_counter() - start:.1f} s")
    return {"counts": counts, "prefill_ms": pre_ms, "decode_ms": dec_ms,
            "tok_s": LM_BATCH / (dec_ms * 1e-3), "params": n_params, "peak_gib": peak,
            "prompt": LM_PROMPT}


def serve_lm_twin_phase() -> dict:
    """6d: ``examples/torch_serve_lm.py`` on the card: the smoke Qwen3 served,
    then the coded lm_head on a (2, 4) mesh of ranks sharing the card, each
    rank launching kernels 1 and 2 for both erasure patterns."""
    phase("6d examples/torch_serve_lm.py on the card")
    start = time.perf_counter()
    result = torch_serve_lm.main([])
    head = result["head"]
    check(head["agree"] == 1.0 and head["drift"] == 0.0,
          f"6d: argmax agreement {head['agree']}, drift {head['drift']}")
    for rank, out in enumerate(result["outs"]):
        want = dict.fromkeys(out.launches, 0) | {"fused_worker": 2, "decode": 2}
        check(out.launches == want, f"6d rank {rank} launched {out.launches}, not {want}")
    counts = {k: sum(o.launches[k] for o in result["outs"]) for k in KERNELS}
    print(f"phase 6d: {time.perf_counter() - start:.1f} s, launches over the "
          f"{len(result['outs'])} ranks {nonzero(counts)}")
    return {"counts": counts}


# ---------------------------------------------------------------------------
# phases 6i-6j: embedding input; phases 12a-12d: training


def grad_rel(got, exp) -> float:
    """max |got - exp| / max |exp| of two gradients (float32)."""
    return lm_rel(got.float(), exp.float())


def embeds_batch(cfg, toks: torch.Tensor, pos0=None) -> dict:
    """The stub frontend's input for ``toks`` (``launch/serve.py``'s
    ``_make_batch``); for multimodal rope with ``pos0`` given, the position
    ids are (t, h, w) = arange from ``pos0`` on all three axes (every section
    rotates), else the serve CLI's zeros (decode adds the position)."""
    batch = _make_batch(cfg, toks)
    if cfg.pos == "mrope" and pos0 is not None:
        B, S = toks.shape
        batch["pos_ids"] = (torch.arange(pos0, pos0 + S, dtype=torch.int32, device=toks.device)
                            .expand(3, B, S).contiguous())
    return batch


def embeds_gate(label: str, cfg, params, toks: torch.Tensor, S_pre: int, S_full: int):
    """prefill(S_pre) then S_full - S_pre decode steps on the known inputs,
    against prefill(S_full)'s last logits (both lengths multiples of 64:
    an odd one would run the chunked attention one query at a time).
    Returns (rel, logits finite)."""
    (logits, cache), steps = counted(
        lambda: prefill(params, cfg, embeds_batch(cfg, toks[:, :S_pre], 0), S_max=S_full))
    check(not steps, f"{label} prefill({S_pre}) launched {steps}")
    finite = bool(torch.isfinite(logits).all())
    for pos in range(S_pre, S_full):
        logits, cache = decode_step(params, cfg, cache,
                                    embeds_batch(cfg, toks[:, pos:pos + 1]), pos)
        finite &= bool(torch.isfinite(logits).all())
    del cache
    (full, _), steps = counted(lambda: prefill(params, cfg, embeds_batch(cfg, toks[:, :S_full],
                                                                         0)))
    check(not steps, f"{label} prefill({S_full}) launched {steps}")
    return lm_rel(logits, full), finite and bool(torch.isfinite(full).all())


def embeds_phase(tag: str, arch: str, n_layers, seed: int, smi: str,
                 f32_layers=None) -> dict:
    """6i, 6j: an embedding-input config served on the card (the CLI's stub
    frontend: token ids as fixed pseudo-embeddings, multimodal position ids
    zero), then its gates: the position table on the card against the
    CPU's, decode against a longer prefill in bf16 (and, with
    ``f32_layers``, in float32 on that many layers), finite logits."""
    full = get_config(arch)
    cfg = full if n_layers is None else dataclasses.replace(full, n_layers=n_layers)
    phase(f"{tag} {arch} served {'whole' if n_layers is None else 'cut in depth'} "
          f"(embedding input, {cfg.pos} positions)")
    start = time.perf_counter()
    sections = f" sections {cfg.mrope_sections}" if cfg.mrope_sections else ""
    print(f"config {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} query "
          f"/ {cfg.n_kv_heads} kv heads of {cfg.d_head}, d_ff {cfg.d_ff} ({cfg.act}), vocab "
          f"{cfg.vocab}, positions {cfg.pos}{sections}, qkv_bias {cfg.qkv_bias}, input "
          f"{cfg.input_mode} (no embed table; lm_head untied)")
    if n_layers is not None:
        per = (param_counts(full)["non_embedding"]) / full.n_layers
        print(f"cut: n_layers {full.n_layers} -> {cfg.n_layers} (full width; the whole model "
              f"holds {param_counts(full)['total'] / 1e9:.2f} B parameters, "
              f"{param_counts(full)['total'] * 2 / 1e9:.0f} GB in bf16, beyond the card; "
              f"{per / 1e9:.3f} B a layer)")
    # the position tables on the card against the CPU's
    if cfg.pos == "sinusoidal":
        on_card = L.sinusoidal_positions(LM_PROMPT + LM_GEN, cfg.d_model, 0, device=CARD)
        on_cpu = L.sinusoidal_positions(LM_PROMPT + LM_GEN, cfg.d_model, 0)
        table = "sinusoidal table"
    else:
        pid = torch.arange(LM_PROMPT + LM_GEN, dtype=torch.int32).expand(3, 1, -1)
        on_cpu = torch.cat(L.mrope_cos_sin(pid, cfg.mrope_sections, cfg.d_head,
                                           cfg.rope_theta), -1)
        on_card = torch.cat(L.mrope_cos_sin(pid.to(CARD), cfg.mrope_sections, cfg.d_head,
                                            cfg.rope_theta), -1)
        table = "mrope cos/sin"
    table_err = float((on_card.cpu() - on_cpu).abs().max())
    bound = (LM_PROMPT + LM_GEN - 1) * TABLE_ULPS
    print(f"{arch} {table} of positions [0, {LM_PROMPT + LM_GEN}) on the card against the "
          f"CPU: max abs diff {table_err:.3e} (bound {bound:.3e}: the largest position "
          f"times two float32 ulps of a frequency)")
    check(table_err <= bound, f"{arch} {table}: card vs CPU {table_err}")
    out = lm_phase(arch, cfg, None, 0, seed, smi, f32_layers=f32_layers)
    print(f"phase {tag}: {time.perf_counter() - start:.1f} s")
    return out


def embeds_gates(label: str, cfg, params, toks, f32_layers) -> None:
    """The gates of 6i-6j after the serving run: decode against a longer
    prefill (EMBEDS_GATE) in bf16 within LM_TOL and, cutting the model to
    ``f32_layers`` (None: all of them) and upcasting it, in float32 within
    LM_F32_TOL."""
    S_pre, S_full = EMBEDS_GATE
    rel, finite = embeds_gate(label, cfg, params, toks, S_pre, S_full)
    print(f"{label} checks: prefill({S_pre}) + {S_full - S_pre} decode steps vs "
          f"prefill({S_full}) rel {rel:.3e} (bound {LM_TOL}); logits finite {finite}")
    check(finite, f"{label}: logits not finite")
    check(rel <= LM_TOL, f"{label}: decode vs prefill({S_full}) rel {rel}")
    n32 = f32_layers or cfg.n_layers
    if n32 < cfg.n_layers:
        del params.blocks[n32:]
        print(f"cut: the float32 gate keeps the first {n32} of the {cfg.n_layers} layers "
              f"(float32 weights of {cfg.n_layers} layers exceed the card)")
    gc.collect()
    torch.cuda.empty_cache()
    params.float()      # every bf16 value is exact in float32
    cfg32 = dataclasses.replace(cfg, n_layers=n32, dtype="float32")
    rel32, finite = embeds_gate(label, cfg32, params, toks, S_pre, S_full)
    print(f"{label} float32 gate ({n32} layers): prefill({S_pre}) + {S_full - S_pre} decode "
          f"steps vs prefill({S_full}) rel {rel32:.3e} (bound {LM_F32_TOL}); logits finite "
          f"{finite}")
    check(finite, f"{label}: float32 logits not finite")
    check(rel32 <= LM_F32_TOL, f"{label}: float32 decode vs prefill({S_full}) rel {rel32}")


def scan_grads_phase(gen, smi: str) -> dict:
    """12a: the two scans' custom backward passes at full width, each forward
    through its kernel: ``WkvFused`` at RWKV6-3B's shapes and
    ``MambaScanFused`` at a Jamba mamba layer's (the Jamba initialisation's
    regime), against autograd through the plain versions, every input's
    gradient; then the forward kernel and the backward timed apart."""
    phase("12a scan gradients at full width (kernels 7 and 6 forward)")
    start = time.perf_counter()
    out = {"counts": dict.fromkeys(KERNELS, 0)}
    cases = (("wkv_scan", WkvFused, ref.wkv_scan_ref, wkv_backward, "wkvru",
              wkv_inputs(gen, **WKV_SHAPE)),
             ("mamba_scan", MambaScanFused, ref.mamba_scan_ref, mamba_scan_backward,
              ("dt", "x", "Bm", "Cm", "A_log", "D"),
              mamba_inputs(gen, **MAMBA_SHAPE, jamba_init=True)))
    for kernel, fused, plain, backward, names, x in cases:
        y0, fin0, bounds = getattr(ops, kernel)(*x)
        y_bar = torch.randn(y0.shape, generator=gen, device=CARD)
        fin_bar = torch.randn(fin0.shape, generator=gen, device=CARD)
        ts = [t.clone().requires_grad_() for t in x]
        ops.reset_launch_counts()
        y, fin = fused.apply(*ts)
        (torch.sum(y * y_bar) + torch.sum(fin * fin_bar)).backward()
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == dict.fromkeys(counts, 0) | {kernel: 1},
              f"12a {fused.__name__} launched {counts}")
        out["counts"][kernel] += 1
        got = [t.grad for t in ts]
        del y, fin, ts
        tp = [t.clone().requires_grad_() for t in x]
        t0 = time.perf_counter()
        yp, finp, _ = plain(*tp)
        (torch.sum(yp * y_bar) + torch.sum(finp * fin_bar)).backward()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        rels = {n: grad_rel(g, t.grad) for n, g, t in zip(names, got, tp)}
        del yp, finp, tp
        gc.collect()
        torch.cuda.empty_cache()
        fwd_ms = time_ms(lambda: getattr(ops, kernel)(*x), 5)
        bwd_ms = time_ms(lambda: backward(*x, bounds, y_bar, fin_bar), 3)
        shape = ", ".join(f"{k}={v}" for k, v in (WKV_SHAPE if kernel == "wkv_scan"
                                                  else MAMBA_SHAPE).items())
        print(f"12a {fused.__name__} ({shape}): gradients against autograd through the "
              f"plain version: " + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
              + f" (bound {GRAD_TOL}); forward kernel {fwd_ms:.4f} ms, backward "
              f"{bwd_ms:.3f} ms (plain PyTorch reverse chunk scan), plain forward + "
              f"autograd {plain_s * 1e3:.1f} ms (host clock); on {smi}")
        check(all(r <= GRAD_TOL for r in rels.values()), f"12a {fused.__name__} {rels}")
        out[kernel] = {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms}
        del x, got, y0, fin0, bounds, y_bar, fin_bar
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 12a: {time.perf_counter() - start:.1f} s")
    return out


def train_loss_grads(params, cfg, batch) -> tuple:
    """(loss, {name: gradient}) of ``train_loss``."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    loss = train_loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


def kernel_vs_plain_train(label: str, cfg, kernel: str, seed: int, batch) -> dict:
    """The kernel's train path against the plain one on the same float32
    weights and batch: the loss within TRAIN_LOSS_TOL, every gradient leaf
    within GRAD_TOL of its largest value; the kernel launched twice a scan
    layer (the forward and remat's recomputation)."""
    params = init_params(cfg, seed=seed, device=CARD)
    plain_cfg = dataclasses.replace(cfg, rwkv_kernel=False, mamba_kernel=False)
    ops.reset_launch_counts()
    loss_k, grads_k = train_loss_grads(params, cfg, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    n_scan = 2 * sum(m in ("rwkv", "mamba") for m, _ in cfg.pattern) * cfg.n_groups
    check(counts == dict.fromkeys(counts, 0) | {kernel: n_scan},
          f"{label} kernel train step launched {counts}, not {n_scan} x {kernel}")
    loss_p, grads_p = train_loss_grads(params, plain_cfg, batch)
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    rels = {n: grad_rel(grads_k[n], grads_p[n]) for n in grads_p}
    worst = max(rels, key=rels.get)
    print(f"{label} kernel vs plain train step (float32, {cfg.n_layers} layers, full width): "
          f"loss {float(loss_k):.6f} vs {float(loss_p):.6f}, rel {rel_loss:.3e} (bound "
          f"{TRAIN_LOSS_TOL}); {len(rels)} gradient leaves, worst {worst} {rels[worst]:.3e} "
          f"(bound {GRAD_TOL}); launches {nonzero(counts)}")
    check(rel_loss <= TRAIN_LOSS_TOL, f"{label}: kernel vs plain loss rel {rel_loss}")
    check(rels[worst] <= GRAD_TOL, f"{label}: kernel vs plain gradient {worst} {rels[worst]}")
    del params, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def train_phase(label: str, cfg, kernel, seed: int, smi: str, batch: int = LM_BATCH,
                seq: int = LM_PROMPT, steps: int = TRAIN_STEPS) -> dict:
    """Train ``cfg`` on the card through ``make_train_step``, as the trainer
    builds it: random weights from the seed, AdamW with float32 masters,
    ``steps`` steps on the pipeline's batches; per step the host time
    (ended by reading the loss), tokens/s and the share of the bf16 tensor
    peak that ``model_flops`` makes of it; peak memory and the kernel's
    launches (twice a scan layer a step: the forward and remat's
    recomputation)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=CARD)
    opt_state = adamw_init(params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    state_gb = sum(p.numel() * (p.element_size() + 12) for p in params.parameters()) / 1e9
    flops = model_flops(cfg, "train", batch, seq)
    print(f"{label}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B parameters ({cfg.dtype}) "
          f"+ float32 master, mu, nu: {state_gb:.1f} GB; random from seed {seed} in "
          f"{time.perf_counter() - t0:.1f} s; {steps} steps of {batch} x {seq} tokens from "
          f"make_pipeline; model_flops(train) {flops:.4e} FLOP a step; remat {cfg.remat}")
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=max(2, steps // 20), total_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg)
    pipe = make_pipeline(cfg.vocab, seq, batch, seed=seed)
    ops.reset_launch_counts()
    walls, losses = [], []
    for t in range(steps):
        data = to_batch(cfg, pipe.batch(t), CARD)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, data)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"{label} step {t}: {walls[-1] * 1e3:.2f} ms, {batch * seq / walls[-1]:.1f} "
              f"tokens/s, {flops / walls[-1] / PEAK_BF16_TENSOR:.2%} of the bf16 tensor peak "
              f"(model_flops); loss {loss:.4f}, grad norm {gnorm:.4f}, lr "
              f"{float(metrics['lr']):.3e}")
        check(np.isfinite(loss) and np.isfinite(gnorm), f"{label} step {t}: loss {loss}, "
              f"grad norm {gnorm}")
    counts = launch_counts()
    n_scan = 2 * sum(m in ("rwkv", "mamba") for m, _ in cfg.pattern) * cfg.n_groups
    want = dict.fromkeys(counts, 0) | ({kernel: n_scan * steps} if kernel else {})
    check(counts == want, f"{label} training launched {counts}, not {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = float(np.median(walls[1:])) * 1e3
    # where a step's time goes: one more step taken apart (host clocks, each
    # part ended by a synchronize)
    data = to_batch(cfg, pipe.batch(steps), CARD)
    named = dict(params.named_parameters())
    marks = [time.perf_counter()]
    loss = train_loss(params, cfg, data)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    grads = torch.autograd.grad(loss, list(named.values()))
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    adamw_update(opt_cfg, dict(zip(named, grads)), opt_state)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    parts = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    print(f"{label} one step taken apart: forward and loss {parts[0]:.2f} ms, backward "
          f"(remat's recomputed forward included) {parts[1]:.2f} ms, AdamW "
          f"{parts[2]:.2f} ms")
    del grads, loss
    print(f"{label} train: median of steps 1-{steps - 1} {ms:.2f} ms a step, "
          f"{batch * seq / ms * 1e3:.1f} tokens/s, {flops / (ms * 1e-3) / PEAK_BF16_TENSOR:.2%} "
          f"of the bf16 tensor peak ({PEAK_BF16_TENSOR / 1e12:.1f} TFLOP/s); first step "
          f"{walls[0] * 1e3:.2f} ms; peak device memory {peak:.2f} GiB; launches "
          f"{nonzero(counts)}; on {smi}")
    del params, opt_state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "step_ms": ms, "tok_s": batch * seq / ms * 1e3,
            "flop_share": flops / (ms * 1e-3) / PEAK_BF16_TENSOR, "peak_gib": peak,
            "parts_ms": parts, "losses": losses}


def rwkv_train_phase(seed: int, smi: str) -> dict:
    """12b: RWKV-6 3B whole, trained through the WKV kernel."""
    phase("12b RWKV-6 3B trained whole (kernel 7 in the forward)")
    start = time.perf_counter()
    cfg = dataclasses.replace(get_config("rwkv6_3b"), rwkv_kernel=True)
    print(f"config rwkv6_3b: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}; "
          f"nothing cut; rwkv_kernel=True")
    # the gate first, on 4 layers in float32 (the same pipeline batch)
    cfg4 = dataclasses.replace(cfg, n_layers=RWKV_GATE_LAYERS, dtype="float32")
    data = to_batch(cfg4, make_pipeline(cfg.vocab, LM_PROMPT, LM_BATCH, seed=seed).batch(0),
                    CARD)
    counts = kernel_vs_plain_train("12b rwkv6_3b", cfg4, "wkv_scan", seed, data)
    out = train_phase("12b rwkv6_3b", cfg, "wkv_scan", seed, smi)
    out["counts"] = {k: out["counts"][k] + counts[k] for k in counts}
    print(f"phase 12b: {time.perf_counter() - start:.1f} s")
    return out


def train_more_phase(seed: int, smi: str) -> dict:
    """12c: Qwen3-0.6B whole (the attention backward at full width), then
    Jamba's SMOKE config through the selective-scan kernel against its plain
    path, and its train step's launches."""
    phase("12c Qwen3-0.6B trained whole; Jamba SMOKE through kernel 6")
    start = time.perf_counter()
    out = {"qwen3_0_6b": train_phase("12c qwen3_0_6b", get_config("qwen3_0_6b"), None, seed,
                                     smi)}
    cfg = dataclasses.replace(get_smoke_config("jamba_1_5_large_398b"), mamba_kernel=True)
    print(f"config jamba SMOKE: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}; mamba_kernel=True; batch "
          f"{LM_BATCH} x {JAMBA_SMOKE_SEQ}")
    data = to_batch(cfg, make_pipeline(cfg.vocab, JAMBA_SMOKE_SEQ, LM_BATCH, seed=seed).batch(0),
                    CARD)
    counts = kernel_vs_plain_train("12c jamba SMOKE", dataclasses.replace(cfg, dtype="float32"),
                                   "mamba_scan", seed, data)
    out["jamba smoke"] = train_phase("12c jamba SMOKE", cfg, "mamba_scan", seed, smi,
                                     seq=JAMBA_SMOKE_SEQ, steps=2)
    out["jamba smoke"]["counts"] = {k: out["jamba smoke"]["counts"][k] + counts[k]
                                    for k in counts}
    print(f"phase 12c: {time.perf_counter() - start:.1f} s")
    return out


def train_cli_phase() -> dict:
    """12d: the trainer's CLI (``launch/train.py``): a 6-step run checkpointing
    every 3 steps, then, its last checkpoint removed, ``--resume`` from step
    3: the resumed losses equal the run's; then the ``train_lm`` twin's quick
    run on the card must learn."""
    phase("12d the trainer CLI and examples/torch_train_lm.py on the card")
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as ck:
        args = ["--arch", "qwen3_0_6b", "--smoke", "--log-every", "100", "--ckpt-dir", ck]
        full = train_cli.main(args + ["--steps", "6", "--ckpt-every", "3"])
        shutil.rmtree(Path(ck) / "step_000000006")
        # the checkpoint resumed from is the reference's layout: its manifest
        # keys, and one leaf per stacked parameter leaf in each of params,
        # master, mu and nu, plus the step
        manifest = json.loads((Path(ck) / "step_000000003" / "manifest.json").read_text())
        n_stacked = len(jax_leaves(param_shapes(get_smoke_config("qwen3_0_6b"))))
        check(sorted(manifest) == ["dtypes", "extra", "index", "n_leaves", "step", "treedef"]
              and manifest["n_leaves"] == 4 * n_stacked + 1,
              f"12d checkpoint manifest {sorted(manifest)}, {manifest['n_leaves']} leaves")
        resumed = train_cli.main(args + ["--steps", "6", "--resume"])
    print(f"12d checkpoint of step 3 in the reference's layout: manifest keys "
          f"{sorted(manifest)}, {manifest['n_leaves']} leaves (4 x {n_stacked} stacked "
          f"parameter leaves + the step)")
    print(f"12d resume: full run losses {full}; resumed from step 3 {resumed}")
    check(resumed == full[3:], f"12d resumed losses {resumed} != {full[3:]}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = torch_train_lm.main(["--quick"])
    tail = out.getvalue().strip().splitlines()[-2:]
    print("\n".join(f"  | {line}" for line in tail))
    check(tail[-1] == "learned successfully.", f"12d train_lm twin: {tail}")
    print(f"phase 12d: {time.perf_counter() - start:.1f} s; the twin's loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}")
    return {"counts": dict.fromkeys(KERNELS, 0)}


def jax_leaves(tree) -> list:
    """A tree's leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in jax_leaves(v)]
    return [tree]


def drive(label: str, requests, C_ref, cm, per_request: dict) -> dict:
    """Serve ``requests`` [(name, call)] through one path, each C exact and
    each request launching exactly ``per_request`` kernels; the counts are
    set to 0 just before the path and read just after it."""
    walls = []
    builds = None
    ops.reset_launch_counts()
    for i, (name, call) in enumerate(requests):
        before, clusters = launch_counts(), cluster_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C = call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        after, clusters = launch_counts(), cluster_launches() - clusters
        check(C.shape == (R, T) and bool(torch.isfinite(C).all()),
              f"{label} request {i}: C {tuple(C.shape)} not finite (r, t)")
        check(torch.equal(C, C_ref), f"{label} request {i} {name}: max |C - A^T B| "
              f"= {float((C - C_ref).abs().max())}")
        steps = {k: after[k] - before[k] for k in after}
        want = dict.fromkeys(after, 0) | per_request
        check(steps == want, f"{label} request {i} launched {steps}, not {want}")
        # kernel 1 in float64 at 8000^2: the cluster form every time
        check(clusters == steps["fused_worker"], f"{label} request {i}: {clusters} of "
              f"{steps['fused_worker']} kernel 1 launches in the cluster form")
        info = cm.cache_info()
        builds = info["builds"] if builds is None else builds
        check(info["builds"] == builds, f"{label}: pipeline memo rebuilt: {info}")
        print(f"{label} request {i} {name}: exact, {walls[-1]:.2f} ms wall, "
              f"launches {({k: v for k, v in steps.items() if v})}, cache {info}")
    counts = launch_counts()
    check(all(counts[k] > 0 for k in per_request), f"{label}: a kernel never launched: "
          f"{counts}")
    print(f"{label} path launches {counts}")
    return {"counts": counts, "walls": walls}


def main_phase(plan, A, B, C_ref) -> dict:
    phase("4 main path")
    L = MAIN.L
    safe = bounds.is_safe(L, plan.s, plan.scheme.digit_depth, "float64", tau=plan.tau)
    print(f"plan bec p=m=n=2 K={plan.K} tau={plan.tau} s=2^{int(np.log2(plan.s))} "
          f"L={L} is_safe(slack 4 bits)={safe}")
    cm = CodedMatmul(plan)
    for erased in ERASURES:
        gain = float(np.abs(cm.panel_cache.get(cm_mask(plan, erased)).W).sum(1).max())
        print(f"erased={erased}: panel gain {gain:.1f}")
    return drive("fused", [(f"erased={e}", lambda e=e: cm(A, B, erased=e)) for e in ERASURES],
                 C_ref, cm, {"fused_worker": 1, "decode": 1})


def staged_phase(plan, A, B, C_ref) -> dict:
    phase("4b staged path")
    cm = CodedMatmul(plan, "staged")
    return drive("staged", [(f"erased={e}", lambda e=e: cm(A, B, erased=e)) for e in ERASURES],
                 C_ref, cm, {"encode": 2, "matmul_t": plan.K, "decode": 1})


def partial_phase(plan, A, B, C_ref) -> dict:
    phase("4c partial path")
    cm = CodedMatmul(plan, sub_tasks=Q_SUB)
    for counts in PROGRESS:
        pat = PartialPattern.from_progress(plan.K, Q_SUB, np.asarray(counts) / Q_SUB)
        gains = [float(np.abs(W).sum(1).max())
                 for W in cm.panel_cache.get_partial(pat.chunk_masks)]
        print(f"chunks done {counts}: coverage {pat.coverage.tolist()}, per-chunk "
              f"panel gain {[round(g, 2) for g in gains]}")
    out = drive("partial", [(f"progress={c}/{Q_SUB}",
                             lambda c=c: cm(A, B, progress=np.asarray(c) / Q_SUB))
                            for c in PROGRESS],
                C_ref, cm, {"fused_worker": 1, "decode_partial": 1})
    binary = drive("partial Q=1", [(f"erased={ERASURES[1]}",
                                    lambda: cm(A, B, erased=ERASURES[1], sub_tasks=1))],
                   C_ref, cm, {"fused_worker": 1, "decode": 1})
    # one split-stage pair: the worker stage, then the decode of its products
    ops.reset_launch_counts()
    Y = cm.worker_stage(A, B)
    torch.cuda.synchronize()
    stage_counts = launch_counts()
    C = cm.decode_stage(Y, (R, T), erased=ERASURES[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    check(torch.equal(C, C_ref) and torch.equal(C, cm(A, B, erased=ERASURES[0], sub_tasks=1)),
          "worker_stage + decode_stage differs from the one-shot call")
    want = dict.fromkeys(counts, 0) | {"fused_worker": 1, "decode": 1}
    check(counts == want and stage_counts["fused_worker"] == 1,
          f"split stages launched {counts}, not {want}")
    print(f"split stages erased={ERASURES[0]}: worker_stage {tuple(Y.shape)} + "
          f"decode_stage exact, equal to the one-shot call; launches "
          f"{({k: v for k, v in counts.items() if v})}, cache {cm.cache_info()}")
    for k, v in binary["counts"].items():
        out["counts"][k] += v + counts[k]
    return out


def replay_ms(graph) -> float:
    """One replay's device time (CUDA events around it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def wall_ms(call) -> tuple:
    """``call()``'s result and its host-clock wall, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


# a kernel of ours in a profiler key: its wrapper's name, then the instance
OUR_KERNEL = re.compile(r"\b(fused_worker|decode_partial|decode|encode|matmul_t)"
                        r"(?:_tma|_element|_vector|_cluster)?_kernel[<(]")


def device_activity(fn) -> dict:
    """``{name: (count, device ms)}`` of what ``fn`` ran on the card, from
    torch.profiler's CUDA activity, which lists the kernels a graph replay
    runs as well."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_time_total > 0 and not e.key.startswith("aten::")}


def ours(activity: dict) -> dict:
    out = {}
    for name, (count, _) in activity.items():
        m = OUR_KERNEL.search(name)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + count
    return out


def short(name: str) -> str:
    """A profiler key without its return type, namespaces and arguments."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def captured_phase(plan, A, B, C_ref, smi: str) -> None:
    """4d: one request of each path captured into a CUDA graph with a device
    mask (or progress) buffer, then replayed under new survivor sets."""
    phase("4d captured requests")
    bunched = cm_mask(plan, BUNCHED)
    cases = [
        ("fused", CodedMatmul(plan), "mask", {"fused_worker": 1, "decode": 1},
         [(f"erased={e}", cm_mask(plan, e)) for e in ERASURES]),
        ("staged", CodedMatmul(plan, "staged"), "mask",
         {"encode": 2, "matmul_t": plan.K, "decode": 1},
         [(f"erased={e}", cm_mask(plan, e)) for e in ERASURES]),
        ("partial", CodedMatmul(plan, sub_tasks=Q_SUB), "progress",
         {"fused_worker": 1, "decode_partial": 1},
         [(f"progress={c}/{Q_SUB}", np.asarray(c) / Q_SUB) for c in PROGRESS]),
    ]
    # launches counted at the warm-ups + captures, and at the concrete
    # requests; a replay runs its graph's launches and counts none
    at_capture = dict.fromkeys(launch_counts(), 0)
    at_concrete = dict.fromkeys(at_capture, 0)
    n_replays = 0
    for label, cm, what, per_request, sets in cases:
        buf = torch.ones(plan.K, dtype=torch.float64, device="cuda")
        ops.reset_launch_counts()
        (graph, C), capture_ms = wall_ms(lambda: cm.capture(A, B, **{what: buf}))
        captured = launch_counts()
        want = dict.fromkeys(captured, 0) | {k: 2 * v for k, v in per_request.items()}
        check(captured == want, f"4d {label}: warm-up + capture launched {captured}, "
              f"not {want}")
        check(cm.cache_info()["panel_builds"] == 0, f"4d {label}: a host panel was built")
        print(f"4d {label}: one eager request of the traced kind + the capture in "
              f"{capture_ms:.1f} ms (host clock), launches {nonzero(captured)} (twice a "
              f"request's), cache {cm.cache_info()}")
        for name, x in [*sets, (f"erased={BUNCHED} (bunched)", bunched)]:
            buf.copy_(torch.as_tensor(x, dtype=torch.float64))
            before = launch_counts()
            ms = replay_ms(graph)
            n_replays += 1
            check(launch_counts() == before, f"4d {label} {name}: a replay counted "
                  f"launches")
            concrete, wall = wall_ms(lambda x=x: cm(A, B, **{what: x}))
            err, err_concrete = (float((y - C_ref).abs().max()) for y in (C, concrete))
            if name.endswith("(bunched)"):
                print(f"4d {label} replay {name}: max |C - A^T B| {err:g} replayed, "
                      f"{err_concrete:g} concrete (not gated); replay {ms:.3f} ms")
                continue
            check(torch.equal(C, C_ref) and torch.equal(C, concrete),
                  f"4d {label} replay {name}: max |C - A^T B| {err}, concrete {err_concrete}, "
                  f"equal to concrete {torch.equal(C, concrete)}")
            print(f"4d {label} replay {name}: exact and equal to the concrete C; replay "
                  f"{ms:.3f} ms (CUDA events) beside the concrete request's {wall:.2f} ms "
                  f"wall (host clock) on {smi}")
            del concrete
        # what the graph runs on the card against one concrete request
        replayed = device_activity(graph.replay)
        n_replays += 1
        concrete = device_activity(lambda: cm(A, B, **{what: sets[0][1]}))
        check(ours(replayed) == ours(concrete) == per_request,
              f"4d {label}: kernels in the graph {ours(replayed)}, in a concrete request "
              f"{ours(concrete)}, not {per_request}")
        check(not any("HtoD" in k for k in replayed), f"4d {label}: the graph copies "
              f"from the host: {[k for k in replayed if 'HtoD' in k]}")
        # the launches the graph runs beyond a concrete request's, and the time
        # they add (a kernel both run, such as the erase multiply, counts once)
        panel = {}
        for k, (n, ms) in replayed.items():
            n_c, ms_c = concrete.get(k, (0, 0.0))
            if n > n_c and not OUR_KERNEL.search(k):
                panel[k] = (n - n_c, max(ms - ms_c, 0.0))
        kernel_ms = sum(ms for k, (_, ms) in replayed.items() if OUR_KERNEL.search(k))
        panel_ms = sum(ms for _, ms in panel.values())
        total_ms = sum(ms for _, ms in replayed.values())
        print(f"4d {label} graph (torch.profiler, one replay): our kernels {ours(replayed)} as "
              f"in a concrete request; besides, only the device panel's "
              f"{sum(n for n, _ in panel.values())} launches: "
              f"{sorted({short(k) for k in panel})}; the concrete request's host copies "
              f"{[(short(k), n) for k, (n, _) in concrete.items() if 'HtoD' in k]}")
        print(f"4d {label} replay device time {total_ms:.3f} ms = our kernels {kernel_ms:.3f} "
              f"+ the panel {panel_ms:.3f} + erase and recompose {total_ms - kernel_ms - panel_ms:.3f} "
              f"ms (CUPTI kernel durations) on {smi}")
        for k, v in launch_counts().items():
            at_capture[k] += captured[k]
            at_concrete[k] += v - captured[k]
        del graph, C
        torch.cuda.empty_cache()
    print(f"4d launches (kept out of the kernels line): warm-ups + captures "
          f"{nonzero(at_capture)}, concrete requests {nonzero(at_concrete)}; {n_replays} "
          f"replays ran their graphs' launches and counted none")


def times_phase(plan, A, B, smi: str) -> dict:
    phase("5 times")
    ca, cb, a4, b4 = fused_inputs(plan, A, B, torch.float64)
    K, P, Q = plan.K, ca.shape[1], cb.shape[1]
    v, r, t = a4.shape[-2], a4.shape[-1], b4.shape[-1]

    def bound(flops: float, nbytes: float, by: str) -> dict:
        return {"bound_ms": max(flops / PEAK_FP64_TENSOR, nbytes / PEAK_HBM) * 1e3,
                "bound_by": by}

    g = plan.scheme.grid
    ca3, cb3 = ca.reshape(K, g.p, g.m), cb.reshape(K, g.p, g.n)

    def library_fused():
        at = torch.einsum("kpm,pmvr->kvr", ca3, a4)
        bt = torch.einsum("kpn,pnvt->kvt", cb3, b4)
        return torch.bmm(at.transpose(1, 2), bt)

    fused = dict(
        ms=time_ms(lambda: ops.fused_worker(ca, cb, a4, b4), 5),
        plain_ms=time_ms(lambda: ref.fused_worker_ref(ca, cb, a4, b4), 5),
        library_ms=time_ms(library_fused, 5))
    flops = 2 * K * r * t * v + 2 * K * (P * v * r + Q * v * t)
    nbytes = 8 * (P * v * r + Q * v * t + K * r * t + K * (P + Q))
    fused |= bound(flops, nbytes, "operations")
    print(f"fused_worker: {flops:.4g} FLOP, {nbytes:.4g} B; bound "
          f"{fused['bound_ms']:.3f} ms at FP64 tensor peak "
          f"({flops / PEAK_FP64_VECTOR * 1e3:.3f} ms at FP64 vector peak); "
          f"kernel {fused['ms']:.3f} ms, plain {fused['plain_ms']:.3f} ms, "
          f"einsum+bmm {fused['library_ms']:.3f} ms; on {smi}")
    tensor_rate("fused_worker", flops, fused)
    # kernel 1's float64 forms: the cluster form (above), the tile form
    # on the same operands, and the cluster form at P = Q = 1 (one 4000^2
    # block a side: the same FLOP, a quarter of the raw bytes and encode)
    check(coded_fused.clustered(torch.float64, copy_width(a4, b4), P, Q, r, t),
          "fused_worker: the main shape does not take the cluster form")
    tile_ms = time_ms(lambda: coded_fused.fused_worker_cuda(ca, cb, a4, b4, cluster=False), 5)
    a1, b1 = a4[0, 0].contiguous()[None], b4[0, 0].contiguous()[None]
    c1 = ca[:, :1].contiguous()
    single_ms = time_ms(lambda: ops.fused_worker(c1, c1, a1, b1), 5)
    clusters = ctypes.c_int(0)
    check(_build.load("coded_fused").repro_fused_worker_f64_cluster_occupancy(
        ctypes.byref(clusters)) == 0, "fused_worker: cluster occupancy query failed")
    print(f"fused_worker float64 forms: cluster {fused['ms']:.3f} ms, tile (a block a "
          f"tile) {tile_ms:.3f} ms, cluster at P=Q=1 {single_ms:.3f} ms "
          f"({2 * K * r * t * v / (single_ms * 1e-3) / PEAK_FP64_TENSOR:.1%} of the FP64 "
          f"tensor peak); {clusters.value} clusters of 4 at once ({4 * clusters.value} of "
          f"{SMS} SMs); on {smi}")
    del a1, b1

    # encode: the kernel reads the strided block view; the plain version and
    # torch.matmul get the (P, E) stack made beforehand (their reshape would
    # copy 512 MB inside the timing)
    stack = a4.reshape(P, -1)
    enc = dict(
        ms=time_ms(lambda: ops.encode(ca, a4), 20),
        plain_ms=time_ms(lambda: ref.encode_ref(ca, stack), 20),
        library_ms=time_ms(lambda: torch.matmul(ca, stack), 20))
    E = v * r
    flops, nbytes = 2 * K * P * E, 8 * (P * E + K * E + K * P)
    enc |= bound(flops, nbytes, "bytes")
    print(f"encode: {flops:.4g} FLOP, {nbytes:.4g} B; bound {enc['bound_ms']:.3f} ms at "
          f"HBM peak; kernel {enc['ms']:.3f} ms ({nbytes / enc['ms'] / 1e6:.1f} GB/s), "
          f"plain {enc['plain_ms']:.3f} ms, torch.matmul {enc['library_ms']:.3f} ms; on {smi}")
    del stack

    at, bt = ops.encode(ca, a4), ops.encode(cb, b4)
    a1, b1 = at[0], bt[0]
    mm = dict(
        ms=time_ms(lambda: ops.matmul_t(a1, b1), 5),
        plain_ms=time_ms(lambda: ref.matmul_t_ref(a1, b1), 5),
        library_ms=time_ms(lambda: a1.T @ b1, 5))
    flops, nbytes = 2 * v * r * t, 8 * (v * r + v * t + r * t)
    mm |= bound(flops, nbytes, "operations")
    print(f"matmul_t: {flops:.4g} FLOP, {nbytes:.4g} B; bound {mm['bound_ms']:.3f} ms at "
          f"FP64 tensor peak ({flops / PEAK_FP64_VECTOR * 1e3:.3f} ms at FP64 vector "
          f"peak); kernel {mm['ms']:.3f} ms, plain {mm['plain_ms']:.3f} ms (A.T @ B: the "
          f"plain version is the library call), A.T @ B {mm['library_ms']:.3f} ms; on {smi}")
    tensor_rate("matmul_t", flops, mm)
    encode_ms = fused["ms"] - K * mm["ms"]
    print(f"encode inside fused_worker: kernel 1 - K x kernel 5 = {fused['ms']:.3f} - "
          f"{K} x {mm['ms']:.3f} = {encode_ms:.3f} ms ({encode_ms / fused['ms']:.1%} of "
          f"kernel 1); on {smi}")
    del at, bt, a1, b1

    Y = ops.fused_worker(ca, cb, a4, b4).reshape(K, -1)
    del ca, cb, a4, b4
    W = torch.as_tensor(plan.make_panel_cache().get(np.ones(K)).W, device="cuda")
    mn, E, s = W.shape[0], Y.shape[1], plan.s

    def extract(X):
        C_hat = torch.remainder(torch.round(X), s)
        return torch.where(C_hat <= s / 2, C_hat, C_hat - s)

    dec = dict(
        ms=time_ms(lambda: ops.decode(W, Y, s), 20),
        plain_ms=time_ms(lambda: ref.decode_ref(W, Y, s), 20),
        library_ms=time_ms(lambda: extract(torch.matmul(W, Y)), 20))
    flops, nbytes = 2 * mn * K * E, 8 * (K * E + mn * K + mn * E)
    dec |= bound(flops, nbytes, "bytes")
    print(f"decode: {flops:.4g} FLOP, {nbytes:.4g} B; bound {dec['bound_ms']:.3f} ms "
          f"at HBM peak; kernel {dec['ms']:.3f} ms ({nbytes / dec['ms'] / 1e6:.1f} "
          f"GB/s), plain {dec['plain_ms']:.3f} ms, matmul+extract "
          f"{dec['library_ms']:.3f} ms; on {smi}")

    pat = PartialPattern.from_progress(K, Q_SUB, np.asarray(PROGRESS[0]) / Q_SUB)
    W_stack = torch.as_tensor(plan.make_panel_cache().get_partial(pat.chunk_masks),
                              device="cuda")
    cols = [b * t for b in chunk_bounds(r, Q_SUB)]

    def library_partial():
        return torch.cat([extract(torch.matmul(W_stack[q], Y[:, cols[q]:cols[q + 1]]))
                          for q in range(Q_SUB)], dim=1)

    part = dict(
        ms=time_ms(lambda: ops.decode_partial(W_stack, Y, s, bounds=cols), 20),
        plain_ms=time_ms(lambda: ref.decode_partial_ref(W_stack, Y, s, True, cols), 20),
        library_ms=time_ms(library_partial, 20))
    flops, nbytes = 2 * mn * K * E, 8 * (K * E + Q_SUB * mn * K + mn * E)
    part |= bound(flops, nbytes, "bytes")
    floor = FLOOR_MS["decode_partial"]
    print(f"decode_partial (Q={Q_SUB}, bounds {cols}): {flops:.4g} FLOP, {nbytes:.4g} B; "
          f"bound {part['bound_ms']:.4f} ms at HBM peak; kernel {part['ms']:.4f} ms "
          f"({nbytes / part['ms'] / 1e6:.1f} GB/s, {part['bound_ms'] / part['ms']:.1%} of "
          f"the bound; previous design {DECODE_PARTIAL_BEFORE_MS} ms, "
          f"{DECODE_PARTIAL_BEFORE_MS / part['ms']:.2f}x), plain {part['plain_ms']:.3f} ms, "
          f"per-chunk matmul+extract {part['library_ms']:.3f} ms; floor {floor} ms "
          f"{'met' if part['ms'] <= floor else 'MISSED'}; on {smi}")
    check(part["ms"] <= floor, f"decode_partial {part['ms']:.4f} ms misses its floor {floor} ms")
    # kernel 3 with one chunk over the whole of Y beside kernel 2 on the same
    # Y and panel, in turns
    k2a = time_ms(lambda: ops.decode(W, Y, s), 20)
    q1 = [time_ms(lambda: ops.decode_partial(W[None], Y, s, bounds=[0, E]), 20)
          for _ in range(2)]
    k2b = time_ms(lambda: ops.decode(W, Y, s), 20)
    q1_ms, k2_ms = sum(q1) / 2, (k2a + k2b) / 2
    print(f"same Y (K={K}, E={E}), same panel: kernel 3 at Q=1 {q1[0]:.4f} / {q1[1]:.4f} ms "
          f"({nbytes / q1_ms / 1e6:.1f} GB/s), kernel 2 {k2a:.4f} / {k2b:.4f} ms "
          f"({nbytes / k2_ms / 1e6:.1f} GB/s); on {smi}")
    check(q1_ms <= k2_ms, f"kernel 3 at Q=1 ({q1_ms:.4f} ms) slower than kernel 2 "
          f"({k2_ms:.4f} ms) on the same Y")
    # kernel 3's 16-row instance, which the main path (mn = 4) does not
    # reach: one register pass (mn = 16), two over a tile's K rows resident
    # in shared memory (mn = 20), and two that copy their row groups again
    # (mn = 24, K = 40: too many rows to stay resident)
    gen = torch.Generator(device="cuda").manual_seed(16)
    Ex = 4_000_000
    bx = [q * Ex // Q_SUB for q in range(Q_SUB + 1)]
    for mn_x, K_x in ((16, 10), (20, 10), (24, 40)):
        Yx = torch.randint(-40, 41, (K_x, Ex), generator=gen, device="cuda").double()
        Wx = torch.randint(-2, 3, (Q_SUB, mn_x, K_x), generator=gen, device="cuda").double()
        label = f"decode_partial mn={mn_x} K={K_x} (Q={Q_SUB}, E={Ex}, float64)"
        check_exact(label, ops.decode_partial(Wx, Yx, s, bounds=bx),
                    ref.decode_partial_ref(Wx, Yx, s, True, bx))
        ms = time_ms(lambda: ops.decode_partial(Wx, Yx, s, bounds=bx), 20)
        nb = 8 * (K_x * Ex + Q_SUB * mn_x * K_x + mn_x * Ex)
        print(f"{label}: kernel {ms:.4f} ms ({nb / ms / 1e6:.1f} GB/s, "
              f"{nb / PEAK_HBM * 1e3 / ms:.1%} of its {nb / PEAK_HBM * 1e3:.4f} ms "
              f"bytes bound); on {smi}")
    del Yx, Wx
    return {"fused_worker": fused, "decode": dec, "encode": enc, "matmul_t": mm,
            "decode_partial": part}


def serve_timed(call) -> tuple:
    """``call()`` between two synchronizes: (result, wall ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int64), b.view(torch.int64))


def obs_phase(plan, A, B, C_ref, times: dict, smi: str) -> dict:
    """The fused main path with observability off, then on; one staged and
    one partial request with it on; the counters and spans against the
    launch counts, and the dumps written and read back."""
    phase("7 observability on the main path")
    obs.disable()
    ops.reset_launch_counts()
    cm_off = CodedMatmul(plan)
    off, walls_off = [], []
    for e in ERASURES:
        C, ms = serve_timed(lambda: cm_off(A, B, erased=e))
        check(torch.equal(C, C_ref), f"obs off erased={e}: C differs from A^T B")
        off.append(C)
        walls_off.append(ms)
    session = obs.enable(fresh=True)
    reg, rec = session.registry, session.recorder
    before = launch_counts()
    cm = CodedMatmul(plan)
    walls_on, sizes = [], []
    for e, C_off in zip(ERASURES, off):
        C, ms = serve_timed(lambda: cm(A, B, erased=e))
        check(same_bits(C, C_off) and torch.equal(C, C_ref),
              f"obs on erased={e}: C is not bit-identical to obs off / A^T B")
        walls_on.append(ms)
        sizes.append(cm.executable_cache_size())
    del off
    compiles = {dict(lab)["kind"]: m.value for (n, lab), m in reg.collect()
                if n == "runtime.executable.compile"}
    hits = reg.total("runtime.executable.hit")
    misses = reg.value("decode.panel_cache.miss", cache="panel")
    print(f"obs on, {len(ERASURES)} patterns: runtime.executable.compile {compiles}, "
          f".hit {hits:g}, executable_cache_size {sizes}, decode.panel_cache.miss"
          f"{{cache=panel}} {misses:g}, spans {len(rec.spans)}")
    check(compiles == {"concrete": 1}, f"pipeline builds per kind {compiles}, not 1")
    check(hits == len(ERASURES) - 1, f"runtime.executable.hit {hits}")
    check(len(set(sizes)) == 1 and sizes[0] == 1, f"executable_cache_size moved: {sizes}")
    check(misses == len({tuple(e) for e in ERASURES}),
          f"panel misses {misses} for {len(ERASURES)} distinct patterns")
    C, ms_staged = serve_timed(lambda: cm.with_backend("staged")(A, B, erased=ERASURES[1]))
    check(torch.equal(C, C_ref), "obs on staged request: C differs from A^T B")
    progress = np.asarray(PROGRESS[0]) / Q_SUB
    C, ms_partial = serve_timed(lambda: cm(A, B, progress=progress, sub_tasks=Q_SUB))
    check(torch.equal(C, C_ref), "obs on partial request: C differs from A^T B")
    del C
    after = launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    calls = {k: reg.value("kernel.call", op=k, traced=0) or 0 for k in after}
    print(f"obs on: launches {({k: v for k, v in launched.items() if v})}, "
          f"kernel.call {({k: int(v) for k, v in calls.items() if v})}")
    check(calls == launched, f"kernel.call {calls} != launch deltas {launched}")
    for op in ("fused_worker", "decode", "encode", "matmul_t", "decode_partial"):
        spans = rec.by_name(f"kernel.{op}")
        check(len(spans) == launched[op] and all(x.duration_s > 0 for x in spans),
              f"kernel.{op}: {len(spans)} spans for {launched[op]} launches")
        mean = sum(x.duration_s for x in spans) / len(spans) * 1e3
        print(f"span kernel.{op}: n={len(spans)}, mean {mean:.4f} ms (CUDA events at "
              f"launch); phase 5 CUDA-event mean {times[op]['ms']:.4f} ms; on {smi}")
    print(f"fused request wall, obs off {[round(w, 2) for w in walls_off]} ms, obs on "
          f"{[round(w, 2) for w in walls_on]} ms (kernel spans deferred, closed at the read; "
          f"the first request builds the pipeline); staged {ms_staged:.2f} ms, partial "
          f"{ms_partial:.2f} ms with obs on; on {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        tpath, mpath = Path(tmp) / "trace.json", Path(tmp) / "metrics.prom"
        export.write_perfetto(str(tpath), rec.spans)
        export.write_prometheus(str(mpath), reg)
        doc = json.loads(tpath.read_text())
        text = mpath.read_text()
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    check(doc["displayTimeUnit"] == "ms" and len(slices) == len(rec.spans)
          and all(set(e) == {"ph", "name", "pid", "tid", "ts", "dur", "args"}
                  for e in slices),
          "Perfetto dump: schema")
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    check({"main", "kernels"} <= lanes, f"Perfetto dump lanes {lanes}")
    samples = export.parse_prometheus(text)
    check("# TYPE runtime_executable_compile counter" in text
          and samples["runtime_executable_compile"][0][0]["kind"] == "concrete"
          and sum(v for _, v in samples["kernel_call"]) == sum(launched.values()),
          "Prometheus dump: schema and counts")
    print(f"dumps: {len(slices)} Perfetto slices on lanes {sorted(lanes)}, "
          f"{len(text.splitlines())} Prometheus lines, read back and checked; report:")
    print(report.render(text, doc), end="")
    obs.disable()
    return {"counts": launch_counts()}


def paper_phase(smi: str) -> dict:
    """The paper's Table I, Fig. 1 and p' sweep at v = 8000 through the
    port's benches; each bench's launch counts set to 0 just before it."""
    phase("8 the paper's experiments at v = 8000")
    counts = dict.fromkeys(launch_counts(), 0)

    def run(label, fn):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got = launch_counts()
        for k, v in got.items():
            counts[k] += v
        print(f"{label}: {time.perf_counter() - t0:.1f} s, launches "
              f"{({k: v for k, v in got.items() if v})}")
        return out, got

    bounds_list = (15, 100, 200, 500, 1000, 2000)
    fused, got = run("Table I fused", lambda: torch_table1_error.run(
        v=PAPER.v, bounds_list=bounds_list, fused=True))
    check(got["fused_worker"] == got["decode"] == len(bounds_list),
          f"Table I fused launched {got}")
    plain, got = run("Table I reference", lambda: torch_table1_error.run(
        v=PAPER.v, bounds_list=bounds_list, fused=False))
    check(not any(got.values()), f"Table I reference launched {got}")
    print(f"Table I (v={PAPER.v}, A, B {PAPER.v}x{PAPER.v // 2} in {{0..bound}}, bec "
          f"p=m=n=2, K=10 equispaced, worker 0 erased; float64) on {smi}")
    print("bound,s,log2_maxX,analytic_safe,rel_err fused (kernels 1+2),"
          "rel_err reference (plain, on the card)")
    for f, r in zip(fused, plain):
        print(f"{f['bound']},2^{int(np.log2(f['s']))},{f['log2_maxX']:.1f},"
              f"{f['analytic_safe']},{f['rel_err']!r},{r['rel_err']!r}")
    check(all(np.isfinite(r["rel_err"]) for r in fused + plain), "Table I: rel_err not finite")
    check(fused[0]["bound"] == 15 and fused[0]["rel_err"] == 0.0,
          f"Table I bound-15 control row not exact with the fused kernels: {fused[0]}")
    if plain[0]["rel_err"] != 0.0:
        print(f"NOTE: the plain reference on the card is not exact at bound 15: {plain[0]}")

    rows, got = run("Fig. 1", lambda: torch_fig1_latency.run(size=PAPER.v))
    check(all(got[k] > 0 for k in ("fused_worker", "decode", "matmul_t")),
          f"Fig. 1 launched {got}")
    r0 = rows[0]
    print(f"Fig. 1 ({PAPER.name}: v=r=t={PAPER.v}, entries {{0..{PAPER.entry_max}}}, K="
          f"{PAPER.K}, stragglers x{PAPER.straggler_slowdown}; float64) on {smi}")
    print(f"t_worker {r0['worker_s'] * 1e3:.4f} ms (kernel 5, one {PAPER.v // PAPER.p}x"
          f"{PAPER.r // PAPER.m} block product; torch.matmul {r0['worker_library_s'] * 1e3:.4f}"
          f" ms for reference)")
    lat = {}
    for scheme in ("bec", "polycode"):
        rs = [r for r in rows if r["scheme"] == scheme]
        lat[scheme] = [r["latency_s"] for r in rs]
        print(f"{scheme}: tau {rs[0]['tau']}, t_decode {rs[0]['decode_s'] * 1e3:.4f} ms "
              f"(kernel 2), rel_err {rs[0]['rel_err']!r}; latency (ms) for S=0..8 "
              f"{[round(x * 1e3, 4) for x in lat[scheme]]}")
    bec, poly = lat["bec"], lat["polycode"]
    check(len(set(bec[:7])) == 1 and bec[7] > bec[6],
          f"Fig. 1: bec not flat through S=6 with a jump at S=7: {bec}")
    check(poly[1] == poly[0] and all(x > poly[0] for x in poly[2:]),
          f"Fig. 1: polycode does not rise from S=2: {poly}")

    sweep, got = run("tradeoff sweep", lambda: torch_tradeoff_sweep.run(
        v=PAPER.v, cols=PAPER.v))
    check(got["fused_worker"] == len(sweep), f"tradeoff sweep launched {got}")
    print(f"p' tradeoff sweep (p=8, m=n=2, v={PAPER.v}, {PAPER.v} columns, entries in "
          f"[-20, 20], chebyshev points, Y from kernel 1) on {smi}")
    print("p_prime,tau,digit_depth,log2_analytic_maxX,log2_measured_maxY,f64_safe")
    for r in sweep:
        print(f"{r['p_prime']},{r['tau']},{r['digit_depth']},{r['log2_analytic_maxX']:.2f},"
              f"{r['log2_measured_maxY']:.2f},{r['f64_safe']}")
    check(all(np.isfinite(r["log2_measured_maxY"]) for r in sweep),
          "tradeoff sweep: max|Y| not finite")
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts}


def launches_since(before: dict) -> dict:
    after = launch_counts()
    return {k: after[k] - before[k] for k in after}


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def rec_total(name: str) -> int:
    """A counter's total over all its label sets in the obs session."""
    return int(obs.session().registry.total(name))


def golden_replay_phase(counts: dict) -> None:
    """9a: every control golden trace replayed through the kernels; the
    diff against the checked-in file must be empty and every step exact."""
    for backend in ("fused", "staged"):
        for key in golden_names():
            golden = Trace.load(GOLDEN_DIR / f"{key}.jsonl")
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            reports = replay_golden(key, golden, device="cuda", backend=backend)
            torch.cuda.synchronize()
            got = launch_counts()
            diff = golden.diff(reports)
            check(diff == [], f"9a {backend} {key}: replay differs from the golden "
                  f"file: {diff[:3]}")
            check(all(r.exact for r in reports), f"9a {backend} {key}: inexact step")
            check(got["fused_worker" if backend == "fused" else "matmul_t"] > 0,
                  f"9a {backend} {key}: the worker kernel never launched: {got}")
            for k, v in got.items():
                counts[k] += v
            print(f"9a {backend:<6} {key:<18} {len(reports):>2} steps, diff [], all exact, "
                  f"rungs {sorted({r.rung for r in reports})}, "
                  f"{time.perf_counter() - t0:.2f} s, launches {nonzero(got)}")


def adaptive_run(label: str, ladder, A, B, scenario, steps: int, counts: dict, *,
                 seed: int, sub_tasks: int = 1, universe=None, pool=None,
                 join=None, gated: bool = True) -> list:
    """Serve ``steps`` requests through an ``AdaptiveServer`` over ``ladder``
    and print each step; returns the reports.  Gates every step's launches
    and the pipeline builds (none outside an elastic handoff), and, when
    ``gated``, its product (``check_exact``); otherwise prints the decode
    panel's gain (max row sum of |W|) beside the step's exactness."""
    policy = ExpectedLatencyPolicy(ladder, overhead_s=PAPER_OVERHEAD_S,
                                   sub_tasks=sub_tasks)
    feed = scenario.compile(universe or ladder.K, seed=seed)
    server = AdaptiveServer(ladder, policy=policy, feed=feed, seed=seed,
                            check_exact=True, sub_tasks=sub_tasks,
                            universe=universe, pool=pool)
    decode = "decode_partial" if sub_tasks > 1 else "decode"
    rec = obs.session().recorder
    watch = CompileWatch()
    ops.reset_launch_counts()
    for i in range(steps):
        handoff = ""
        if join is not None and i == join[0]:
            rungs_before = ladder.rungs
            server.grow(join[1])
            handoff = f" grow {rungs_before} -> {ladder.rungs} (pool {len(server.pool)})"
            watch.mark()  # the grown pool's pipelines build once, here
        before = launch_counts()
        pool_before = None if server.pool is None else len(server.pool)
        _, rep = server.step(A, B)
        got = launches_since(before)
        shrunk = pool_before is not None and len(rep.pool) < pool_before
        # a shrink re-prewarms the survivor pool inside the step: one build
        # and one timed call per rung it kept
        extra = 2 * len(ladder.rungs) if shrunk else 0
        want = dict.fromkeys(got, 0) | {"fused_worker": 1 + extra, decode: 1}
        if shrunk:
            want["decode"] += extra
        check(rep.exact or not gated, f"{label} step {i}: C differs from A^T B")
        check(got == want, f"{label} step {i} launched {got}, not {want}")
        builds = watch.delta()
        check(builds == 0 or shrunk, f"{label} step {i}: {builds} pipeline build(s) "
              f"outside a handoff")
        watch.mark()
        begin = rec.by_name("control.begin_step")[-1].duration_s * 1e3
        complete = rec.by_name("control.complete_step")[-1].duration_s * 1e3
        what = (f"progress {[round(x, 2) for x in rep.progress]}" if rep.progress
                else f"erased {list(rep.erased)}")
        gain = ""
        if not gated:
            mask = np.ones(ladder.K)
            mask[list(rep.erased)] = 0
            W = ladder.facade(rep.rung).panel_cache.get(mask).W
            gain = f", panel gain {float(np.abs(W).sum(1).max()):.1f}"
        if shrunk:
            handoff = f" shrink -> pool {len(rep.pool)}, rungs {ladder.rungs}, {builds} builds"
        print(f"{label} step {i:>2}: {rep.rung:<8} switched {int(rep.switched)} {what} "
              f"pool {len(rep.pool) if rep.pool else ladder.K} sim {rep.sim_latency_s:.4f} "
              f"wall {rep.wall_ms:.2f} ms exact {rep.exact}{gain} begin {begin:.3f} ms "
              f"complete {complete:.3f} ms launches {nonzero(got)}{handoff}")
    for k, v in launch_counts().items():
        counts[k] += v
    return server.reports


def control_phase(seed: int, smi: str) -> dict:
    """The adaptive control plane (``repro_torch.control``) on the card: the
    golden traces through the kernels (9a), the paper's 8000^2 geometry
    through ``AdaptiveServer`` (9b, gated), the main path's entry bound
    reported (9c), and the control bench twin's gates on the fused kernels."""
    phase("9 adaptive control plane")
    start = time.perf_counter()
    counts = dict.fromkeys(launch_counts(), 0)
    golden_replay_phase(counts)

    obs.enable(fresh=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ints = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi + 1, shape, generator=gen, device="cuda", dtype=torch.float64)
    v, r, t = PAPER.v, PAPER.r, PAPER.t
    L = bounds.conservative_L(v, 2, 2)
    A, B = ints(-2, 2, (v, r)), ints(-2, 2, (v, t))

    def ladder(L, sub_tasks=1, **kw):
        lad = PlanLadder(PAPER.p, PAPER.m, PAPER.n, K=PAPER.K, L=L, backend="fused",
                         device="cuda", **kw)
        info = lad.prewarm((v, r), (v, t), sub_tasks=sub_tasks)
        print(f"ladder K={PAPER.K} L={L} s=2^{int(np.log2(lad.plan(lad.rungs[0]).s))}: "
              + ", ".join(f"{x} tau {lad.tau(x)} feasible {lad.feasible(x)}"
                          for x in lad.rungs)
              + f"; prewarm step_overhead_s {info['overhead_s']} beside the policy's "
              f"constants {PAPER_OVERHEAD_S} (on {smi})")
        return lad

    print(f"9b paper geometry: v=r=t={v}, grid p=m=n=2, K={PAPER.K}, float64, entries "
          f"in [-2, 2], chebyshev points, fused kernels")
    lad = ladder(L, sub_tasks=Q_SUB)
    check(lad.rungs == ("bec", "polycode"), f"9b rungs {lad.rungs}")
    runs = {"heavy_tail": adaptive_run("9b heavy_tail", lad, A, B, make_scenario("heavy_tail"),
                                       10, counts, seed=seed),
            "crawler Q=4": adaptive_run("9b crawler Q=4", lad, A, B, make_scenario("crawler"),
                                        10, counts, seed=seed, sub_tasks=Q_SUB)}
    scenario = make_scenario("pool_resize", num_departing=3, depart_step=4,
                             num_arriving=2, join_step=12)
    arriving = scenario.arriving_ids(12, seed)
    pool = [i for i in range(12) if i not in set(arriving.tolist())]
    el = ladder(L, include=["polycode"])
    reps = adaptive_run("9b elastic", el, A, B, scenario, 16, counts, seed=seed,
                        universe=12, pool=pool, join=(12, arriving))
    runs["elastic"] = reps
    sizes = [len(x.pool) for x in reps]
    shrink = next((i for i, n in enumerate(sizes) if n < 10), None)
    check(shrink is not None and sizes[shrink] == 7 and reps[shrink].rung == "bec"
          and reps[0].rung == "polycode" and any(x.respecialize for x in reps),
          f"9b elastic: no shrink 10 -> 7 onto bec: pools {sizes}, "
          f"rungs {[x.rung for x in reps]}")
    check(sizes[-1] == 9 and "polycode" in el.rungs and el.feasible("polycode"),
          f"9b elastic: no grow to 9 with polycode back: pools {sizes}, rungs {el.rungs}")
    rec = obs.session().recorder
    print(f"9b control host time per step (control.* spans): begin_step median "
          f"{np.median([x.duration_s for x in rec.by_name('control.begin_step')]) * 1e3:.3f}"
          f" ms, complete_step median "
          f"{np.median([x.duration_s for x in rec.by_name('control.complete_step')]) * 1e3:.3f}"
          f" ms; counters switch {rec_total('control.switch')}, respecialize "
          f"{rec_total('control.respecialize')}, pool shrink "
          f"{rec_total('control.pool.shrink')}, grow {rec_total('control.pool.grow')}")
    for name, reports in runs.items():
        walls = [x.wall_ms for x in reports]
        print(f"9b {name}: request wall first {walls[0]:.2f} ms, median of the rest "
              f"{float(np.median(walls[1:])):.2f} ms, all exact, on {smi}")
    del lad, el

    print(f"9c main path's entry bound: entries in {{0..{ENTRY_MAX}}}, L={MAIN.L} "
          f"(reported, not gated)")
    A, B = ints(0, ENTRY_MAX, (v, r)), ints(0, ENTRY_MAX, (v, t))
    lad = ladder(MAIN.L)
    reports = adaptive_run("9c heavy_tail", lad, A, B, make_scenario("heavy_tail"), 10,
                           counts, seed=seed, gated=False)
    inexact = [(x.step, x.rung, list(x.erased)) for x in reports if not x.exact]
    print(f"9c inexact steps (step, rung, erased): {inexact}")
    obs.disable()
    del A, B, lad
    gc.collect()
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = torch_control_bench.run("all", "fused", "cuda")
    got = launch_counts()
    for line in torch_control_bench.rows_text(result):
        print(f"bench {line}")
    torch_control_bench.check(result)
    obs.disable()
    for k, n in got.items():
        counts[k] += n
    print(f"control bench (fused, cuda) check OK in {time.perf_counter() - t0:.1f} s, "
          f"launches {nonzero(got)}")
    print(f"phase 9: {time.perf_counter() - start:.1f} s, launches {nonzero(counts)}")
    return {"counts": counts}


def golden_serve_phase(counts: dict) -> None:
    """10a: the golden serve trace through the kernels; the diff against the
    checked-in file must be empty, every batch exact, and every admitted
    product bit-identical to a fresh synchronous facade call."""
    golden = ServeTrace.load(GOLDEN_DIR / "serve_heavy_tail.jsonl")
    make_A, B = golden_operands("cuda")
    for backend in ("fused", "staged"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = golden_serve_result(device="cuda", backend=backend)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = launch_counts()
        for k, v in got.items():
            counts[k] += v
        trace = with_golden_meta(ServeTrace.from_result(result))
        diff = trace.diff(golden)
        check(diff == [] and trace.meta == golden.meta,
              f"10a {backend}: the serve trace differs from the golden file: {diff[:3]}")
        check(all(b.report["exact"] for b in result.batches), f"10a {backend}: inexact batch")
        cm = PlanLadder(*GOLDEN_GRID, K=GOLDEN_K, L=GOLDEN_L, backend=backend,
                        device="cuda").facade("bec")
        check(all(torch.equal(cm(make_A(rec), B), result.results[rec.rid])
                  for rec in result.completed),
              f"10a {backend}: a product differs from the synchronous facade's")
        print(f"10a {backend:<6} serve_heavy_tail: {len(result.requests)} requests, "
              f"{len(result.batches)} batches, diff [], meta equal, all exact, every product "
              f"bit-identical to the facade, {seconds:.2f} s, launches {nonzero(got)}")


class BatchProbe:
    """The kernel launches and host-clock decision time of each batch a
    ``ServeTier`` dispatches.  Every dispatch calls its class server's
    ``begin_step`` once, just before its facade calls: the probe wraps it to
    note the launch counts and time the decision."""

    def __init__(self, tier):
        self.marks = []
        for server in tier.servers.values():
            server.begin_step = self._timed(server.begin_step)

    def _timed(self, begin):
        def timed():
            before = launch_counts()
            t0 = time.perf_counter()
            decision = begin()
            self.marks.append((before, (time.perf_counter() - t0) * 1e3))
            return decision
        return timed

    def launches(self) -> list:
        """Each batch's launches, in dispatch order."""
        snaps = [m[0] for m in self.marks] + [launch_counts()]
        return [{k: b[k] - a[k] for k in a} for a, b in zip(snaps, snaps[1:])]


def panel_gain(ladder, rung: str, report: dict) -> float:
    """The decode panel's gain (max row sum of |W|) for a batch's erasure, or
    the largest over its chunks' panels for a progress vector."""
    cache = ladder.facade(rung).panel_cache
    if report["progress"] is not None:
        masks = PartialPattern.from_progress(ladder.K, Q_SUB, report["progress"]).chunk_masks
    else:
        masks = [cm_mask(ladder.plan(rung), list(report["erased"]))]
    return max(float(np.abs(cache.get(m).W).sum(1).max()) for m in masks)


def tier_run(label: str, ladder, initial: str, scenario: str, seed: int, operands,
             counts: dict, **kw) -> dict:
    """One ``ServeTier`` run of DEFAULT_SPEC over ``ladder``: every batch exact,
    launching ``bucket`` of the worker and the decode kernel, and every product
    bit-identical to a synchronous facade call at its batch's rung and erasure."""
    make_A, B = operands
    classes, tenants = parse_tenant_spec(DEFAULT_SPEC)
    ladder.switch(initial)  # the shared ladder starts each run on one rung
    tier = ServeTier(ladder, classes=tuple(classes.values()),
                     tenants=tuple(tenants.values()),
                     feed=make_scenario(scenario).compile(ladder.K, seed=seed),
                     overhead_s=GOLDEN_SERVE_OVERHEAD_S, seed=seed, check_exact=True,
                     keep_results=True, **kw)
    probe = BatchProbe(tier)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = tier.run(make_A, B, TIER_REQUESTS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    for k, v in launch_counts().items():
        counts[k] += v
    walls = {rep.span_id: rep.wall_ms for server in tier.servers.values()
             for rep in server.reports}
    decode = "decode_partial" if kw.get("sub_tasks", 1) > 1 else "decode"
    batch_walls = []
    for b, got, (_, begin_ms) in zip(result.batches, probe.launches(), probe.marks):
        wall = walls[b.report["span_id"]]
        batch_walls.append(wall)
        what = (f"progress {[round(x, 2) for x in b.report['progress']]}"
                if b.report["progress"] is not None else f"erased {list(b.report['erased'])}")
        print(f"10b {label} batch {b.index:>2}: {b.slo_class:<8} {b.rung:<14} size {b.size} "
              f"bucket {b.bucket} {what} panel gain {panel_gain(ladder, b.rung, b.report):.1f} "
              f"wall {wall:.2f} ms begin_step {begin_ms:.3f} ms exact {b.report['exact']} "
              f"launches {nonzero(got)}")
        want = dict.fromkeys(got, 0) | {"fused_worker": b.bucket, decode: b.bucket}
        check(got == want, f"10b {label} batch {b.index} launched {got}, not {want}")
        check(b.report["exact"], f"10b {label} batch {b.index}: C differs from A^T B")
    check(len(probe.marks) == len(result.batches), f"10b {label}: batches and decisions differ")
    for rec in result.completed:
        b = result.batches[rec.batch_index]
        cm = ladder.facade(b.rung)
        if b.report["progress"] is not None:
            C = cm(make_A(rec), B, progress=b.report["progress"], sub_tasks=Q_SUB)
        else:
            C = cm(make_A(rec), B, erased=list(b.report["erased"]))
        check(torch.equal(C, result.results[rec.rid]), f"10b {label} request {rec.rid}: "
              f"the product differs from the synchronous facade's")
    done = len(result.completed)
    print(f"10b {label}: {len(result.requests)} arrivals, {len(result.admitted)} admitted, "
          f"{len(result.shed)} shed, {len(result.batches)} batches; run wall {wall_s:.3f} s "
          f"({done / wall_s:.2f} completions/s), batch walls sum {sum(batch_walls):.1f} ms "
          f"({done / (sum(batch_walls) * 1e-3):.2f} completions/s); simulated "
          f"{result.throughput_rps():.4f} req/s; every product bit-identical to the facade")
    return {"stats": result.tenant_stats(), "begin_ms": [m[1] for m in probe.marks]}


def serve_tier_phase(seed: int, smi: str, counts: dict) -> None:
    """10b: the serve CLI's tier geometry at v = 8000 on fused kernels: the
    pipelined tier, the back-to-back baseline, and a sub_tasks=4 run, on one
    ladder with no pipeline build after prewarm."""
    v = PAPER.v
    r = t = v // 2
    L = bounds.conservative_L(v, TIER_ENTRY, TIER_ENTRY)
    obs.enable(fresh=True)
    torch.cuda.reset_peak_memory_stats()
    ladder = PlanLadder(*TIER_GRID, K=TIER_K, L=L, backend="fused", device="cuda")
    initial = ladder.active
    t0 = time.perf_counter()
    ladder.prewarm((v, r), (v, t), batch_sizes=TIER_BUCKETS, sub_tasks=Q_SUB, stages=True)
    print(f"10b tier geometry: v={v} r=t={r}, grid {TIER_GRID}, K={TIER_K}, float64, "
          f"entries in [-{TIER_ENTRY}, {TIER_ENTRY}], L={L} "
          f"s=2^{int(np.log2(ladder.plan(initial).s))}, chebyshev points, fused kernels, "
          f"buckets {TIER_BUCKETS}: "
          + ", ".join(f"{x} tau {ladder.tau(x)} feasible {ladder.feasible(x)}"
                      for x in ladder.rungs)
          + f"; prewarm {time.perf_counter() - t0:.1f} s, {ladder.cache_info()['builds']} "
          f"pipelines")
    check([ladder.feasible(x) for x in ladder.rungs] == [False, True, True],
          f"10b rungs {ladder.rungs}: bec must be the one infeasible rung")
    watch = CompileWatch()
    watch.mark()
    rec = obs.session().recorder
    kernels = ("fused_worker", "decode", "decode_partial")
    spans_before = {op: len(rec.by_name(f"kernel.{op}")) for op in kernels}
    operands = coded_serve.serve_tier_operands(seed, 3 * 64, ((v, r), (v, t)), "cuda")
    runs = {}
    for label, scenario, kw in (("tier", "heavy_tail", {}),
                                ("baseline", "heavy_tail", dict(max_batch=1, pipelined=False)),
                                ("sub_tasks=4", "crawler", dict(sub_tasks=Q_SUB))):
        runs[label] = tier_run(label, ladder, initial, scenario, seed, operands, counts, **kw)
    builds = watch.delta()
    check(builds == 0, f"10b: {builds} pipeline build(s) after prewarm")
    print(f"10b peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"no pipeline build after prewarm across the three runs")
    begin = [x for run in runs.values() for x in run["begin_ms"]]
    print(f"10b control.begin_step host time (probe, host clock): median "
          f"{float(np.median(begin)):.3f} ms over {len(begin)} batches, max {max(begin):.3f} ms")
    print("10b kernel device time per launch in the three runs and their facade checks "
          "(kernel.* spans, CUDA events): " + ", ".join(
              f"{op} median {np.median(d) * 1e3:.3f} ms ({len(d)} launches)"
              for op in kernels
              if (d := [x.duration_s for x in rec.by_name(f"kernel.{op}")[spans_before[op]:]])))
    print("10b serve spans " + ", ".join(
        f"{name} {len(rec.by_name(name))}"
        for name in ("serve.dispatch", "serve.worker_stage", "serve.decode_stage"))
        + f"; counters serve.admit {rec_total('serve.admit')}, serve.shed "
        f"{rec_total('serve.shed')}, serve.batch {rec_total('serve.batch')}")
    print(f"10b simulated tenant table (tier | baseline), on {smi}:")
    for name, st in runs["tier"]["stats"].items():
        sides = []
        for side in ("tier", "baseline"):
            x = runs[side]["stats"][name]
            sides.append(f"p50 {x['p50_s']:.3f} s p_slo {x['p_slo_s']:.3f} s met "
                         f"{x['slo_met']} shed {x['shed']} {x['shed_reasons']}")
        print(f"  {name:<7} {st['slo_class']:<8} slo {st['slo_s']} s: {sides[0]} | {sides[1]}")
    obs.disable()
    del ladder, operands
    gc.collect()
    torch.cuda.empty_cache()


def cli(args: list, counts: dict) -> tuple:
    """``coded_serve.main(args)`` on the card, its printed lines echoed."""
    buf = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = coded_serve.main(args + ["--device", "cuda"])
    torch.cuda.synchronize()
    got = launch_counts()
    for k, v in got.items():
        counts[k] += v
    text = buf.getvalue()
    print(f"10c coded_serve {' '.join(args)}: {time.perf_counter() - t0:.1f} s, "
          f"launches {nonzero(got)}")
    for line in text.splitlines():
        print(f"  | {line}")
    return out, text


def cli_phase(counts: dict) -> None:
    """10c: the serving CLI's modes in-process on the card, then the serve
    bench twin's gates on the fused kernels."""
    out, text = cli(["--serve-tier", "--size", str(PAPER.v), "--scenario", "heavy_tail",
                     "--requests", "4"], counts)
    check("unchanged since prewarm" in text and out.batches
          and all(b.report["exact"] for b in out.batches),
          "10c --serve-tier at 8000: a batch is inexact or a pipeline was built")
    # the CLI's ladder, rebuilt on the host for its decode panels' gains
    panels = PlanLadder(*TIER_GRID, K=TIER_K, L=bounds.conservative_L(
        PAPER.v, TIER_ENTRY, TIER_ENTRY), device="cpu")
    print("10c --serve-tier at 8000, every batch exact: " + ", ".join(
        f"{b.rung} size {b.size} erased {list(b.report['erased'])} gain "
        f"{panel_gain(panels, b.rung, b.report):.1f}" for b in out.batches))
    del out
    for backend in ("fused", "staged"):
        _, text = cli(["--backend", backend, "--requests", "6"], counts)
        lines = [x for x in text.splitlines() if x.startswith("req ")]
        check(len(lines) == 6 and all(x.endswith("exact") for x in lines)
              and " 1 executable(s)" in text,
              f"10c --backend {backend}: not every request exact on one pipeline")
    for args in (["--adaptive", "--requests", "12", "--size", "64", "--batch", "6",
                  "--slo-quantile", "0.99", "--slo-ms", "1800"],
                 ["--adaptive", "--scenario", "crawler", "--sub-tasks", str(Q_SUB),
                  "--size", "64"]):
        reports, text = cli(args, counts)
        check("unchanged since prewarm" in text and reports and all(x.exact for x in reports),
              f"10c {' '.join(args)}: a step is inexact or a pipeline was built")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = torch_serve_bench.run(list(torch_serve_bench.CHECK_SCENARIOS), "fused", "cuda")
    got = launch_counts()
    for line in torch_serve_bench.rows_text(result):
        print(f"bench {line}")
    torch_serve_bench.check(result)
    obs.disable()
    for k, n in got.items():
        counts[k] += n
    print(f"serve bench (fused, cuda) check OK in {time.perf_counter() - t0:.1f} s, "
          f"launches {nonzero(got)}")


def serve_phase(seed: int, smi: str) -> dict:
    """The multi-tenant serve tier (``repro_torch.serve``) and the serving CLI
    on the card: the golden serve trace (10a), the CLI's tier geometry at
    v = 8000 (10b) and the CLI's modes with the bench twin (10c)."""
    phase("10 serve tier and the coded_serve CLI")
    start = time.perf_counter()
    counts = dict.fromkeys(launch_counts(), 0)
    golden_serve_phase(counts)
    serve_tier_phase(seed, smi, counts)
    cli_phase(counts)
    print(f"phase 10: {time.perf_counter() - start:.1f} s, launches {nonzero(counts)}")
    return {"counts": counts}


def bit_digest(x: torch.Tensor) -> tuple:
    """Two wrap-around int64 sums over the bits of ``x``: equal digests mean
    equal bits (with overwhelming probability; -0.0 differs from 0.0), and
    the sums do not depend on the order the card adds in."""
    bits = x.contiguous().view(torch.int64)
    return int(bits.sum()), int((bits * bits).sum())


def mesh_operands(seed: int) -> tuple:
    """Phase 11's A and B (the main path's geometry and entries) from the
    card's own generator, the same on every rank of the one card."""
    gen = torch.Generator(device="cuda").manual_seed(seed + MESH_SEED)
    A = torch.randint(0, ENTRY_MAX + 1, (V, R), generator=gen, device="cuda",
                      dtype=torch.float64)
    B = torch.randint(0, ENTRY_MAX + 1, (V, T), generator=gen, device="cuda",
                      dtype=torch.float64)
    return A, B


def mesh_requests(cm, staged, A, B) -> list:
    """Phase 11's requests ``[(kind, name, call, launches per request)]``:
    fused binary under phase 4's erasures and fused partial under phase
    4c's progress vectors on ``cm``, one binary request on ``staged``, then
    one "traced" and one ("partial-traced", Q) request on ``cm``: the mask
    and the progress as device tensors in patterns of the traced kind, so
    no host reads them and the panels are solved on the card."""
    K = cm.plan.K
    mask = torch.as_tensor(cm_mask(cm.plan, ERASURES[1]), device="cuda")
    progress = torch.as_tensor(np.asarray(PROGRESS[1]) / Q_SUB, device="cuda")
    return ([("fused", f"erased={e}", lambda e=e: cm(A, B, erased=e),
              {"fused_worker": 1, "decode": 1}) for e in ERASURES]
            + [("partial", f"progress={c}/{Q_SUB}",
                lambda c=c: cm(A, B, progress=np.asarray(c) / Q_SUB, sub_tasks=Q_SUB),
                {"fused_worker": 1, "decode_partial": 1}) for c in PROGRESS]
            + [("staged", f"erased={ERASURES[0]}",
                lambda: staged(A, B, erased=ERASURES[0]),
                {"encode": 2, "matmul_t": 1, "decode": 1}),
               ("traced", f"traced erased={ERASURES[1]}",
                lambda: cm(A, B, ErasurePattern(K, "traced", mask)),
                {"fused_worker": 1, "decode": 1}),
               ("partial-traced", f"traced progress={PROGRESS[1]}/{Q_SUB}",
                lambda: cm(A, B, PartialPattern(K, Q_SUB, "traced", progress)),
                {"fused_worker": 1, "decode_partial": 1})])


def span_ms(spans, *names) -> float:
    return sum(x.duration_s for x in spans if x.name in names) * 1e3


def mesh_rank(mesh, seed: int, digests: dict) -> dict:
    """Phase 11 on one rank (every rank runs it): the requests through
    ``CodedMatmul(plan, "mesh")``, each C checked on the rank against A^T B
    and against the digest of the local fused facade's C; the launches of
    each request and the pipeline builds gated.  Obs is on, so each kernel
    call carries its CUDA-event span and the gather its host-clock span."""
    import torch.distributed as dist

    A, B = mesh_operands(seed)
    C_ref = A.T @ B
    plan = make_plan("bec", MAIN.p, MAIN.m, MAIN.n, K=MAIN.K, L=MAIN.L,
                     points=MAIN.points)
    cm = CodedMatmul(plan, "mesh", mesh=mesh)
    rank = dist.get_rank()
    rec = obs.enable(fresh=True).recorder
    rows, kinds, card_used = [], set(), None
    staged = cm.with_backend("mesh", fused=False)      # the same caches
    for i, (kind, name, call, want) in enumerate(mesh_requests(cm, staged, A, B)):
        builds = cm.cache_info()["builds"]
        before, n_spans = launch_counts(), len(rec.spans)
        dist.barrier()
        t0 = time.perf_counter()
        C = call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        dist.barrier()
        after = launch_counts()
        steps = {k: after[k] - before[k] for k in after}
        check(steps == dict.fromkeys(after, 0) | want,
              f"11 rank {rank} {kind} {name}: launched {steps}, not {want}")
        check(torch.equal(C, C_ref), f"11 rank {rank} {kind} {name}: max |C - A^T B| = "
              f"{float((C - C_ref).abs().max())}")
        check(bit_digest(C) == digests[(kind, name)],
              f"11 rank {rank} {kind} {name}: C is not bit-identical to the local fused C")
        grew = cm.cache_info()["builds"] - builds
        check(grew == (kind not in kinds), f"11 rank {rank} {kind} {name}: {grew} builds")
        kinds.add(kind)
        spans = rec.spans[n_spans:]
        rows.append(dict(kind=kind, name=name, wall_ms=wall,
                         product_ms=span_ms(spans, "kernel.fused_worker", "kernel.encode",
                                            "kernel.matmul_t"),
                         gather_ms=span_ms(spans, "mesh.all_gather"),
                         decode_ms=span_ms(spans, "kernel.decode", "kernel.decode_partial"),
                         launches={k: v for k, v in steps.items() if v}))
        del C
        if card_used is None:
            free, total = torch.cuda.mem_get_info()
            card_used = (total - free) / 2**30
    obs.disable()
    return {"rows": rows, "transport": cm._executor.transport,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "card_used_gib": card_used, "cache": cm.cache_info()}


def mesh_phase(seed: int, smi: str) -> dict:
    """11: ten ranks on the one card, one coded worker each, over gloo."""
    phase("11 mesh: ten ranks on one card")
    start = time.perf_counter()
    A, B = mesh_operands(seed)
    C_ref = A.T @ B
    plan = make_plan("bec", MAIN.p, MAIN.m, MAIN.n, K=MAIN.K, L=MAIN.L,
                     points=MAIN.points)
    local = CodedMatmul(plan)
    digests = {}
    # every request, the staged one too, is held against the local fused C
    for kind, name, call, _ in mesh_requests(local, local, A, B):
        C = call()
        check(torch.equal(C, C_ref), f"11 local fused {name}: inexact")
        digests[(kind, name)] = bit_digest(C)
        del C
    del A, B, C_ref, local
    gc.collect()
    torch.cuda.empty_cache()
    print(f"local fused facade: {len(digests)} patterns exact, digests taken; spawning "
          f"{MAIN.K} ranks on {torch.cuda.device_count()} card(s)", flush=True)
    outs = spawn_mesh(mesh_rank, data=1, model=MAIN.K, device="cuda",
                      args=(seed, digests), timeout_s=MESH_TIMEOUT_S)
    check(len(outs) == MAIN.K, f"11: {len(outs)} ranks answered")
    first = outs[0].result
    print(f"mesh (1, {MAIN.K}) over {first['transport']}: every rank's C exact and "
          f"bit-identical to the local fused C; pipeline cache {first['cache']}")
    for i, row in enumerate(first["rows"]):
        rest = row["wall_ms"] - row["product_ms"] - row["gather_ms"] - row["decode_ms"]
        print(f"11 rank 0 {row['kind']} request {i} {row['name']}: wall {row['wall_ms']:.2f} "
              f"ms = product {row['product_ms']:.2f} + gather {row['gather_ms']:.2f} + "
              f"decode {row['decode_ms']:.3f} + other {rest:.2f} ms; launches "
              f"{row['launches']}; on {smi}")
    for kind in ("fused", "partial", "staged", "traced", "partial-traced"):
        walls = [r["wall_ms"] for r in first["rows"] if r["kind"] == kind]
        print(f"11 {kind} walls (rank 0): {[round(w, 2) for w in walls]} ms")
    print(f"11 peak device memory per rank (GiB): "
          f"{[round(o.result['peak_gib'], 3) for o in outs]}; the card's used memory "
          f"after the first request (rank 0's view) {first['card_used_gib']:.2f} GiB")
    counts = {k: sum(o.launches[k] for o in outs) for k in outs[0].launches}
    print(f"phase 11: {time.perf_counter() - start:.1f} s, launches over the "
          f"{MAIN.K} ranks {nonzero(counts)}")
    return {"counts": counts}


def ep_rank(mesh, params, x, x_dec, cf_cfg, cfg_full):
    """13a on one rank: the expert layer's EP path on this rank's shards of
    the parent's weights and tokens (CUDA IPC views, no copies), at no drops
    (capacity_factor E/k) and at the config's own; returns rank 0's whole
    outputs, each rank's time split, kept share and peak memory."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.sharding import axis_rules, default_rules
    torch.backends.cuda.matmul.allow_tf32 = False
    rules = default_rules(mesh)
    E = params["w_gate"].shape[0]
    ep = mesh.size(1)
    e0, e1 = mesh.get_local_rank("model") * (E // ep), (mesh.get_local_rank("model") + 1) * (E // ep)
    local = {"router": DTensor.from_local(params["router"], mesh, [Replicate(), Replicate()],
                                          run_check=False)}
    for name in ("w_gate", "w_up", "w_down"):
        local[name] = DTensor.from_local(params[name][e0:e1], mesh, [Replicate(), Shard(0)],
                                         run_check=False)
    torch.cuda.reset_peak_memory_stats()
    out = {}
    with torch.inference_mode(), axis_rules(rules):
        for label, mc in (("no drops", cf_cfg), ("config", cfg_full.moe)):
            with moe_mod.ep_timing() as split:
                y, aux = apply_moe(local, x, mc)
                torch.cuda.synchronize()
            with moe_mod.ep_timing() as dec_split:
                y_dec, _ = apply_moe(local, x_dec, mc)
                torch.cuda.synchronize()
            # timed again, off the first call's set-up
            with moe_mod.ep_timing() as timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                apply_moe(local, x, mc)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            out[label] = {"y": y.cpu() if mesh.get_rank() == 0 else None,
                          "y_dec": y_dec.cpu() if mesh.get_rank() == 0 else None,
                          "aux": float(aux), "kept": split["kept"], "slots": split["slots"],
                          "dec_kept": dec_split["kept"], "dec_slots": dec_split["slots"],
                          "wall_ms": wall * 1e3, "a2a_ms": timed["all_to_all"] * 1e3,
                          "experts_ms": timed["experts"] * 1e3}
            del y, y_dec
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # drop this rank's references to the parent's weights (the spawn holds
    # the dict too): the parent's card memory is freed only after every
    # rank has released what it received through CUDA IPC
    del local
    params.clear()
    gc.collect()
    return out


def ep_phase(seed: int, smi: str) -> dict:
    """13a: Jamba-1.5-Large's expert layer at full width, expert-parallel on
    a (1, 4) mesh of four ranks sharing the card over gloo (4 of the 16
    experts a rank), on 6h's 4 x 1024 prefill tokens (sequence-sharded four
    ways) and a 4-token decode batch.  At capacity_factor E/k (no drops) it
    is held against ``_moe_dense`` on the same tokens, computed here before
    the ranks start; at the config's 1.25 the dropped share is printed.  The
    all_to_all runs over gloo through host memory: a stand-in for NCCL."""
    phase("13a Jamba-1.5-Large expert layer, expert-parallel on four ranks")
    start = time.perf_counter()
    full = get_config("jamba_1_5_large_398b")
    mc, d = full.moe, full.d_model
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_moe(gen, d, mc, ep_size=full.tp_pad, dtype=full.param_dtype)
    E = params["w_gate"].shape[0]
    xgen = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn((LM_BATCH, LM_PROMPT, d), generator=xgen, device="cuda",
                    dtype=full.param_dtype)
    x_dec = torch.randn((LM_BATCH, 1, d), generator=xgen, device="cuda",
                        dtype=full.param_dtype)
    no_drop = dataclasses.replace(mc, capacity_factor=E / mc.top_k)
    with torch.inference_mode():
        dense, _ = moe_mod._moe_dense(params, x, mc)
        dense_dec, _ = moe_mod._moe_dense(params, x_dec, mc)
    dense, dense_dec = dense.cpu(), dense_dec.cpu()
    gc.collect()
    torch.cuda.empty_cache()
    n_bytes = sum(p.numel() * p.element_size() for p in params.values())
    print(f"13a: {E} experts top-{mc.top_k}, d {d}, d_ff {mc.d_expert_ff}, "
          f"{n_bytes / 1e9:.2f} GB bf16 from seed {seed}; dense reference computed and "
          f"moved to the host; spawning (1, {EP_RANKS}) ranks on the card", flush=True)
    outs = spawn_mesh(ep_rank, data=1, model=EP_RANKS, device="cuda",
                      args=(params, x, x_dec, no_drop, full), timeout_s=EP_TIMEOUT_S)
    first = outs[0].result
    res = {}
    for label in ("no drops", "config"):
        r = first[label]
        kept = sum(o.result[label]["kept"] for o in outs)
        slots = sum(o.result[label]["slots"] for o in outs)
        dec_kept = sum(o.result[label]["dec_kept"] for o in outs)
        dec_slots = sum(o.result[label]["dec_slots"] for o in outs)
        rel = lm_rel(r["y"].float(), dense.float())
        rel_dec = lm_rel(r["y_dec"].float(), dense_dec.float())
        cf = no_drop.capacity_factor if label == "no drops" else mc.capacity_factor
        print(f"13a capacity_factor {cf}: prefill {LM_BATCH}x{LM_PROMPT} tokens wall "
              f"{r['wall_ms']:.2f} ms (rank 0) = all_to_all over gloo (host-staged stand-in, "
              f"not NCCL) {r['a2a_ms']:.2f} ms + expert products {r['experts_ms']:.2f} ms + "
              f"routing and scatter {r['wall_ms'] - r['a2a_ms'] - r['experts_ms']:.2f} ms; "
              f"token-slots kept {kept}/{slots} ({1 - kept / slots:.3%} dropped), decode "
              f"{dec_kept}/{dec_slots}; against _moe_dense: prefill rel {rel:.3e}, decode rel "
              f"{rel_dec:.3e}; aux {r['aux']:.4f}; on {smi}")
        if label == "no drops":
            check(kept == slots and dec_kept == dec_slots,
                  f"13a dropped tokens at capacity_factor E/k: {kept}/{slots}")
            check(rel <= MOE_TOL and rel_dec <= MOE_TOL,
                  f"13a EP against _moe_dense: rel {rel}, decode {rel_dec}")
        res[label] = {"wall_ms": r["wall_ms"], "a2a_ms": r["a2a_ms"],
                      "experts_ms": r["experts_ms"], "dropped": 1 - kept / slots, "rel": rel}
    peaks = [round(o.result["peak_gib"], 3) for o in outs]
    print(f"13a peak device memory per rank (GiB, the shared weights not counted): {peaks}")
    counts = {k: sum(o.launches[k] for o in outs) for k in outs[0].launches}
    check(not any(counts.values()), f"13a launched {counts}")
    del params, x, x_dec
    gc.collect()
    # the ranks got the weights through CUDA IPC: their 18 GiB stay allocated
    # here until the sender collects what the ranks released
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    print(f"phase 13a: {time.perf_counter() - start:.1f} s; {torch.cuda.memory_allocated() / 2**30:.3f} "
          f"GiB still allocated here")
    return {"counts": counts, **res}


def sharded_cfgs() -> list:
    """13b's configs: (label, config, kernel)."""
    def f32(cfg, **kw):
        return dataclasses.replace(cfg, dtype="float32", **kw)
    qwen = get_config("qwen3_0_6b")
    rwkv = get_config("rwkv6_3b")
    jamba = get_smoke_config("jamba_1_5_large_398b")
    return [
        (f"qwen3_0_6b {SHARDED_QWEN_LAYERS}/{qwen.n_layers} layers",
         f32(qwen, n_layers=SHARDED_QWEN_LAYERS), None),
        (f"rwkv6_3b {SHARDED_RWKV_LAYERS}/{rwkv.n_layers} layers",
         f32(rwkv, n_layers=SHARDED_RWKV_LAYERS, rwkv_kernel=True), "wkv_scan"),
        ("jamba SMOKE + EP", f32(jamba, mamba_kernel=True, aux_coef=0.0), "mamba_scan"),
    ]


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (partial sums reduced), a tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def step_grads(params, cfg, data: dict, rules) -> dict:
    """Each parameter's gradient of the train loss on ``data``, whole and on
    the host, computed as ``make_train_step`` computes it (the batch placed
    by the rules on a mesh)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.launch.steps import place_batch
    with axis_rules(rules), (implicit_replication() if rules is not None
                             else contextlib.nullcontext()):
        batch = place_batch(cfg, data, rules, "train")
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        grads = torch.autograd.grad(train_loss(params, cfg, batch), list(named.values()))
        return {n: whole(g).detach().cpu() for n, g in zip(named, grads)}


def sharded_step(cfg, seed: int, mesh, steps: int, device="cuda"):
    """``steps`` train steps of ``cfg`` (on ``mesh`` when given), on
    4 x ``SHARDED_SEQ`` tokens from make_pipeline, after the gradients of
    step 0's batch taken alone (which also warm the step's path up):
    {"loss": of step 0, "grad_norm": of step 0, "grads": the gradients,
    "params": the parameters after step 0 (both on the host), "wall": of
    the last step, "peak_gib"}."""
    from repro_torch.distributed.param_sharding import shard_params
    from repro_torch.distributed.sharding import default_rules
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    rules = None if mesh is None else default_rules(mesh)
    params = init_params(cfg, seed=seed, device=device)
    if rules is not None:
        shard_params(params, rules)
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, OptConfig(lr=3e-4, warmup_steps=1, total_steps=10), rules)
    pipe = make_pipeline(cfg.vocab, SHARDED_SEQ, LM_BATCH, seed=seed)
    out = {"grads": step_grads(params, cfg, to_batch(cfg, pipe.batch(0), device), rules)}
    for t in range(steps):
        data = to_batch(cfg, pipe.batch(t), device)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, data)
        loss = float(metrics["loss"])
        out["wall"] = time.perf_counter() - t0
        if t == 0:
            out |= {"loss": loss, "grad_norm": float(metrics["grad_norm"]),
                    "params": {n: whole(p).detach().cpu()
                               for n, p in params.named_parameters()}}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    return out


def sharded_rank(mesh, cfgs, seed: int, device="cuda"):
    """13b on one rank, for each config in turn (one spawn for all: a spawn
    costs more than a step): the gradients and one step on the (2, 2) mesh,
    with the launch counts set to 0 just before each config and read just
    after; rank 0 hands back the gradients and the parameters after the
    step."""
    outs = []
    for cfg in cfgs:
        ops.reset_launch_counts()
        out = sharded_step(cfg, seed, mesh, 1, device)
        launches = launch_counts()
        if mesh.get_rank() != 0:
            out["grads"] = out["params"] = None
        outs.append(out | {"launches": launches})
        del out
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return outs


def sharded_compare(mesh_out: dict, single: dict) -> dict:
    """13b's comparisons of a mesh run (rank 0) with the one-device run:
    the loss and the gradient norm (relative), each gradient leaf (largest
    |difference| over its largest |gradient|) and each parameter after the
    step (largest |difference|), the worst leaf named."""
    def worst(errs):
        return max((e, n) for n, e in errs.items())
    rel_g = {n: float((mesh_out["grads"][n] - g).abs().max())
             / max(float(g.abs().max()), 1e-30) for n, g in single["grads"].items()}
    diff_p = {n: float((mesh_out["params"][n] - p).abs().max())
              for n, p in single["params"].items()}
    return {"loss_rel": abs(mesh_out["loss"] - single["loss"]) / abs(single["loss"]),
            "norm_rel": abs(mesh_out["grad_norm"] - single["grad_norm"]) / single["grad_norm"],
            "grad": worst(rel_g), "param": worst(diff_p)}


def sharded_train_phase(seed: int, smi: str) -> dict:
    """13b: one train step on a (2, 2) mesh of four ranks sharing the card
    (FSDP + TP + EP by the reference's rules, over gloo), held against the
    single-device step on the card: loss within 1e-4 relative, every
    parameter within 1e-2 (the reference's TestShardedTraining bounds), and
    the gradients (which one AdamW step at lr 3e-4 cannot show: it moves a
    parameter by about lr * sign(g)): their norm within 1e-4 relative and
    every leaf within 1e-3 of its largest |gradient|."""
    phase("13b sharded train steps on a (2, 2) mesh")
    start = time.perf_counter()
    out = {}
    cfgs = sharded_cfgs()
    singles = []
    for _, cfg, _ in cfgs:
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        singles.append((sharded_step(cfg, seed, None, 1), launch_counts()))
    gc.collect()
    torch.cuda.empty_cache()
    outs = spawn_mesh(sharded_rank, data=2, model=2, device="cuda",
                      args=([cfg for _, cfg, _ in cfgs], seed), timeout_s=SHARDED_TIMEOUT_S)
    counts = {k: sum(r["launches"].get(k, 0) for o in outs for r in o.result)
              for k in KERNELS}
    for i, (label, cfg, kernel) in enumerate(cfgs):
        single, single_launches = singles[i]
        r0 = outs[0].result[i]
        c = sharded_compare(r0, single)
        per_rank = [o.result[i]["launches"].get(kernel, 0) for o in outs] if kernel else []
        print(f"13b {label}: {LM_BATCH}x{SHARDED_SEQ} tokens, float32; loss mesh "
              f"{r0['loss']:.6f} vs one device {single['loss']:.6f} (rel {c['loss_rel']:.3e}, "
              f"bound {TRAIN_LOSS_TOL}); gradient norm {r0['grad_norm']:.6e} vs "
              f"{single['grad_norm']:.6e} (rel {c['norm_rel']:.3e}, bound "
              f"{SHARDED_GRAD_NORM_TOL}); worst gradient leaf rel {c['grad'][0]:.3e} "
              f"({c['grad'][1]}; bound {SHARDED_GRAD_TOL}); worst parameter |diff| "
              f"{c['param'][0]:.3e} ({c['param'][1]}; bound {SHARDED_PARAM_TOL}); step wall "
              f"(after the gradients' pass) mesh {r0['wall'] * 1e3:.2f} ms (rank 0) vs one "
              f"device "
              f"{single['wall'] * 1e3:.2f} ms; peak memory per rank (GiB) "
              f"{[round(o.result[i]['peak_gib'], 2) for o in outs]} vs {single['peak_gib']:.2f}; "
              f"{kernel or 'no kernel'} launches per rank {per_rank} (one device "
              f"{single_launches.get(kernel, 0) if kernel else 0}; gradients + 1 step); "
              f"on {smi}")
        check(c["loss_rel"] <= TRAIN_LOSS_TOL, f"13b {label}: loss rel {c['loss_rel']}")
        check(c["norm_rel"] <= SHARDED_GRAD_NORM_TOL,
              f"13b {label}: gradient norm rel {c['norm_rel']}")
        check(c["grad"][0] <= SHARDED_GRAD_TOL,
              f"13b {label}: gradient {c['grad'][1]} rel {c['grad'][0]}")
        check(c["param"][0] <= SHARDED_PARAM_TOL,
              f"13b {label}: parameter {c['param'][1]} by {c['param'][0]}")
        if kernel:
            check(all(n > 0 for n in per_rank), f"13b {label}: {kernel} per rank {per_rank}")
        out[label] = {"mesh_ms": r0["wall"] * 1e3, "single_ms": single["wall"] * 1e3,
                      "rel": c["loss_rel"], "norm_rel": c["norm_rel"], "grad": c["grad"][0],
                      "worst": c["param"][0], "peaks": [o.result[i]["peak_gib"] for o in outs],
                      "per_rank": per_rank}
    del singles, outs
    print(f"phase 13b: {time.perf_counter() - start:.1f} s, launches over the ranks "
          f"{nonzero(counts)}")
    return {"counts": counts, **out}


# ---------------------------------------------------------------------------
# phase 14: the dry run's accounting on the card


def dryrun_trace(arch: str, shape, cfg, mesh_shape, device: str) -> dict:
    """One of phase 14's traces, run in a child process: ``trace_cell`` on
    fake tensors of ``device`` (on one device for ``mesh_shape=()``, else
    the production mesh of fake ranks; the fake process group is the
    child's)."""
    from repro_torch.launch.dryrun import trace_cell
    return trace_cell(arch, shape, cfg=cfg, mesh_shape=mesh_shape, device=device)


def accounted_train_step(label: str, cfg, seed: int) -> dict:
    """One real train step of 12b/12c's shapes under the accounting, after
    ``reset_peak_memory_stats``: its stats, the peak it allocated above what
    was already held, its launches."""
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=seed, device=CARD)
    opt_state = adamw_init(params)
    data = to_batch(cfg, make_pipeline(cfg.vocab, LM_PROMPT, LM_BATCH, seed=seed).batch(0),
                    CARD)
    step_fn = make_train_step(cfg, OptConfig())
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with OpAccounting() as mode:
        params, opt_state, metrics = step_fn(params, opt_state, data)
        loss = float(metrics["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    check(np.isfinite(loss), f"{label}: loss {loss}")
    del params, opt_state, data, step_fn, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return {"stats": mode.stats(), "peak": peak, "base": base, "counts": counts,
            "wall_s": wall, "loss": loss}


def dryrun_phase(seed: int, smi: str, lms: dict) -> dict:
    """14: the accounting of a real step against the fake trace's, and two
    production cells traced on the card's torch."""
    phase("14 the dry run's accounting on the card")
    start = time.perf_counter()
    import concurrent.futures
    import multiprocessing
    one = ShapeSpec("train_4x1024", LM_PROMPT, LM_BATCH, "train")
    trains = (("12c qwen3_0_6b", "qwen3_0_6b", {}, None),
              ("12b rwkv6_3b", "rwkv6_3b", {"rwkv_kernel": True}, "wkv_scan"))
    jobs = [(arch, one, dataclasses.replace(get_config(arch), **over), (), CARD)
            for _, arch, over, _ in trains]
    jobs += [(arch, SHAPES[shape], dataclasses.replace(get_config(arch), **over), None, CARD)
             for arch, shape, over in DRYRUN_CELLS]
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(jobs), mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = [pool.submit(dryrun_trace, *job) for job in jobs]
        counts = {k: 0 for k in launch_counts()}
        out = {}
        real = {}
        for label, arch, over, kernel in trains:
            cfg = dataclasses.replace(get_config(arch), **over)
            real[label] = accounted_train_step(label, cfg, seed)
            for k, n in real[label]["counts"].items():
                counts[k] += n
        print(f"14 real steps done at {time.perf_counter() - start:.1f} s; waiting for the "
              f"traces")
        traced = [f.result(timeout=DRYRUN_TIMEOUT_S) for f in futures]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    for (label, arch, over, kernel), fake in zip(trains, traced):
        r = real[label]
        st = r["stats"]
        cfg = dataclasses.replace(get_config(arch), **over)
        mf = model_flops(cfg, "train", LM_BATCH, LM_PROMPT)
        pred = fake["memory"]["argument_bytes"] + fake["memory"]["temp_bytes"]
        off = (pred - r["peak"]) / r["peak"]
        want = {kernel: 2 * cfg.n_layers} if kernel else {}
        print(f"{label} real step (4 x {LM_PROMPT}, {r['wall_s'] * 1e3:.2f} ms under the "
              f"accounting): dot FLOPs {st.dot_flops:.6e} ({st.dot_count} dots), fake "
              f"trace {fake['dot_flops']:.6e} ({fake['dot_count']}) in {fake['trace_s']} s; "
              f"dot_flops / model_flops {st.dot_flops / mf:.4f}; HBM bytes real "
              f"{st.hbm_bytes:.4e}, fake {fake['hbm_bytes']:.4e}; kernel ops real "
              f"{st.kernel_calls}, fake {fake['kernel_calls']}, launches "
              f"{nonzero(r['counts'])}")
        print(f"{label} memory: predicted arguments {fake['memory']['argument_bytes'] / 2**30:.3f}"
              f" + temp {fake['memory']['temp_bytes'] / 2**30:.3f} = {pred / 2**30:.3f} GiB; "
              f"measured peak {r['peak'] / 2**30:.3f} GiB (max_memory_allocated less "
              f"{r['base'] / 2**30:.3f} GiB held before); off by {off:+.2%} (bound "
              f"{DRYRUN_MEM_TOL:.0%}) on {smi}")
        check(st.dot_flops == fake["dot_flops"] and st.dot_count == fake["dot_count"],
              f"{label}: real dot FLOPs {st.dot_flops} ({st.dot_count}) vs fake "
              f"{fake['dot_flops']} ({fake['dot_count']})")
        check(st.kernel_calls == fake["kernel_calls"] == want
              and nonzero(r["counts"]) == want,
              f"{label}: kernel ops real {st.kernel_calls}, fake {fake['kernel_calls']}, "
              f"launches {nonzero(r['counts'])}, want {want}")
        check(abs(off) <= DRYRUN_MEM_TOL, f"{label}: predicted peak off by {off:+.2%}")
        out[label] = {"dot_flops": st.dot_flops, "model_ratio": st.dot_flops / mf,
                      "pred_gib": pred / 2**30, "peak_gib": r["peak"] / 2**30, "off": off,
                      "trace_s": fake["trace_s"]}
    for (arch, shape, over), cell in zip(DRYRUN_CELLS, traced[len(trains):]):
        t = terms(cell)
        dom = max(t, key=t.get)
        print(f"14 {arch} x {shape}{' ' + str(over) if over else ''} on the fake 16 x 16 "
              f"mesh ({cell['n_devices']} ranks): {mem_gib(cell):.2f} GiB a device "
              f"(arguments {cell['memory']['argument_bytes'] / 2**30:.2f} + temp "
              f"{cell['memory']['temp_bytes'] / 2**30:.2f}), dot FLOPs a device "
              f"{cell['dot_flops']:.4e}, collective bytes a device "
              f"{cell['collectives']['total_bytes']:.4e} {cell['collectives']['count_by_kind']}, "
              f"HBM bytes {cell['hbm_bytes']:.4e}; terms at the H100 figures compute "
              f"{t['compute']:.4f} s, memory {t['memory']:.4f} s, collective "
              f"{t['collective']:.4f} s: {dom} dominates; kernel ops {cell['kernel_calls']}; "
              f"trace {cell['trace_s']} s (predictions of the dry run)")
        check(cell["dot_flops"] > 0 and cell["collectives"]["total_bytes"] > 0,
              f"14 {arch} x {shape}: an empty trace")
        out[f"{arch} x {shape}"] = {"gib": mem_gib(cell), "dot_flops": cell["dot_flops"],
                                    "coll": cell["collectives"]["total_bytes"],
                                    "dominant": dom, "trace_s": cell["trace_s"]}
    for name, before in PLAIN_CALL_PREFILL_MS.items():
        print(f"14 {name} prefill through the custom op: {lms[name]['prefill_ms']:.2f} ms "
              f"(phase 6{'' if name == 'rwkv6_3b' else 'b'}), {before} ms before it "
              f"(PERF.md 5) on {smi}")
    print(f"phase 14: {time.perf_counter() - start:.1f} s")
    out["counts"] = counts
    return out


def tensor_rate(name: str, flops: float, t: dict) -> None:
    """Print a kernel's achieved FP64 rate, its share of the tensor peak and
    whether it meets its floor."""
    rate = flops / (t["ms"] * 1e-3)
    print(f"{name}: {rate / 1e12:.2f} TFLOP/s, {rate / PEAK_FP64_TENSOR:.1%} of the "
          f"FP64 tensor peak; floor {FLOOR_MS[name]} ms "
          f"{'met' if t['ms'] <= FLOOR_MS[name] else 'MISSED'}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    dev = device_phase()
    build_phase()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    A = torch.randint(0, ENTRY_MAX + 1, (V, R), generator=gen, device="cuda",
                      dtype=torch.float64)
    B = torch.randint(0, ENTRY_MAX + 1, (V, T), generator=gen, device="cuda",
                      dtype=torch.float64)
    plan = make_plan("bec", MAIN.p, MAIN.m, MAIN.n, K=MAIN.K, L=MAIN.L,
                     points=MAIN.points)
    errs = kernels_phase(plan, A, B, gen)
    errs |= scan_kernels_phase(gen)
    caps = caps_phase(gen, dev["smi"])
    errs |= half_kernels_phase(gen)
    C_ref = A.T @ B  # exact: every partial sum is an integer below 2^53
    paths = {"fused": main_phase(plan, A, B, C_ref),
             "staged": staged_phase(plan, A, B, C_ref),
             "partial": partial_phase(plan, A, B, C_ref)}
    # a capture counts the launches it records, not the ones its replays
    # run, so 4d's counts stay on its own line
    captured_phase(plan, A, B, C_ref, dev["smi"])
    half_paths = half_path_phase(plan, args.seed)
    times = times_phase(plan, A, B, dev["smi"])
    times |= scan_times_phase(gen, dev)
    times |= half_times_phase(plan, args.seed, dev["smi"])
    for name in ("fused", "staged", "partial"):
        wall = paths[name]["walls"]
        print(f"request wall time ({name}, 8000^2, float64): first {wall[0]:.2f} ms, "
              f"median of the rest {float(np.median(wall[1:])):.2f} ms on {dev['smi']}")
    paths["caps"] = caps
    paths["obs"] = obs_phase(plan, A, B, C_ref, times, dev["smi"])
    del A, B, C_ref
    torch.cuda.empty_cache()
    paths["paper"] = paper_phase(dev["smi"])
    paths["control"] = control_phase(args.seed, dev["smi"])
    paths["serve"] = serve_phase(args.seed, dev["smi"])
    gc.collect()
    torch.cuda.empty_cache()
    paths["mesh"] = mesh_phase(args.seed, dev["smi"])
    lms = {"rwkv6_3b": rwkv_phase(args.seed, dev["smi"]),
           "jamba group": jamba_phase(args.seed, dev["smi"])}
    lms |= dense_phase(args.seed, dev["smi"])
    paths["serve_lm twin"] = serve_lm_twin_phase()
    lms["gemma3_12b"] = gemma_phase(args.seed, dev["smi"])
    lms |= moe_lm_phase(args.seed, dev["smi"])
    paths["jamba expert layer"] = jamba_moe_phase(args.seed, dev["smi"])
    lms["musicgen_medium"] = embeds_phase("6i", "musicgen_medium", None, args.seed, dev["smi"])
    lms["qwen2_vl_72b 32 layers"] = embeds_phase("6j", "qwen2_vl_72b", QWEN2_VL_LAYERS,
                                                 args.seed, dev["smi"], QWEN2_VL_F32_LAYERS)
    paths["scan gradients"] = scan_grads_phase(gen, dev["smi"])
    trains = {"rwkv6_3b": rwkv_train_phase(args.seed, dev["smi"])}
    trains |= train_more_phase(args.seed, dev["smi"])
    paths["train cli"] = train_cli_phase()
    paths["expert parallel"] = ep_phase(args.seed, dev["smi"])
    paths["sharded train"] = sharded_train_phase(args.seed, dev["smi"])
    paths["dry run"] = dryrun_phase(args.seed, dev["smi"], lms)
    for name, lm in lms.items():
        print(f"LM serving ({name}, {LM_BATCH}x{lm['prompt']} prompt, {LM_GEN} tokens, bf16): "
              f"prefill {lm['prefill_ms']:.2f} ms, decode {lm['decode_ms']:.2f} ms per step, "
              f"{lm['tok_s']:.1f} tokens/s, {lm['params'] / 1e9:.3f} B parameters, peak "
              f"{lm['peak_gib']:.2f} GiB on {dev['smi']}")
    for name, tr in trains.items():
        print(f"LM training ({name}): {tr['step_ms']:.2f} ms a step, {tr['tok_s']:.1f} "
              f"tokens/s, {tr['flop_share']:.2%} of the bf16 tensor peak (model_flops), peak "
              f"{tr['peak_gib']:.2f} GiB, launches {nonzero(tr['counts'])} on {dev['smi']}")

    csrc = "src/repro_torch/kernels/csrc"
    source = {"fused_worker": (f"{csrc}/coded_fused.cu", "src/repro/kernels/coded_fused.py:105"),
              "decode": (f"{csrc}/coded_decode.cu", "src/repro/kernels/coded_decode.py:57"),
              "decode_partial": (f"{csrc}/coded_decode.cu",
                                 "src/repro/kernels/coded_decode.py:106"),
              "encode": (f"{csrc}/coded_encode.cu", "src/repro/kernels/coded_encode.py:48"),
              "matmul_t": (f"{csrc}/block_matmul.cu", "src/repro/kernels/block_matmul.py:62"),
              "mamba_scan": (f"{csrc}/mamba_scan.cu", "src/repro/kernels/mamba_scan.py:91"),
              "wkv_scan": (f"{csrc}/wkv_scan.cu", "src/repro/kernels/wkv_scan.py:82")}
    launches = {k: sum(run["counts"][k] for run in (*paths.values(), *lms.values(),
                                                    *trains.values()))
                for k in KERNELS}
    kernels = [dict(name=name, route="cuda", source=source[name][0],
                    replaces=source[name][1], launches=launches[name],
                    max_abs_err=errs[name], **times[name])
               for name in KERNELS]
    # the bf16 / f16 instances of kernels 1, 4 and 5, launched by phase 4h
    kernels += [dict(name=f"{name}_{tag}", route="cuda", source=source[name][0],
                     replaces=source[name][1],
                     launches=half_paths[tag]["counts"][name],
                     max_abs_err=errs[f"{name}_{tag}"], **times[f"{name}_{tag}"])
                for tag in HALF_NAME.values() for name in HALF_KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
