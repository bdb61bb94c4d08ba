"""Perf hillclimb over the port's dry run.

The twin of ``benchmarks/hillclimb.py``: each experiment is a (cell,
variant) pair traced by ``repro_torch.launch.dryrun.trace_cell`` with the
variant's config and sharding overrides, its three roofline terms at the
H100's figures (``benchmarks/torch_roofline.py``) printed beside the
baseline.  Results land in ``build/dryrun/`` with a ``__<variant>`` suffix,
so the JSON trail shows the whole path.  Every figure is a prediction.

Run one:   PYTHONPATH=src python -m benchmarks.torch_hillclimb --cell rwkv6_prefill --variant rwkv_kernel
Run plan:  PYTHONPATH=src python -m benchmarks.torch_hillclimb --plan
(``--device cpu`` on a machine without a CUDA build of PyTorch.)
"""
from __future__ import annotations

import argparse
import json

from benchmarks.torch_roofline import mem_gib, terms

# cell id -> (arch, shape)
CELLS = {
    "jamba_train": ("jamba_1_5_large_398b", "train_4k"),
    "jamba_prefill": ("jamba_1_5_large_398b", "prefill_32k"),
    "qwen3_0_6b_train": ("qwen3_0_6b", "train_4k"),
    "qwen2_vl_train": ("qwen2_vl_72b", "train_4k"),
    "qwen3_moe_train": ("qwen3_moe_235b_a22b", "train_4k"),
    "rwkv6_train": ("rwkv6_3b", "train_4k"),
    "rwkv6_prefill": ("rwkv6_3b", "prefill_32k"),
}

# variant -> (cfg_overrides, fsdp)
VARIANTS = {
    "baseline": ({}, True),
    "mamba_kernel": ({"mamba_kernel": True}, True),
    "no_fsdp": ({}, False),
    "remat_dots": ({"remat_policy": "dots"}, True),
    "no_fsdp_remat_dots": ({"remat_policy": "dots"}, False),
    "mamba_kernel_chunk128": ({"mamba_kernel": True}, True),
    "loss_chunk_2k": ({"loss_chunk": 2048}, True),
    "mamba_kernel_remat_dots": ({"mamba_kernel": True, "remat_policy": "dots"}, True),
    "proj_first": ({"proj_first": True}, True),
    "rwkv_kernel": ({"rwkv_kernel": True}, True),
    "mamba_kernel_proj_first": ({"mamba_kernel": True, "proj_first": True}, True),
}

PLAN = (
    ("jamba_train", "mamba_kernel"),
    ("jamba_train", "mamba_kernel_remat_dots"),
    ("qwen3_0_6b_train", "no_fsdp"),
    ("qwen3_0_6b_train", "no_fsdp_remat_dots"),
    ("qwen2_vl_train", "remat_dots"),
    ("jamba_prefill", "mamba_kernel"),
)


def run(cell: str, variant: str, device: str = "cuda") -> dict:
    from repro_torch.launch.dryrun import RESULTS_DIR, run_cell
    arch, shape = CELLS[cell]
    overrides, fsdp = VARIANTS[variant]
    suffix = "" if variant == "baseline" else f"__{variant}"
    res = run_cell(arch, shape, multi_pod=False, cfg_overrides=overrides, fsdp=fsdp,
                   tag_suffix=suffix, device=device)
    out = RESULTS_DIR / f"{arch}__{shape}__singlepod{suffix}.json"
    out.write_text(json.dumps(res, indent=2))
    t = terms(res)
    dom = max(t, key=t.get)
    print(f"{cell} [{variant}]: compute={t['compute']:.3f}s memory={t['memory']:.3f}s "
          f"collective={t['collective']:.3f}s dominant={dom} "
          f"mem/dev={mem_gib(res):.1f}GiB trace={res['trace_s']}s")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=CELLS)
    ap.add_argument("--variant", choices=VARIANTS, default="baseline")
    ap.add_argument("--plan", action="store_true", help="run the reference's plan")
    ap.add_argument("--device", default="cuda", help="where the fake tensors lie")
    args = ap.parse_args(argv)
    if args.plan:
        for cell, variant in PLAN:
            try:
                run(cell, variant, args.device)
            except Exception as e:  # noqa: BLE001 - report and go on
                print(f"[FAIL] {cell} {variant}: {e}")
        return
    if not args.cell:
        ap.error("--cell required (or --plan)")
    run(args.cell, args.variant, args.device)


if __name__ == "__main__":
    main()
