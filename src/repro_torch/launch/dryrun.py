"""Multi-pod dry run: trace every (arch x shape x mesh) cell under fake tensors.

The reference lowers and compiles each cell for the production mesh with
abstract inputs and reads XLA's memory analysis and partitioned HLO.  The
port has no compiler to ask: a cell here is the step itself, run eagerly
on one rank of the production mesh under ``FakeTensorMode`` (shapes,
dtypes and devices, no memory, no launch), in a fake process group of 256
ranks (512 with ``multi_pod``), this process being rank 0.  Parameters are
placed by the sharding rules as DTensors, so every op and collective the
step dispatches is rank 0's, and :mod:`repro_torch.launch.hlo_analysis`
counts them: collective bytes, dot FLOPs, HBM bytes and the live bytes the
step allocates.  The hand-written kernels are custom ops with fake
implementations (``kernels/ops.py``): they trace on CUDA fake tensors and
launch nothing.

Each cell's JSON keeps the reference's keys where their meaning holds
(``arch``, ``shape``, ``multi_pod``, ``kind``, ``n_devices``,
``collectives``, ``dot_flops``, ``dot_count``, ``hbm_bytes``, ``memory``):

* ``memory.argument_bytes``: rank 0's bytes of the parameters, optimizer
  state, batch and cache (local shards);
* ``memory.temp_bytes``: the step's peak live bytes less the arguments
  (what it allocates, its outputs included);
* ``memory.output_bytes``: what the step returns that is not an argument
  updated in place;
* ``trace_s`` takes the place of ``lower_s`` and ``compile_s``; ``cost`` and
  ``hlo_lines`` are gone (no compiler reports them); ``kernel_calls`` counts
  each kernel op's calls.

Beside each JSON the op log (``<tag>.ops.jsonl.gz``, one op a line: its
name, argument shapes and dtypes and group size) stands where the
reference keeps its ``.hlo.gz``; ``--reanalyze`` recomputes the analyzer's
fields from it.  Output goes under ``build/dryrun/``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
  python -m repro_torch.launch.dryrun --arch rwkv6_3b --shape prefill_32k --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gzip
import json
import math
import time
import traceback
from pathlib import Path
from typing import IO, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor, placement_types
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_archs, shape_applicable
from repro_torch.distributed.param_sharding import (
    batch_logical_axes,
    cache_logical_axes,
    shard_params,
)
from repro_torch.distributed.sharding import default_rules, placements, resolve_spec
from repro_torch.launch.hlo_analysis import OpAccounting, analyze_records
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import ModelConfig, cache_shapes, init_params
from repro_torch.optim import OptConfig, adamw_init

__all__ = ["RESULTS_DIR", "trace_cell", "run_cell", "reanalyze_all", "main"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def _fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks with this process as rank 0
    (``torch.testing``'s ``FakeStore``, backend "fake": collectives return at
    once).  An earlier fake group of another size is replaced; a real group
    is refused."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a dry run needs the process to itself: a real process "
                               "group is initialised")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


@contextlib.contextmanager
def _strided_shard_on_host():
    """DTensor finds a strided shard's local indices with a ``torch.arange``
    and ``.tolist()`` (``_StridedShard.local_shard_size_and_offset``): under
    ``FakeTensorMode`` the arange is fake and its values cannot be read.
    It is index arithmetic on the host, so it runs with the modes off."""
    cls = getattr(placement_types, "_StridedShard", None)
    orig = None if cls is None else cls.__dict__.get("local_shard_size_and_offset")
    if orig is None:
        yield
        return

    @functools.wraps(orig)
    def on_host(*args, **kwargs):
        with _disable_current_modes():
            return orig(*args, **kwargs)

    cls.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def _params(cfg: ModelConfig, device: torch.device) -> nn.Module:
    """The model's parameters as fake tensors on ``device`` (inside a
    ``FakeTensorMode``): ``init_params``' structure, built with the CPU
    generator, then each leaf made again on the device."""
    params = init_params(cfg, device="cpu")
    if device.type != "cpu":
        for name, p in list(params.named_parameters()):
            prefix, key = name.rsplit(".", 1)
            setattr(params.get_submodule(prefix), key,
                    nn.Parameter(torch.empty_like(p, device=device), requires_grad=False))
    return params


def _place(rules, t: torch.Tensor, axes) -> torch.Tensor:
    """A whole tensor placed on the rules' mesh by its logical axes (each
    rank keeps its shard); as it is without rules."""
    if rules is None:
        return t
    where = placements(rules.mesh, resolve_spec(rules, t.shape, axes))
    return distribute_tensor(t, rules.mesh, where, src_data_rank=None)


def _local(t) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _storages(tensors) -> dict:
    """{key: bytes} of the distinct local storages of ``tensors``."""
    seen = {}
    for t in tensors:
        st = _local(t).untyped_storage()
        seen[st._cdata] = st.nbytes()
    return seen


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def trace_cell(arch: str, shape: Union[str, ShapeSpec], multi_pod: bool = False,
               cfg_overrides: Optional[dict] = None, fsdp: bool = True,
               device: str = "cuda", *, cfg: Optional[ModelConfig] = None,
               mesh_shape: Optional[Sequence[int]] = None, log: Optional[IO[str]] = None) -> dict:
    """Trace one cell: the result dict (and each op's record written to
    ``log``, a text file, if given).

    ``shape`` names a cell of ``SHAPES`` (or is a ``ShapeSpec``);
    ``cfg_overrides`` and ``fsdp`` select a hillclimb variant; ``device``
    is where the fake tensors lie ("cuda" by default; "cpu" on a machine
    without a CUDA build, where the CUDA autograd engine cannot start).
    ``cfg`` replaces ``get_config(arch)`` (a SMOKE or cut config);
    ``mesh_shape`` replaces the production mesh by a (data, model) mesh of
    fake ranks, or by one device without sharding rules when ``()``.

    Raises:
        ValueError: for a shape the architecture does not take.
    """
    cfg = cfg or get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = shape_applicable(cfg, spec.name)
    if not ok:
        raise ValueError(f"{arch} x {spec.name}: {why}")
    dev = torch.device(device)
    rules = None
    n_devices = 1
    if mesh_shape is None:
        n_devices = 512 if multi_pod else 256
        _fake_group(n_devices)
        rules = default_rules(make_production_mesh(multi_pod=multi_pod,
                                                   device_type=dev.type), fsdp)
    elif len(mesh_shape):
        n_devices = math.prod(mesh_shape)
        _fake_group(n_devices)
        rules = default_rules(make_debug_mesh(*mesh_shape, device_type=dev.type), fsdp)

    t0 = time.perf_counter()
    with _strided_shard_on_host(), FakeTensorMode(allow_non_fake_inputs=True):
        params = _params(cfg, dev)
        if rules is not None:
            shard_params(params, rules)
        axes = batch_logical_axes(cfg, spec.kind)
        batch = {k: _place(rules, torch.zeros(m.shape, dtype=m.dtype, device=dev), axes[k])
                 for k, m in input_specs(cfg, spec).items()}
        if spec.kind == "train":
            step, args = make_train_step(cfg, OptConfig(), rules), [params, adamw_init(params),
                                                                    batch]
        elif spec.kind == "prefill":
            step, args = make_prefill_step(cfg, rules, S_max=spec.seq_len), [params, batch]
        else:
            cache = [{k: _place(rules, torch.zeros(s, dtype=d, device=dev), ax[k])
                      for k, (s, d) in layer.items()}
                     for layer, ax in zip(cache_shapes(cfg, spec.global_batch, spec.seq_len),
                                          cache_logical_axes(cfg))]
            step, args = make_serve_step(cfg, rules), [params, cache, batch, spec.seq_len - 1]
        held = _storages(_leaves(args))
        with OpAccounting(log) as mode:
            out = step(*args)
        out_bytes = sum(n for k, n in _storages(_leaves(out)).items() if k not in held)
    trace_s = time.perf_counter() - t0
    stats = mode.stats()
    result = {
        "arch": arch, "shape": spec.name, "multi_pod": multi_pod, "kind": spec.kind,
        "n_devices": n_devices,
        "trace_s": round(trace_s, 2),
        "memory": {"argument_bytes": sum(held.values()), "output_bytes": out_bytes,
                   "temp_bytes": mode.peak_bytes},
        "collectives": {"bytes_by_kind": stats.bytes_by_kind,
                        "count_by_kind": stats.count_by_kind,
                        "total_bytes": stats.total_bytes},
        "dot_flops": stats.dot_flops,
        "dot_count": stats.dot_count,
        "hbm_bytes": stats.hbm_bytes,
        "kernel_calls": stats.kernel_calls,
    }
    return result


def _tag(arch: str, shape: str, multi_pod: bool, suffix: str = "") -> str:
    return f"{arch}__{shape}__{'multipod' if multi_pod else 'singlepod'}{suffix}"


def run_cell(arch: str, shape: Union[str, ShapeSpec], multi_pod: bool = False,
             trace_out: Optional[str] = None, save_trace: bool = True,
             cfg_overrides: Optional[dict] = None, fsdp: bool = True, tag_suffix: str = "",
             device: str = "cuda", results_dir: Path = RESULTS_DIR, **trace_kw) -> dict:
    """Trace one cell (:func:`trace_cell`; ``trace_kw`` passes ``cfg`` and
    ``mesh_shape`` on) and keep its op log: ``<tag>.ops.jsonl.gz`` under
    ``results_dir`` with ``save_trace``, and ``trace_out`` (plain JSON lines)
    if given."""
    name = shape if isinstance(shape, str) else shape.name
    with contextlib.ExitStack() as stack:
        files = []
        if save_trace:
            results_dir.mkdir(parents=True, exist_ok=True)
            path = results_dir / f"{_tag(arch, name, multi_pod, tag_suffix)}.ops.jsonl.gz"
            files.append(stack.enter_context(gzip.open(path, "wt")))
        if trace_out:
            files.append(stack.enter_context(open(trace_out, "w")))
        return trace_cell(arch, shape, multi_pod, cfg_overrides, fsdp, device,
                          log=_Tee(files) if files else None, **trace_kw)


class _Tee:
    """A text sink writing to every file it holds."""

    def __init__(self, files):
        self.files = files

    def write(self, text: str) -> None:
        for f in self.files:
            f.write(text)


def reanalyze_all(results_dir: Path = RESULTS_DIR) -> int:
    """Rebuild the analyzer's fields of every stored cell from its op log
    (no trace) - run after hlo_analysis.py changes.  Returns the count."""
    n = 0
    for gz in sorted(results_dir.glob("*.ops.jsonl.gz")):
        jpath = gz.with_name(gz.name[:-len(".ops.jsonl.gz")] + ".json")
        if not jpath.exists():
            continue
        res = json.loads(jpath.read_text())
        with gzip.open(gz, "rt") as f:
            stats = analyze_records(json.loads(line) for line in f)
        res["collectives"] = {"bytes_by_kind": stats.bytes_by_kind,
                              "count_by_kind": stats.count_by_kind,
                              "total_bytes": stats.total_bytes}
        res["dot_flops"] = stats.dot_flops
        res["dot_count"] = stats.dot_count
        res["hbm_bytes"] = stats.hbm_bytes
        res["kernel_calls"] = stats.kernel_calls
        jpath.write_text(json.dumps(res, indent=2))
        n += 1
        print(f"[rean] {jpath.name}: flops={stats.dot_flops:.3e} "
              f"hbm={stats.hbm_bytes:.3e} coll={stats.total_bytes:.3e}")
    print(f"reanalyzed {n} cells")
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--trace-out", help="also write the op log here (JSON lines)")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute analyzer fields from the stored op logs")
    ap.add_argument("--device", default="cuda",
                    help="where the fake tensors lie (cuda; cpu without a CUDA build)")
    args = ap.parse_args(argv)
    if args.reanalyze:
        reanalyze_all()
        return

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(arch, s) for arch in list_archs() for s in SHAPES
                 if shape_applicable(get_config(arch), s)[0]]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch, s in cells:
        for mp in meshes:
            tag = _tag(arch, s, mp)
            out_path = RESULTS_DIR / f"{tag}.json"
            if args.skip_existing and out_path.exists():
                print(f"[skip] {tag}")
                continue
            print(f"[run ] {tag} ...", flush=True)
            try:
                res = run_cell(arch, s, mp, trace_out=args.trace_out, device=args.device)
                out_path.write_text(json.dumps(res, indent=2))
                mem = res["memory"]
                per_dev = mem["argument_bytes"] + mem["temp_bytes"]
                print(f"[ ok ] {tag}: trace={res['trace_s']}s "
                      f"flops={res['dot_flops']:.3e} "
                      f"coll={res['collectives']['total_bytes']:.3e}B "
                      f"mem/dev={per_dev / 2**30:.2f}GiB", flush=True)
            except Exception as e:  # noqa: BLE001 - report and continue
                failures.append((tag, str(e)))
                out_path.with_suffix(".err").write_text(f"{e}\n{traceback.format_exc()}")
                print(f"[FAIL] {tag}: {e}", flush=True)
    if failures:
        print(f"\n{len(failures)} failures:")
        for tag, e in failures:
            print(f"  {tag}: {e.splitlines()[0] if e else e}")
        raise SystemExit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
