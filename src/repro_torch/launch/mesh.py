"""Device meshes: one process per rank over ``torch.distributed``.

The reference builds single-controller meshes (``jax.make_mesh``): one
program drives every device, and CPU tests fake the devices with
``XLA_FLAGS=--xla_force_host_platform_device_count=N``.  PyTorch has no
single controller.  Each rank is a process running the same code, and a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's dimension
names gives each rank its coordinates: ``("data", "model")``, or
``("pod", "data", "model")`` across pods.

``spawn_mesh`` is the port's stand-in for the fake devices: it starts
``data x model`` ranks on this host, runs ``fn(mesh, *args)`` on each, and
returns every rank's result with its kernel launch counts.  Under
``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the environment) an entry point
joins the launcher's group with :func:`join_mesh` instead.

The backend follows the devices: gloo on the CPU, and gloo when ranks share
a card (NCCL refuses two ranks of one communicator on one GPU); NCCL when
every rank has a card of its own.  Every process group gets a 60 s timeout,
so a rank that dies leaves the others raising instead of blocked in a
collective.  Where gloo carries CUDA tensors, the functional all-gather and
all-to-all (which DTensor's redistributions call) run as the classic
collectives (:func:`gloo_cuda_collectives`).
"""
from __future__ import annotations

import datetime
import faulthandler
import math
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.numerics import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels import ops

__all__ = ["MESH_DIMS", "POD_DIMS", "GROUP_TIMEOUT_S", "RankOutput",
           "make_production_mesh", "make_debug_mesh", "mesh_backend",
           "in_torchrun", "join_mesh", "spawn_mesh", "gloo_cuda_collectives",
           "classic_all_gather", "classic_all_to_all"]

MESH_DIMS = ("data", "model")
POD_DIMS = ("pod", "data", "model")
GROUP_TIMEOUT_S = 60


class RankOutput(NamedTuple):
    """What one rank of :func:`spawn_mesh` hands back."""

    result: Any            # fn's return value (load it on the CPU)
    launches: dict         # ops.launch_counts() after fn, from 0 before it


def _mesh(shape: Sequence[int], names: Sequence[str],
          device_type: Optional[str]) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start the ranks with spawn_mesh or torchrun")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks, the group has {world}")
    if device_type is None:
        device_type = resolve_device(None).type
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The reference's production layout over the current group: 16 x 16
    ("data", "model"), or 2 x 16 x 16 ("pod", "data", "model").

    Raises:
        RuntimeError: without an initialised process group.
        ValueError: if the world size is not the layout's rank count.
    """
    if multi_pod:
        return _mesh((2, 16, 16), POD_DIMS, device_type)
    return _mesh((16, 16), MESH_DIMS, device_type)


def make_debug_mesh(data: int = 2, model: int = 4,
                    device_type: Optional[str] = None) -> DeviceMesh:
    """A small ("data", "model") mesh over the current group
    (``device_type`` defaults to the card; "cpu" for CPU ranks).

    Raises:
        RuntimeError: without an initialised process group.
        ValueError: if the world size is not ``data * model``.
    """
    return _mesh((data, model), MESH_DIMS, device_type)


def mesh_backend(device: torch.device, ranks_per_host: int) -> str:
    """gloo on the CPU or when ranks share a card, else NCCL."""
    if device.type == "cpu" or torch.cuda.device_count() < ranks_per_host:
        return "gloo"
    return "nccl"


def in_torchrun() -> bool:
    """True when a launcher (torchrun) set this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join_mesh(*, model: int, device=None) -> DeviceMesh:
    """This process's ("data", "model") mesh under torchrun: joins the
    launcher's group (``env://``) and takes data = WORLD_SIZE / model.

    Raises:
        ValueError: if the world size is not a multiple of ``model``.
    """
    device = resolve_device(device)
    world = int(os.environ["WORLD_SIZE"])
    if world % model:
        raise ValueError(f"a mesh of model={model} needs a multiple of "
                         f"{model} ranks, torchrun started {world}")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    if not dist.is_initialized():
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        dist.init_process_group(
            mesh_backend(device, local),
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    if device.type == "cuda" and dist.get_backend() == "gloo":
        gloo_cuda_collectives()
    return make_debug_mesh(world // model, model, device.type)


def gloo_cuda_collectives() -> None:
    """Run the functional all-gather and all-to-all (which DTensor's
    redistributions call) on a CUDA tensor over a gloo group through the
    classic ``torch.distributed`` collectives, in this process.  On an H100
    with ranks sharing the card (torch 2.11), gloo's functional all-gather
    of a CUDA tensor killed the process (SIGSEGV), where the classic
    all-gather, all-to-all, all-reduce and reduce-scatter of the same
    tensors ran.  Other groups and devices are untouched."""
    for name in ("all_gather_tensor", "all_gather_single"):
        orig = getattr(fc, name, None)
        if orig is not None and not getattr(orig, "classic", False):
            def gather(self, gather_dim, group, *a, _orig=orig, **kw):
                pg = _gloo_cuda(self, group)
                if pg is None:
                    return _orig(self, gather_dim, group, *a, **kw)
                return classic_all_gather(self, gather_dim, pg)
            gather.classic = True
            setattr(fc, name, gather)
    orig = fc.all_to_all_single
    if not getattr(orig, "classic", False):
        def all_to_all(self, output_split_sizes, input_split_sizes, group, *a, _orig=orig,
                       **kw):
            pg = _gloo_cuda(self, group)
            if pg is None:
                return _orig(self, output_split_sizes, input_split_sizes, group, *a, **kw)
            return classic_all_to_all(self, pg, output_split_sizes, input_split_sizes)
        all_to_all.classic = True
        fc.all_to_all_single = all_to_all
    # DTensor's shard-to-shard move: an all-gather, then this rank's chunk
    from torch.distributed.tensor import _collective_utils, placement_types
    for module in (_collective_utils, placement_types):
        orig = getattr(module, "shard_dim_alltoall", None)
        if orig is None or getattr(orig, "classic", False):
            continue

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim, _orig=orig):
            pg = _gloo_cuda(input, (mesh, mesh_dim))
            if pg is None:
                return _orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            out = classic_all_gather(input, gather_dim, pg)
            return out.chunk(pg.size(), dim=shard_dim)[pg.rank()].contiguous()
        alltoall.classic = True
        module.shard_dim_alltoall = alltoall


def _gloo_cuda(x: torch.Tensor, group):
    """The process group of ``group`` when ``x`` is a CUDA tensor and the
    group is gloo's, else None."""
    if not x.is_cuda:
        return None
    pg = _process_group(group)
    return pg if pg is not None and dist.get_backend(pg) == "gloo" else None


def _process_group(group):
    """The ProcessGroup a functional collective's ``group`` names: a group, a
    (mesh, mesh dim) pair, a group name, or whatever the installed
    version's resolver takes; None if none resolves it."""
    if isinstance(group, dist.ProcessGroup):
        return group
    if isinstance(group, tuple) and len(group) == 2 and isinstance(group[0], DeviceMesh):
        return group[0].get_group(group[1])
    for resolve in (lambda g: torch._C._distributed_c10d._resolve_process_group(g),
                    lambda g: fc._resolve_group(g),
                    lambda g: torch._C._distributed_c10d._resolve_process_group(
                        fc._resolve_group_name(g))):
        try:
            pg = resolve(group)
        except (AttributeError, RuntimeError, ValueError, TypeError):
            continue
        if isinstance(pg, dist.ProcessGroup):
            return pg
    return None


def classic_all_gather(x: torch.Tensor, dim: int, pg) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim`` in rank order
    (``dist.all_gather_into_tensor``, synchronous)."""
    world = pg.size()
    x = x.contiguous()
    out = x.new_empty((world * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=pg)
    return out if dim == 0 else torch.cat(out.chunk(world, 0), dim=dim)


def classic_all_to_all(x: torch.Tensor, pg, output_split_sizes=None,
                       input_split_sizes=None) -> torch.Tensor:
    """``dist.all_to_all_single`` of ``x`` over ``pg`` (synchronous)."""
    x = x.contiguous()
    if output_split_sizes is None:
        out = torch.empty_like(x)
    else:
        out = x.new_empty((sum(output_split_sizes), *x.shape[1:]))
    dist.all_to_all_single(out, x, output_split_sizes, input_split_sizes, group=pg)
    return out


def _rank_main(rank: int, fn: Callable, args: tuple, data: int, model: int,
               device_type: str, backend: str, workdir: str) -> None:
    faulthandler.enable()       # a rank that crashes prints its Python stack
    world = data * model
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        # the host's cores are shared by every rank
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, init_method=f"file://{workdir}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    if backend == "gloo" and device_type == "cuda":
        gloo_cuda_collectives()
    try:
        mesh = init_device_mesh(device_type, (data, model),
                                mesh_dim_names=MESH_DIMS)
        ops.reset_launch_counts()
        result = fn(mesh, *args)
        torch.save({"result": result, "launches": ops.launch_counts()},
                   Path(workdir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_mesh(fn: Callable, *, data: int, model: int, device=None,
               args: tuple = (), timeout_s: Optional[float]) -> list:
    """Run ``fn(mesh, *args)`` on ``data * model`` fresh ranks of this host.

    ``fn`` must be importable by name (a module-level function): each rank
    is a process started with the "spawn" method.  Ranks join over a
    ``file://`` rendezvous in a temporary directory, so concurrent spawns
    never collide on a port, and each builds the ("data", "model") mesh.
    On a card every rank sets ``cuda:(rank % device_count)``; the CUDA
    libraries are built here, in the parent, before any rank starts, so
    ranks never run nvcc side by side.  Each rank's launch counts are set
    to 0 just before ``fn`` and read just after it.

    Returns:
        One :class:`RankOutput` per rank, in rank order.

    Raises:
        TimeoutError: if the ranks have not all finished ``timeout_s``
            seconds after the start (every rank is then stopped; ``None``
            sets no deadline).
        torch.multiprocessing.ProcessRaisedException: if a rank raised
            (with its traceback; the other ranks are stopped).
    """
    device = resolve_device(device)
    world = data * model
    if device.type == "cuda":
        _build.build()
    backend = mesh_backend(device, world)
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as workdir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, tuple(args), data, model, device.type,
                              backend, workdir),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} mesh ranks did not finish within "
                        f"{timeout_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
            for proc in ctx.processes:
                proc.join(5)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        outs = [torch.load(Path(workdir) / f"rank{r}.pt", map_location="cpu",
                           weights_only=False) for r in range(world)]
    return [RankOutput(o["result"], o["launches"]) for o in outs]
