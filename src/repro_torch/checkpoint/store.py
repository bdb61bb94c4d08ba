"""Fault-tolerant checkpointing: atomic, manifest-driven, resumable.

The reference package's on-disk contract:
  <dir>/step_000000123/
      manifest.json       # leaf paths + leaf index + dtypes + extra (data step)
      shard_00000.npz     # the leaves, flattened (about 512 MB a shard)
      .COMMIT             # written LAST; restore ignores dirs without it

Writes go to ``step_XXXXXXXXX.tmp/`` and are renamed into place after the
COMMIT marker lands, so a preempted job never observes a torn checkpoint;
restore picks the newest committed step.

The state is a tree of ``nn.Module`` s (their ``state_dict`` entries),
dicts, tuples and lists, with tensors, numpy arrays or numbers as leaves
(the train loop saves ``(LM, optimizer state)``).  Leaves of a dtype npz
does not hold (bfloat16) are stored as a uint8 view plus the dtype name,
as the reference stores them, and re-viewed through ``torch`` on load.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_SHARD_BYTES = 512 * 2**20

# torch dtypes npz holds natively, by numpy's name
_NATIVE = {torch.float16: "float16", torch.float32: "float32", torch.float64: "float64",
           torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
           torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
           torch.complex64: "complex64", torch.complex128: "complex128"}
# stored as a uint8 view
_VIEWED = {"bfloat16": torch.bfloat16}


def _leaves(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in a fixed order."""
    if isinstance(tree, nn.Module):
        return [(f"{path}/{k}", v) for k, v in tree.state_dict().items()]
    if isinstance(tree, dict):
        return [pair for k, v in tree.items() for pair in _leaves(v, f"{path}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, v in enumerate(tree) for pair in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _encode(leaf) -> Tuple[np.ndarray, str]:
    if not isinstance(leaf, torch.Tensor):
        a = np.asarray(leaf)
        return a, a.dtype.name
    t = leaf.detach().cpu().contiguous()
    if t.dtype in _NATIVE:
        return t.numpy(), _NATIVE[t.dtype]
    name = str(t.dtype).removeprefix("torch.")
    if name not in _VIEWED:
        raise ValueError(f"cannot checkpoint a {t.dtype} leaf")
    return t.reshape(-1).view(torch.uint8).numpy(), name


def _decode(a: np.ndarray, name: str, shape) -> torch.Tensor:
    if name in _VIEWED:
        return torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).view(
            _VIEWED[name]).reshape(shape)
    return torch.from_numpy(np.array(a))


def save_checkpoint(directory, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``tree`` as checkpoint ``step`` under ``directory``, atomically.
    Returns the committed directory."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:09d}"
    tmp = directory / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    leaves = _leaves(tree)
    shards: List[Dict[str, np.ndarray]] = []
    cur: Dict[str, np.ndarray] = {}
    cur_bytes = 0
    index, dtypes = [], []
    for i, (_, leaf) in enumerate(leaves):
        key = f"leaf_{i}"
        enc, name = _encode(leaf)
        cur[key] = enc
        dtypes.append(name)
        cur_bytes += enc.nbytes
        index.append((len(shards), key))
        if cur_bytes >= _SHARD_BYTES:
            shards.append(cur)
            cur, cur_bytes = {}, 0
    shards.append(cur)
    for si, sh in enumerate(shards):
        np.savez(tmp / f"shard_{si:05d}.npz", **sh)

    manifest = {"step": step, "paths": [p for p, _ in leaves], "n_leaves": len(leaves),
                "index": index, "dtypes": dtypes, "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / ".COMMIT").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory) -> Optional[int]:
    """The newest committed step under ``directory``, or None.  Directories
    without a COMMIT marker (torn writes) are ignored."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in directory.iterdir()
             if d.is_dir() and d.name.startswith("step_") and not d.name.endswith(".tmp")
             and (d / ".COMMIT").exists()]
    return max(steps) if steps else None


def _rebuild(template: Any, values: List[torch.Tensor]) -> Any:
    """``template``'s structure holding the next leaves of ``values``: a
    module is loaded in place and returned, a tensor becomes a new tensor
    on the template's device."""
    if isinstance(template, nn.Module):
        with torch.no_grad():
            for t in template.state_dict().values():
                t.copy_(values.pop(0))
        return template
    if isinstance(template, dict):
        return {k: _rebuild(v, values) for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, values) for v in template)
    value = values.pop(0)
    if isinstance(template, torch.Tensor):
        return value.to(template.device)
    return value.numpy()


def restore_checkpoint(directory, template: Any, step: Optional[int] = None
                       ) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``template`` (leaf count, shapes and
    dtypes verified).  Returns (tree, step, extra).

    Raises:
        FileNotFoundError: with no committed checkpoint.
        ValueError: on a leaf count, shape or dtype that differs from the
            template's.
    """
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    d = directory / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    tmpl = _leaves(template)
    if len(tmpl) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, template {len(tmpl)}")
    shards: Dict[int, Any] = {}
    values = []
    for i, (path, leaf) in enumerate(tmpl):
        si, key = manifest["index"][i]
        if si not in shards:
            shards[si] = np.load(d / f"shard_{si:05d}.npz")
        shape = tuple(np.shape(leaf))
        name = manifest["dtypes"][i]
        a = shards[si][key]
        if name in _VIEWED:
            if a.size != 2 * int(np.prod(shape)):
                raise ValueError(f"leaf {i} ({path}): {a.size // 2} values, template {shape}")
        elif tuple(a.shape) != shape:
            raise ValueError(f"leaf {i} ({path}): shape {a.shape} != {shape}")
        value = _decode(a, name, shape)
        want = leaf.dtype if isinstance(leaf, torch.Tensor) else None
        if want is not None and value.dtype != want:
            raise ValueError(f"leaf {i} ({path}): dtype {value.dtype} != {want}")
        values.append(value)
    return _rebuild(template, values), step, manifest.get("extra", {})
