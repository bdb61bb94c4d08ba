"""Fault-tolerant checkpointing: atomic, manifest-driven, resumable, in the
reference package's on-disk layout.

  <dir>/step_000000123/
      manifest.json       # step, treedef, n_leaves, leaf index, dtypes, extra
      shard_00000.npz     # the leaves, flattened (about 512 MB a shard)
      .COMMIT             # written LAST; restore ignores dirs without it

Writes go to ``step_XXXXXXXXX.tmp/`` and are renamed into place after the
COMMIT marker lands, so a preempted job never observes a torn checkpoint;
restore picks the newest committed step.

The leaves are those ``jax.tree.leaves`` gives for the reference's state:
dicts in sorted key order, tuples and lists in order, ``None`` holding
nothing.  An ``LM`` is written as the reference's parameter tree
(``embed`` / ``lm_head`` / ``final_norm`` dicts and ``blocks``, one dict per
pattern position whose leaves stack the groups, ``(n_groups, ...)``), and so
is a dict keyed by its parameter names (the AdamW state's ``master``,
``mu`` and ``nu``).  So the trainer's ``(LM, AdamW state)`` is the
reference's ``(params, opt_state)`` leaf for leaf, and either package
resumes the other's run.  ``treedef`` is a description of that tree; the
reference never reads it back.  Leaves of a dtype npz does not hold
(bfloat16) are stored as a uint8 view plus the dtype name, as the reference
stores them, and re-viewed through ``torch`` on load.

Sharded state (``DTensor`` leaves, a train step on a mesh): every rank
calls save and restore; the leaves are gathered whole, rank 0 writes, and
a restore places each leaf as its template is placed.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.lm import LM

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_SHARD_BYTES = 512 * 2**20

# torch dtypes npz holds natively, by numpy's name
_NATIVE = {torch.float16: "float16", torch.float32: "float32", torch.float64: "float64",
           torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
           torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
           torch.complex64: "complex64", torch.complex128: "complex128"}
# stored as a uint8 view
_VIEWED = {"bfloat16": torch.bfloat16}

_PARTS = ("ffn", "mixer", "norm1", "norm2")


class _Stack(list):
    """A stacked leaf of the reference's tree: its groups' tensors, in group
    order (``torch.stack`` of them is the leaf)."""


def _lm_tree(named: Dict[str, Any], pattern_len: int) -> dict:
    """An LM's parameter-name dict as the reference's parameter tree."""
    tree: Dict[str, Any] = {}
    blocks: Dict[int, Dict[str, Dict[str, Dict[int, Any]]]] = {}
    for name, t in named.items():
        top, rest = name.split(".", 1)
        if top == "blocks":
            i, part, leaf = rest.split(".")
            g, p = divmod(int(i), pattern_len)
            blocks.setdefault(p, {}).setdefault(part, {}).setdefault(leaf, {})[g] = t
        else:
            tree.setdefault(top, {})[rest] = t
    tree["blocks"] = tuple(
        {part: {leaf: _Stack(groups[g] for g in sorted(groups))
                for leaf, groups in blocks[p][part].items()}
         for part in _PARTS}
        for p in range(len(blocks)))
    return tree


def _reference(tree: Any, lm: Optional[LM]) -> Any:
    """``tree`` in the reference's layout: an LM, and every dict keyed by its
    parameter names, become the reference's parameter tree."""
    if isinstance(tree, LM):
        return _lm_tree(dict(tree.named_parameters()), tree.pattern_len)
    if _names_of(lm, tree):
        return _lm_tree(tree, lm.pattern_len)
    if isinstance(tree, dict):
        return {k: _reference(v, lm) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_reference(v, lm) for v in tree)
    return tree


def _find_lm(tree: Any) -> Optional[LM]:
    if isinstance(tree, LM):
        return tree
    children = (tree.values() if isinstance(tree, dict)
                else tree if isinstance(tree, (tuple, list)) else ())
    for child in children:
        found = _find_lm(child)
        if found is not None:
            return found
    return None


def _flatten(tree: Any) -> List[Any]:
    """The leaves in ``jax.tree.leaves`` order (dict keys sorted, None
    empty); a ``_Stack`` is one leaf."""
    if tree is None:
        return []
    if isinstance(tree, _Stack):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _treedef(tree: Any) -> str:
    """A description of the tree's structure, ``*`` for a leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, _Stack) or not isinstance(tree, (dict, tuple, list)):
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    inner = ", ".join(_treedef(v) for v in tree)
    return f"({inner},)" if isinstance(tree, tuple) and len(tree) == 1 else (
        f"({inner})" if isinstance(tree, tuple) else f"[{inner}]")


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A tensor's whole value on the host (a DTensor gathered first)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().contiguous()


def _encode(leaf) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, _Stack):
        t = torch.stack([_whole(x) for x in leaf])
    elif isinstance(leaf, torch.Tensor):
        t = _whole(leaf)
    else:
        a = np.asarray(leaf)
        return a, a.dtype.name
    if t.dtype in _NATIVE:
        return t.numpy(), _NATIVE[t.dtype]
    name = str(t.dtype).removeprefix("torch.")
    if name not in _VIEWED:
        raise ValueError(f"cannot checkpoint a {t.dtype} leaf")
    # the reference's np.ascontiguousarray(a).view(np.uint8): the last axis
    # doubles (a 0-d leaf becomes two bytes)
    return (t.reshape(1) if t.ndim == 0 else t).view(torch.uint8).numpy(), name


def _decode(a: np.ndarray, name: str, shape) -> torch.Tensor:
    if name in _VIEWED:
        return torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).view(
            _VIEWED[name]).reshape(shape)
    return torch.from_numpy(np.array(a)).reshape(shape)


def _shape(leaf) -> tuple:
    if isinstance(leaf, _Stack):
        return (len(leaf), *leaf[0].shape)
    return tuple(np.shape(leaf))


def _sharded(leaves: List[Any]) -> bool:
    return any(isinstance(x, DTensor) for leaf in leaves
               for x in (leaf if isinstance(leaf, _Stack) else [leaf]))


def save_checkpoint(directory, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``tree`` as checkpoint ``step`` under ``directory``, atomically,
    in the reference's layout.  Returns the committed directory.  With
    DTensor leaves every rank must call it (the leaves are gathered), and
    rank 0 writes."""
    directory = Path(directory)
    ref = _reference(tree, _find_lm(tree))
    leaves = _flatten(ref)
    sharded = _sharded(leaves) and dist.is_initialized()
    writer = not sharded or dist.get_rank() == 0
    final = directory / f"step_{step:09d}"
    tmp = directory / f"step_{step:09d}.tmp"
    if writer:
        directory.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
    shards: List[Dict[str, np.ndarray]] = []
    cur: Dict[str, np.ndarray] = {}
    cur_bytes = 0
    index, dtypes = [], []
    for i, leaf in enumerate(leaves):
        key = f"leaf_{i}"
        enc, name = _encode(leaf)     # every rank: a DTensor gathers
        if not writer:
            continue
        cur[key] = enc
        dtypes.append(name)
        cur_bytes += enc.nbytes
        index.append((len(shards), key))
        if cur_bytes >= _SHARD_BYTES:
            shards.append(cur)
            cur, cur_bytes = {}, 0
    if writer:
        shards.append(cur)
        for si, sh in enumerate(shards):
            np.savez(tmp / f"shard_{si:05d}.npz", **sh)
        manifest = {"step": step, "treedef": _treedef(ref), "n_leaves": len(leaves),
                    "index": index, "dtypes": dtypes, "extra": extra or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / ".COMMIT").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    if sharded:
        dist.barrier()
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


def _place(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``value`` (a whole tensor on the host) where ``like`` lives: its
    device, or its mesh and placements."""
    if isinstance(like, DTensor):
        return distribute_tensor(value.to(like.device_mesh.device_type), like.device_mesh,
                                 like.placements)
    return value.to(like.device)


def _load_lm(leaves: List[Any], values: List[Any]) -> None:
    """Load an LM's parameters in place: ``leaves`` its reference layout's
    leaves (parameters, or ``_Stack`` s of them), ``values`` theirs."""
    with torch.no_grad():
        for leaf, value in zip(leaves, values):
            if isinstance(leaf, _Stack):
                for t, v in zip(leaf, value):
                    t.copy_(_place(v, t))
            else:
                leaf.copy_(_place(value, leaf))


def _names_of(lm: Optional[LM], tree: Any) -> bool:
    """Whether ``tree`` is a dict keyed by ``lm``'s parameter names."""
    return (lm is not None and isinstance(tree, dict) and bool(tree)
            and set(tree) == set(n for n, _ in lm.named_parameters()))


def _rebuild(template: Any, lm: Optional[LM], it, ref: Any) -> Any:
    """``template``'s structure holding the restored values, which ``it``
    yields in the reference's leaf order; ``ref`` is the template's
    reference layout."""
    if isinstance(template, LM):
        leaves = _flatten(ref)
        _load_lm(leaves, [next(it) for _ in leaves])
        return template
    if _names_of(lm, template):
        # the reference's tree of these tensors, one value per group
        got = {id(leaf): next(it) for leaf in _flatten(ref)}
        out = {}
        for name, like in template.items():
            top, rest = name.split(".", 1)
            if top == "blocks":
                i, part, leaf = rest.split(".")
                g, p = divmod(int(i), lm.pattern_len)
                out[name] = _place(got[id(ref["blocks"][p][part][leaf])][g], like)
            else:
                out[name] = _place(got[id(ref[top][rest])], like)
        return out
    if isinstance(template, dict):
        done = {k: _rebuild(template[k], lm, it, ref[k]) for k in sorted(template)}
        return {k: done[k] for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, lm, it, r) for v, r in zip(template, ref))
    if template is None:
        return None
    value = next(it)
    if isinstance(template, torch.Tensor):
        return _place(value, template)
    return value.numpy()


def restore_checkpoint(directory, template: Any, step: Optional[int] = None
                       ) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``template``: an ``LM`` is loaded in
    place, a tensor becomes a new tensor on its template's device (or mesh,
    with its placements).  The leaf count, shapes and dtypes are verified
    against the template's reference layout.  Returns (tree, step, extra).

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
    lm = _find_lm(template)
    ref = _reference(template, lm)
    tmpl = _flatten(ref)
    if len(tmpl) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, template {len(tmpl)}")
    shards: Dict[int, Any] = {}
    values = []
    for i, leaf in enumerate(tmpl):
        si, key = manifest["index"][i]
        if si not in shards:
            shards[si] = np.load(d / f"shard_{si:05d}.npz")
        shape = _shape(leaf)
        name = manifest["dtypes"][i]
        a = shards[si][key]
        if name in _VIEWED:
            if a.size != 2 * int(np.prod(shape)):
                raise ValueError(f"leaf {i}: {a.size // 2} values, template {shape}")
        elif tuple(a.shape) != shape:
            raise ValueError(f"leaf {i}: shape {a.shape} != {shape}")
        value = _decode(a, name, shape)
        first = leaf[0] if isinstance(leaf, _Stack) else leaf
        want = first.dtype if isinstance(first, torch.Tensor) else None
        if want is not None and value.dtype != want:
            raise ValueError(f"leaf {i}: dtype {value.dtype} != {want}")
        values.append(value)
    return _rebuild(template, lm, iter(values), ref), step, manifest.get("extra", {})
