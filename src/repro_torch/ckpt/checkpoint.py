"""Atomic checkpointing of a train state.

Port of ``repro.ckpt.checkpoint``, with its on-disk layout and protocol:
``step_%08d/arrays.npz`` holds one array per leaf, keyed by the leaf's tree
path joined by ``|`` (for the port's state ``params|<parameter name>``,
``opt|m|...``, ``opt|count``, ``step``), beside an ``index.json`` with the
step and each key's shape and dtype. The write is atomic (a temporary
directory renamed into place), so a preemption mid-write never corrupts the
latest checkpoint; ``latest_step`` only ever sees complete directories, and
the newest ``keep`` are kept.

Tensors leave the card with ``.detach().cpu()``. A bf16 leaf is written as
the reference writes one: its 16 bits as numpy ``V2``, with ``"bfloat16"``
in the index, and is read back bit for bit by that index dtype. So the port
also restores a bf16 checkpoint the reference wrote, which the reference's
own ``restore`` cannot cast (ROADMAP Queue C).

A state of DTensor leaves is written as the reference writes a sharded
one: the logically unsharded arrays. Every rank assembles each leaf
(``full_tensor``, a collective, in the same order on every rank) and rank 0
alone writes; the ranks meet at a barrier after the rename. ``restore``
with ``shardings`` (a tree of ``NamedSharding`` parallel to ``like``)
places each leaf as a DTensor on its mesh, so a checkpoint written on one
mesh restores onto another (elastic restart).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd

_SEP = "|"
BF16 = "bfloat16"


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    """Leaves of a tree of dicts, keyed by their paths joined by ``|``, in
    sorted key order (as ``jax.tree_util`` orders a dict's leaves)."""
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            flat.update(_flatten(tree[k], prefix + (str(k),)))
        return flat
    return {_SEP.join(prefix): tree}


def _unflatten(like, flat: Dict[str, Any], prefix=()):
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, prefix + (str(k),)) for k, v in like.items()}
    return flat[_SEP.join(prefix)]


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``, as numpy names the same dtype."""
    return str(dtype).removeprefix("torch.")


def to_numpy(leaf) -> np.ndarray:
    """A leaf as the array written for it: a tensor on the host, its bits as
    ``V2`` for bf16."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    """The tensor of an array read back, ``dtype`` its index entry: 16 bits
    written as ``V2`` (or an ``ml_dtypes`` bf16 array) become bf16 bit for bit."""
    if dtype == BF16 and a.dtype.itemsize == 2:
        return torch.from_numpy(np.asarray(a, order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, order="C"))


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def save(ckpt_dir: str, step: int, state, keep: int = 3) -> str:
    """Atomically write ``state`` for ``step``. Returns the final path."""
    flat = _flatten(state)
    sharded = any(_is_dtensor(v) for v in flat.values())
    if sharded:
        flat = {k: v.full_tensor() if _is_dtensor(v) else v for k, v in flat.items()}
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not dist.is_initialized() or dist.get_rank() == 0:
        _write(ckpt_dir, final, step, flat, keep)
    if sharded and dist.get_world_size() > 1:
        dist.barrier()
    return final


def _write(ckpt_dir: str, final: str, step: int, flat, keep: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir)
    try:
        arrays = {k: to_numpy(v) for k, v in flat.items()}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        index = {
            "step": int(step),
            "keys": {k: {"shape": list(a.shape),
                         "dtype": dtype_name(flat[k].dtype) if isinstance(flat[k], torch.Tensor)
                         else str(a.dtype)}
                     for k, a in arrays.items()},
        }
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "index.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_arrays(ckpt_dir: str, step: int) -> Dict[str, torch.Tensor]:
    """Every leaf of a checkpoint (the port's or the reference's) as a CPU
    tensor of its index dtype, keyed as written."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "index.json")) as f:
        keys = json.load(f)["keys"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: from_numpy(z[k], keys[k]["dtype"]) for k in z.files}


def restore(ckpt_dir: str, step: int, like, shardings=None, device=None):
    """Restore into the structure of ``like`` (a state, or a tree of ``meta``
    tensors as ``train.step.state_shapes`` gives), each leaf cast to the
    dtype of its ``like`` leaf. The leaves go to ``device``; by default each
    to its ``like`` leaf's device, and a ``meta`` leaf's to the card. With
    ``shardings`` each leaf becomes a DTensor laid out as its entry says, on
    its mesh's device type unless ``device`` is given."""
    arrays = read_arrays(ckpt_dir, step)
    flat_like = _flatten(like)
    missing = set(flat_like) - set(arrays)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    flat_sh = _flatten(shardings) if shardings is not None else {}
    out = {}
    for key, ref in flat_like.items():
        t = arrays[key]
        sh = flat_sh.get(key)
        if isinstance(ref, torch.Tensor):
            dev = device if device is not None else (
                sh.mesh.device_type if sh is not None else
                "cuda" if ref.device.type == "meta" else ref.device)
            t = t.to(device=dev, dtype=ref.dtype)
        if sh is not None:
            t = shd.distribute(t, sh)
        out[key] = t
    return _unflatten(like, out)
