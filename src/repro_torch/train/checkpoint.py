"""Checkpointing: atomic, versioned, keep-k, in the reference's format.

One ``.npz`` a checkpoint holds every leaf under its path, the keys joined
by ``|`` and list items written ``[i]`` (no pickle), as the reference
names them, so that a checkpoint written by either package is read by the
other. It is written to a temporary file of a unique name, then renamed
atomically, so a crash mid-write never corrupts the latest checkpoint;
restore picks the highest complete step, and ``keep`` bounds the disk used.
``save_async`` copies the tree to host memory before its thread starts, so
the training loop may go on updating its tensors in place.

A bfloat16 leaf is written as float32 (numpy has no bfloat16) and restored
to the template's type.
"""
from __future__ import annotations

import os
import re
import threading

import numpy as np
import torch

_LEAF_SEP = "|"


def _host(x) -> np.ndarray:
    """A numpy copy of a leaf (never a view of a tensor the caller goes on
    updating)."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.asarray(x)


def _to_host(tree):
    """The same tree with every leaf copied to a numpy array."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return _host(tree)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_LEAF_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]{_LEAF_SEP}"))
    else:
        out[prefix.rstrip(_LEAF_SEP)] = _host(tree)
    return out


def _unflatten_into(template, flat):
    """Rebuild the arrays of ``flat`` into the structure of ``template``: a
    tensor leaf becomes a tensor of its type on its device, any other leaf
    the stored numpy array."""
    def rebuild(t, prefix):
        if isinstance(t, dict):
            return {k: rebuild(v, f"{prefix}{k}{_LEAF_SEP}") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v, f"{prefix}[{i}]{_LEAF_SEP}")
                           for i, v in enumerate(t))
        arr = flat[prefix.rstrip(_LEAF_SEP)]
        if torch.is_tensor(t):
            return torch.from_numpy(np.array(arr)).to(device=t.device,
                                                      dtype=t.dtype)
        return arr
    return rebuild(template, "")


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    # unique tmp name: concurrent saves of the same step (async + final
    # blocking save) must not collide before the atomic rename
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}_{os.getpid()}_{id(tree)}.npz")
    final = os.path.join(ckpt_dir, f"step_{step:010d}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)  # atomic
    _gc(ckpt_dir, keep)
    return final


def save_async(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> threading.Thread:
    host_tree = _to_host(tree)  # device->host copy now, before the thread
    t = threading.Thread(target=save, args=(ckpt_dir, step, host_tree),
                         kwargs={"keep": keep}, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)\.npz", f))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template, step: int | None = None):
    """Returns (tree, step) or (None, None) when no checkpoint exists."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None, None
    path = os.path.join(ckpt_dir, f"step_{step:010d}.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_into(template, flat), step


def _gc(ckpt_dir: str, keep: int):
    files = sorted(f for f in os.listdir(ckpt_dir)
                   if re.fullmatch(r"step_\d+\.npz", f))
    for f in files[:-keep]:
        try:
            os.remove(os.path.join(ckpt_dir, f))
        except FileNotFoundError:
            pass  # concurrent GC from an async save already removed it
