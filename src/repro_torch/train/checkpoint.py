"""numpy checkpointing with manifest + atomic commit, file for file the
reference's (``repro/train/checkpoint.py``).

Layout:  <dir>/step_<N>/
           manifest.json   — step, leaf paths, tree hash, leaf count
           <idx>.npy       — one file per leaf
Writes go to ``step_<N>.tmp`` then rename — a torn write can never be taken
for a valid checkpoint (restore picks the newest *complete* step). Leaf
paths, their order and the structure hash are the reference's
(``jax.tree_util`` flattening: dict keys sorted, NamedTuple fields in order
as ``.name``, sequence items by index; dtypes by numpy's names), so a
checkpoint written by either package restores in the other. numpy has no
bfloat16: such leaves raise (training state is fp32).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.offload import _flatten_with_paths as _flatten
from repro_torch.models.common import tree_unflatten

PyTree = Any


def _np_dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: checkpoint fp32 state")
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(leaf.dtype) if hasattr(leaf, "dtype") else str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: checkpoint fp32 state")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _tree_paths(tree: PyTree) -> List[str]:
    return [p for p, _ in _flatten(tree)]


def _structure_hash(tree: PyTree) -> str:
    desc = json.dumps([(p, list(np.shape(l)) if not isinstance(l, torch.Tensor)
                        else list(l.shape), _np_dtype(l))
                       for p, l in _flatten(tree)])
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def volume_bytes(tree: PyTree) -> int:
    """Bytes one ``save`` writes / one ``restore`` reads for ``tree``: the
    sum of every leaf's payload (the volume the scheduler's preemption path
    prices over the host links)."""
    return int(sum(l.numel() * l.element_size() if isinstance(l, torch.Tensor)
                   else np.asarray(l).nbytes for _, l in _flatten(tree)))


def save(directory: str, step: int, tree: PyTree, *, keep: int = 3,
         async_: bool = False) -> str:
    flat = _flatten(tree)
    paths = [p for p, _ in flat]
    host = [_to_numpy(l) for _, l in flat]   # copies off the device first
    digest = _structure_hash(tree)

    def commit():
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        for i, arr in enumerate(host):
            np.save(os.path.join(tmp, f"{i}.npy"), arr)
        manifest = {
            "step": step,
            "paths": paths,
            "hash": digest,
            "n_leaves": len(host),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(directory, keep)

    if async_:
        t = threading.Thread(target=commit, daemon=True)
        t.start()
        return f"async:{step}"
    commit()
    return os.path.join(directory, f"step_{step:08d}")


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(directory: str, tree_like: PyTree, step: Optional[int] = None
            ) -> Tuple[PyTree, int]:
    """Restore into the structure of ``tree_like`` (validates the manifest
    hash). Each leaf comes back where ``tree_like``'s leaf lives: a tensor on
    its device and in its dtype, anything else as the numpy array."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["hash"] != _structure_hash(tree_like):
        raise ValueError("checkpoint structure mismatch (wrong config?)")
    host = [np.load(os.path.join(d, f"{i}.npy"))
            for i in range(manifest["n_leaves"])]
    like = [l for _, l in _flatten(tree_like)]
    leaves = [torch.from_numpy(h).to(l.device) if isinstance(l, torch.Tensor)
              else h for h, l in zip(host, like)]
    return tree_unflatten(tree_like, leaves), step
