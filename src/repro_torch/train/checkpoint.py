"""Fault-tolerant checkpointing: mesh-agnostic, atomic, async, versioned.

Port of ``src/repro/train/checkpoint.py`` with its guarantees:

  * **Atomic**: write into ``<dir>/tmp.<step>.<pid>``, fsync the manifest,
    then rename to ``step_<k>``; a crash mid-save never corrupts the
    newest complete checkpoint, and restore takes the newest directory
    with a manifest, ignoring partial ones.
  * **Async**: ``save_async`` snapshots to host memory synchronously and
    writes in a background thread, overlapping the I/O with the next
    step; an error in the writer surfaces on the next ``wait``.
  * **Versioned**: keeps the newest ``keep`` checkpoints, deletes older.
  * The manifest records ``meta`` (the trainer's data step).
  * **Mesh-agnostic**: leaves are stored whole.  A tree with DTensor
    leaves (the sharded trainer's) is saved by every rank together: each
    leaf is gathered whole (``full_tensor``) and rank 0 writes, then the
    ranks meet at a barrier after a blocking save.  ``restore(...,
    shardings=)`` puts each leaf back onto the given layout
    (``models.pspec_utils.NamedPlacements``: a mesh and its placements),
    each rank keeping its blocks, so a checkpoint written under one mesh
    (or none) restores under another, bit for bit: the reference's
    elastic path.

A tree is nested dicts, lists, tuples and NamedTuples (the optimizer
state) whose leaves are tensors or Python ints; a leaf's key is its path
of dict keys, field names and indices joined by "/" (the parameters under
their state-dict names, ``params/blocks.0.wq``).  Leaves are stored as
full arrays in one ``shard_0.npz`` (one writer, one shard).  npz cannot
hold bfloat16 (or other 16-bit float types numpy lacks), so such a leaf
keeps its own 16 bits as int16 and the manifest's ``dtypes`` names its
type; restore reinterprets the bits.  That keeps minicpm-2b's bf16
parameters at 2 bytes each (about 27.2 GB with float32 moments, where the
reference's lossless float32 upcast writes about 32.7 GB).  Restore
checks every leaf's shape and casts it to the dtype and device of the
tree it restores into.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.pspec_utils import NamedPlacements

# torch dtypes numpy has no type for: stored as their raw 16 bits
_RAW16 = {"bfloat16": torch.bfloat16}


def _items(tree: Any, prefix: str = ""):
    """(key, leaf) pairs of a tree in order."""
    if isinstance(tree, dict):
        children = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        children = tree._asdict().items()
    elif isinstance(tree, (list, tuple)):
        children = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in children:
        yield from _items(v, f"{prefix}/{k}" if prefix else str(k))


def _flatten_with_paths(tree: Any) -> tuple[dict, dict]:
    """({key: numpy array}, {key: torch dtype name of a raw-16-bit leaf})
    copied to the host now."""
    flat, raw = {}, {}
    for key, leaf in _items(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()       # a collective: every rank
        if isinstance(leaf, torch.Tensor):
            # a copy, also of a CPU tensor: the trainer updates in place
            t = leaf.detach().to("cpu", copy=True)
            name = str(t.dtype).removeprefix("torch.")
            if name in _RAW16:
                t, raw[key] = t.view(torch.int16), name
            flat[key] = t.numpy()
        else:
            flat[key] = np.asarray(leaf)
    return flat, raw


def _unflatten_like(like: Any, leaf_of, prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaf_of, f"{prefix}/{k}" if prefix
                                   else str(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(**{
            k: _unflatten_like(v, leaf_of, f"{prefix}/{k}" if prefix
                               else k) for k, v in like._asdict().items()})
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaf_of, f"{prefix}/{i}"
                                          if prefix else str(i))
                          for i, v in enumerate(like))
    return leaf_of(prefix, like)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ---- save ----
    def _write(self, step: int, flat: dict[str, np.ndarray], raw: dict,
               meta: dict) -> None:
        tmp = os.path.join(self.directory, f"tmp.{step}.{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "shard_0.npz"), **flat)
        manifest = {"step": step, "time": time.time(), "n_shards": 1,
                    "keys": sorted(flat), "dtypes": raw, "meta": meta}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self.directory, f"step_{step:012d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def save(self, step: int, tree: Any, meta: dict | None = None,
             blocking: bool = True) -> None:
        """Snapshot ``tree`` now and write it (in the background unless
        ``blocking``).  A tree with DTensor leaves is saved by every rank:
        rank 0 writes, and a blocking save ends at a barrier."""
        self.wait()
        collective = any(isinstance(leaf, DTensor) for _, leaf in
                         _items(tree))
        flat, raw = _flatten_with_paths(tree)    # device->host snapshot NOW
        writer = not collective or dist.get_rank() == 0
        if blocking:
            if writer:
                self._write(step, flat, raw, meta or {})
            if collective:
                dist.barrier()
            return
        if not writer:
            return

        def run():
            try:
                self._write(step, flat, raw, meta or {})
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def save_async(self, step: int, tree: Any, meta: dict | None = None):
        self.save(step, tree, meta, blocking=False)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---- restore ----
    def _steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                manifest = os.path.join(self.directory, name, "manifest.json")
                if os.path.exists(manifest):
                    out.append(int(name[5:]))
        return sorted(out)

    @property
    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: int | None = None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of ``like``: each tensor leaf comes
        back with the dtype and on the device of ``like``'s, each int leaf
        as an int.  ``shardings``, a tree like ``like``'s with a
        :class:`~repro_torch.models.pspec_utils.NamedPlacements` (or None)
        a leaf, puts each leaf onto that layout as a DTensor; a DTensor
        leaf of ``like`` without one keeps its own layout.  Returns (tree,
        the manifest's meta)."""
        self.wait()
        step = step if step is not None else self.latest_step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:012d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        raw = manifest.get("dtypes", {})
        layouts = dict(_items(shardings)) if shardings is not None else {}
        with np.load(os.path.join(d, "shard_0.npz")) as data:
            def leaf_of(key, leaf):
                arr = data[key]
                shape = tuple(leaf.shape) if isinstance(
                    leaf, torch.Tensor) else np.shape(leaf)
                if tuple(arr.shape) != shape:
                    raise ValueError(f"shape mismatch for {key}: "
                                     f"ckpt {arr.shape} vs model {shape}")
                if not isinstance(leaf, torch.Tensor):
                    return type(leaf)(arr)
                t = torch.from_numpy(arr)
                if key in raw:
                    t = t.view(_RAW16[raw[key]])
                layout = layouts.get(key)
                if layout is None and isinstance(leaf, DTensor):
                    layout = NamedPlacements(leaf.device_mesh,
                                             tuple(leaf.placements))
                if layout is None:
                    return t.to(device=leaf.device, dtype=leaf.dtype)
                device = leaf.to_local().device if isinstance(
                    leaf, DTensor) else leaf.device
                return layout.distribute(t.to(device=device,
                                              dtype=leaf.dtype))

            tree = _unflatten_like(like, leaf_of)
        return tree, manifest["meta"]

    def _gc(self) -> None:
        steps = self._steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:012d}"),
                          ignore_errors=True)
