"""Atomic, async checkpointing (port of ``repro.checkpoint.manager``).

Guarantees, as in the reference:

* **Atomic** — a checkpoint directory becomes visible only via os.rename of
  a fully-written temp dir; a crash mid-save never corrupts the latest
  restorable state.
* **Async** — the save copies the tensors to host memory on the caller's
  thread and hands the file write to a background thread; ``wait()`` drains
  pending writes. The copy is complete before ``maybe_save`` returns, also
  for tensors already on the CPU: the train step updates its tensors in
  place (``optim.adamw_update``), where the reference's arrays are
  immutable, so the writer must never see a tensor the next step mutates.
* **Portable** — arrays are saved whole, under the reference's keys, so a
  checkpoint written by either package restores in the other: a tree's
  leaves are keyed by the dict keys and positions on their path
  (``tree.flatten_with_path``; a ``TrainState`` gives ``0/...`` params,
  ``1/0/...`` and ``1/1/...`` the moments, ``1/2`` the count, ``2`` the step
  and ``3/...`` the compression residual). Restore takes a template tree
  (``meta`` tensors will do) and the device to load onto.
* **Elastic** — a tree of DTensors is saved whole, and restore takes
  target shardings: a spec tree and a mesh (``steps.train_state_shardings``),
  so a state saved on one mesh restores onto another, each rank keeping
  its shard (sliced on the host before it moves to the device).
* **One writer** — in a process group every rank calls ``maybe_save`` (the
  gather of each DTensor leaf is a collective), and only global rank 0
  writes, prunes and updates ``LATEST``. ``sync()`` drains the write and
  holds every rank at a barrier until it is on disk; ``latest()`` and
  ``restore_latest`` sync first, so all ranks see the same checkpoints.

Layout:  <dir>/step_<n:08d>/{arrays.npz, meta.json} ; <dir>/LATEST (text).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tree as tree_lib

Tree = Any


def _host_array(leaf) -> np.ndarray:
    """A leaf as a numpy array that shares no memory with the leaf (a
    DTensor gathered whole)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _in_group() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _writer() -> bool:
    """Whether this process writes checkpoints: global rank 0 of a process
    group, or a process outside any."""
    return not _in_group() or dist.get_rank() == 0


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    return {key: _host_array(leaf)
            for key, leaf in tree_lib.flatten_with_path(tree)}


def save_checkpoint(directory: str, step: int, tree: Tree) -> str:
    """Synchronous atomic save. Returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "n_arrays": len(arrays)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # LATEST is advisory; restore scans directories as the source of truth.
    with open(os.path.join(directory, "LATEST"), "w") as f:
        f.write(str(step))
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "meta.json")):
                steps.append(int(d[5:]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template: Tree,
                       step: Optional[int] = None, device=None,
                       shardings: Optional[Tree] = None, mesh=None) -> Tree:
    """Restore into the structure of ``template``, whose tensor leaves give
    each array's shape, dtype, ``requires_grad`` and, unless ``device`` is
    given, its device (a ``meta`` template needs ``device``). With
    ``shardings`` (a spec tree of ``template``'s structure) and ``mesh``,
    each leaf becomes a DTensor on ``mesh`` placed by its spec, on the
    mesh's device."""
    if mesh is not None:
        device = mesh.device_type
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in tree_lib.flatten_with_path(template):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            dev = leaf.device if device is None else torch.device(device)
            t = torch.from_numpy(arr)
            if shardings is not None:
                from repro_torch.runtime import sharding as shd
                spec = shd.spec_at(shardings, key)
                t = shd.from_local(
                    shd.local_part(t, spec, mesh).to(device=dev,
                                                     dtype=leaf.dtype),
                    spec, mesh, arr.shape)
            else:
                t = t.to(device=dev, dtype=leaf.dtype)
            leaves.append(t.requires_grad_(leaf.requires_grad))
    return tree_lib.unflatten(template, leaves)


class CheckpointManager:
    """Periodic async checkpoints with retention."""

    def __init__(self, directory: str, *, period: int = 100, keep: int = 3):
        self.directory = directory
        self.period = period
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def maybe_save(self, step: int, tree: Tree, *, force: bool = False):
        if not force and (step == 0 or step % self.period):
            return False
        self.wait()
        # Copy to host on the caller thread (device -> host is the sync
        # part, and the copy must precede the next in-place step); the file
        # write happens in the background, on the writer alone.
        if not _writer():
            tree_lib.map_leaves(
                lambda x: x.full_tensor() if isinstance(x, DTensor) else x,
                tree)
            return True
        host_tree = tree_lib.map_leaves(_host_array, tree)

        def _write():
            try:
                save_checkpoint(self.directory, step, host_tree)
                self._prune()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def sync(self):
        """Drain this rank's write, then wait at a barrier for every rank:
        after it, the writer's checkpoints are on disk for all."""
        self.wait()
        if _in_group():
            dist.barrier()

    def latest(self) -> Optional[int]:
        """The newest complete checkpoint's step, the same on every rank."""
        self.sync()
        return latest_step(self.directory)

    def _prune(self):
        steps = sorted(
            int(d[5:]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, template: Tree, device=None,
                       shardings: Optional[Tree] = None, mesh=None):
        self.sync()
        return restore_checkpoint(self.directory, template, device=device,
                                  shardings=shardings, mesh=mesh)
