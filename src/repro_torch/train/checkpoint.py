"""Atomic, versioned, async checkpointing with auto-resume (counterpart of
``repro.train.checkpoint``, with its on-disk layout).

Layout:   <dir>/step_<N:08d>/      (complete iff its COMMIT file exists)
              arrays_p<proc>.npz   leaf i of the flattened tree as ``a<i>``
              meta.json            step, the leaves' "/"-joined paths, time
          <dir>/step_<N:08d>.tmp/  in-progress writes (never resumed)

Trees are nested dicts of tensors, flattened as the reference flattens
them: dict keys sorted at every level, paths joined with "/". A
checkpoint either package writes restores in the other, leaf for leaf by
path.

Writes go to a ``.tmp`` directory; ``os.replace`` after the COMMIT
marker is the commit point, so a killed process never leaves a
half-readable checkpoint. ``save_async`` copies the tree to host memory
at once, then a thread serializes it while training goes on; ``wait``
joins it (and re-raises its error) before the next save.
``restore_latest`` picks the newest committed step, so a crash mid-save
falls back to the previous checkpoint; ``keep_n`` old checkpoints are
deleted after each commit.

bfloat16 leaves have no numpy type: they are written as their raw
2-byte words (numpy ``<V2``), which is what the reference's ``np.savez``
writes for its bfloat16 leaves, and a ``V2`` leaf is read back as
bfloat16 when the ``like`` leaf is bfloat16. (The reference itself
cannot restore such a leaf: ``jax.device_put`` refuses the ``V2`` array
``np.load`` returns, so it cannot resume a bfloat16 run.)
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import sorted_leaves

Tree = Any


def _rebuild(like: Tree, leaves, prefix: str = "") -> Tree:
    """``like``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    return leaves[prefix[:-1]]


def to_host(leaf: torch.Tensor) -> np.ndarray:
    """A copy of a leaf as a host numpy array; bfloat16 as its raw
    ``<V2`` words."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("<V2")
    return t.numpy()


def from_host(arr: np.ndarray, like: torch.Tensor, key: str) -> torch.Tensor:
    """A stored leaf as a tensor on ``like``'s device, in the stored
    dtype; a ``V2`` leaf is read as bfloat16, which ``like`` must be."""
    device = like.device
    if arr.dtype.kind == "V":
        if not (like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2):
            raise ValueError(f"leaf {key!r}: stored as raw {arr.dtype} "
                             f"words, which only a bfloat16 leaf reads")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_n: int = 3,
                 process_index: int = 0):
        self.dir = directory
        self.keep_n = keep_n
        self.process_index = process_index
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    @staticmethod
    def _snapshot(tree: Tree) -> List[Tuple[str, np.ndarray]]:
        return [(k, to_host(leaf)) for k, leaf in sorted_leaves(tree)]

    def save(self, step: int, tree: Tree) -> str:
        """Synchronous save. Returns the committed directory."""
        return self._write(step, self._snapshot(tree))

    def save_async(self, step: int, tree: Tree) -> None:
        """Copy the tree to host memory now, write it on a thread."""
        self.wait()
        flat = self._snapshot(tree)

        def worker():
            try:
                self._write(step, flat)
            except BaseException as e:  # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background write; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, flat) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, f"arrays_p{self.process_index}.npz"),
                 **{f"a{i}": leaf for i, (_, leaf) in enumerate(flat)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "keys": [k for k, _ in flat],
                       "time": time.time()}, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                path = os.path.join(self.dir, name)
                if os.path.exists(os.path.join(path, "COMMIT")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Tree) -> Tree:
        """Step ``step`` in the structure of ``like``: every leaf of
        ``like`` must be stored under its path at its shape; each comes
        back on the ``like`` leaf's device."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(
                path, f"arrays_p{self.process_index}.npz")) as data:
            by_key = {k: data[f"a{i}"] for i, k in enumerate(meta["keys"])}
        leaves = {}
        for key, leaf in sorted_leaves(like):
            if key not in by_key:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = by_key[key]
            want = tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf {key!r}: checkpoint {arr.shape} vs "
                                 f"model {want}")
            leaves[key] = from_host(arr, leaf, key)
        return _rebuild(like, leaves)

    def restore_latest(self, like: Tree) -> Tuple[Optional[int], Tree]:
        step = self.latest_step()
        if step is None:
            return None, like
        return step, self.restore(step, like)
