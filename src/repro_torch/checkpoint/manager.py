"""Async, restart-exact checkpointing (port of
``repro.checkpoint.manager``), on the reference's on-disk layout::

    <dir>/step_000000123.tmp/        # written, then atomically renamed
        manifest.json                # leaf names, shapes, dtypes, step
        h0000/leaf_000042.npy        # leaf 42 (bf16 stored as uint16)
        ...
    <dir>/step_000000123/            # committed

Leaves are named and ordered as the reference names and orders them
(``jax.tree_util`` paths joined by "/": dict keys sorted, tuple indices,
a NamedTuple's fields as ".field"; an ``AdamWState`` gives "opt/.step",
"opt/.m/...", "opt/.v/..."), so a checkpoint either package wrote
restores into the other, bit for bit.

  * commit is the atomic rename -- a crashed writer leaves only *.tmp
    dirs, which restore ignores and the next commit removes;
  * ``keep_last`` committed steps are kept;
  * saves are async (a background thread) with a join barrier before
    the next save; the leaves are copied to host memory on the caller's
    thread first, so the train loop may update them in place meanwhile;
  * restore matches leaves by name (then by index) and casts each to
    the template leaf's dtype, on the device asked for.

The port runs one process: it writes ``h0000`` only.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

PyTree = Any

_SEP = "/"



def _flatten_with_paths(tree: PyTree, path: tuple = ()
                        ) -> list[tuple[str, Any]]:
    """(name, leaf) in the reference's flatten order and naming."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flatten_with_paths(getattr(tree, f),
                                             path + ("." + f,))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_paths(tree[k], path + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _flatten_with_paths(v, path + (str(i),))]
    return [(_SEP.join(path), tree)]


def _rebuild(tree: PyTree, values: dict[str, Any], path: tuple = ()
             ) -> PyTree:
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), values,
                                     path + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, values, path + (str(i),))
                          for i, v in enumerate(tree))
    return values[_SEP.join(path)]


def _to_host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """(numpy data to write, the manifest's dtype name)."""
    t = leaf.detach().to("cpu", copy=True)   # a copy, also of a CPU leaf
    name = str(t.dtype).removeprefix("torch.")   # numpy's name
    if t.dtype == torch.bfloat16:   # numpy has no bf16: its bits as uint16
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_host(data: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(data.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(data, copy=True))


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- helpers -------------------------------------------------------------
    def _step_dir(self, step: int, tmp: bool = False) -> str:
        return os.path.join(self.dir, f"step_{step:09d}" + (".tmp" if tmp
                                                            else ""))

    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: PyTree, *, blocking: bool = False,
             extra: dict | None = None):
        """Async checkpoint of a tree of tensors (dicts, tuples, lists,
        NamedTuples)."""
        self.wait()
        payload = []
        manifest_leaves = []
        for i, (name, leaf) in enumerate(_flatten_with_paths(tree)):
            data, dtype_name = _to_host(leaf)
            payload.append((i, data))
            manifest_leaves.append({"name": name, "index": i,
                                    "shape": list(leaf.shape),
                                    "dtype": dtype_name})
        manifest = {"step": step, "leaves": manifest_leaves,
                    "n_hosts": 1, "extra": extra or {}}

        def _write():
            tmp = self._step_dir(step, tmp=True)
            hdir = os.path.join(tmp, "h0000")
            os.makedirs(hdir, exist_ok=True)
            for i, data in payload:
                np.save(os.path.join(hdir, f"leaf_{i:06d}.npy"), data)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = self._step_dir(step)
            if not os.path.exists(final):
                os.replace(tmp, final)
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        for d in os.listdir(self.dir):  # orphaned tmp dirs from crashes
            if d.endswith(".tmp"):
                full = os.path.join(self.dir, d)
                step = int(d[5:-4])
                if step in steps:
                    shutil.rmtree(full, ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, tree_like: PyTree, step: int | None = None,
                device: str | torch.device | None = None
                ) -> tuple[PyTree, dict]:
        """Restore into the structure of ``tree_like`` (its leaves give the
        dtypes; meta tensors will do) on ``device`` (default: where each
        template leaf lies, the CPU for a meta leaf).  Returns (tree,
        manifest extra)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_index = {m["index"]: m for m in manifest["leaves"]}
        by_name = {m["name"]: m for m in manifest["leaves"]}
        values = {}
        for i, (name, leaf) in enumerate(_flatten_with_paths(tree_like)):
            meta = by_name.get(name, by_index.get(i))
            if meta is None:
                raise KeyError(f"leaf {name!r} missing from checkpoint")
            data = np.load(os.path.join(d, "h0000",
                                        f"leaf_{meta['index']:06d}.npy"))
            t = _from_host(data, meta["dtype"])
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"leaf {name!r}: checkpoint shape "
                                 f"{tuple(t.shape)}, template "
                                 f"{tuple(leaf.shape)}")
            dev = device if device is not None else (
                "cpu" if leaf.device.type == "meta" else leaf.device)
            values[name] = t.to(device=dev, dtype=leaf.dtype)
        return _rebuild(tree_like, values), manifest.get("extra", {})
