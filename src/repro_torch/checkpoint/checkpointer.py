"""Atomic, manifest-based numpy checkpointer.

Layout (one directory per step), the reference's:

    <dir>/step_00000420.tmp/...    (written first)
    <dir>/step_00000420/
        manifest.json              {step, leaves: [{path, file, shape, dtype}]}
        arr_00000.npy ...

Everything is written into ``step_N.tmp`` and renamed to ``step_N`` last,
so a crash mid-save leaves only a ``.tmp`` that restore ignores and the
next save replaces.  The ``keep`` newest checkpoints survive each save.

A tree is nested dicts (keys in sorted order, as JAX flattens them) whose
leaves are tensors, Python numbers or ``nn.Module``s (a module stands for
its named parameters).  numpy has
no bfloat16 without ``ml_dtypes``, so a bf16 tensor is stored as its raw
16-bit pattern and recorded as ``"bfloat16"`` in the manifest.

``Checkpointer.save_async`` copies every leaf to host memory before it
returns (the train step updates parameters in place, and ``.cpu()`` of a
CPU tensor would share its storage) and writes the files on a background
thread.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree, prefix: str = ""):
    """[(path, leaf)] in a fixed order; modules expand to their parameters."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], f"{prefix}{key}/")
        return out
    if isinstance(tree, nn.Module):
        return [(f"{prefix}{name}", p) for name, p in tree.named_parameters()]
    return [(prefix.rstrip("/"), tree)]


def _host_copy(value):
    """(numpy array, dtype name) holding a copy of one leaf."""
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(value)
    return arr, str(arr.dtype)


def _write(directory: str, step: int, leaves, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, arr, dtype) in enumerate(leaves):
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": path, "file": fname,
                                   "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    _gc(directory, keep)
    return final


def _snapshot(tree):
    return [(path, *_host_copy(v)) for path, v in _flatten(tree)]


def save(directory: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Synchronous atomic save; returns the checkpoint's path."""
    return _write(directory, step, _snapshot(tree), keep)


def _gc(directory: str, keep: int):
    steps = all_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list:
    """Steps with a complete checkpoint (a manifest) in ``directory``."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step, or None."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _load(path: str, entry: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, entry["file"]))
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rebuild(like, values: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {key: _rebuild(like[key], values, f"{prefix}{key}/")
                for key in like}
    if isinstance(like, nn.Module):
        with torch.no_grad():
            for name, p in like.named_parameters():
                p.copy_(values[f"{prefix}{name}"].to(p.dtype))
        return like
    t = values[prefix.rstrip("/")]
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return type(like)(t.item())


def restore(directory: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: each tensor leaf comes back
    with ``like``'s dtype and device, each number with its type, and each
    ``nn.Module`` in ``like`` has its parameters filled in place."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    values = {}
    for p, _ in _flatten(like):
        entry = by_path.get(p)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {p}")
        values[p] = _load(path, entry)
    return _rebuild(like, values)


class Checkpointer:
    """Keep-k async checkpoint manager bound to one directory."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any):
        """Copy ``tree`` to host memory now; write it on a background
        thread (one save in flight at a time)."""
        self.wait()
        leaves = _snapshot(tree)

        def _do():
            try:
                _write(self.directory, step, leaves, self.keep)
            except Exception as e:       # re-raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=_do, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the in-flight save; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        """The newest complete step in this directory, or None."""
        return latest_step(self.directory)

    def restore_latest(self, like):
        """(step, tree) of the newest checkpoint, or (None, None)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, restore(self.directory, step, like)
