"""Checkpoints with async save and atomic commit: the counterpart of
``src/repro/checkpoint/checkpointer.py``, in its on-disk layout.

Layout (one directory per step):
    ckpt_dir/step_000123/
        manifest.json     — {"step", "leaves": [{"path", "shape", "dtype"}]}
        arrays/<idx>.npy  — one file per leaf (the whole array)
        COMMIT            — written last; restore ignores uncommitted dirs

Leaf paths are the JAX package's strings (``params/blocks/0/attn/wq``,
``opt/.step``, ``opt/.m/...``; ``repro_torch.tree``), so a float32
checkpoint written by either package restores in the other.  A bfloat16
leaf is written as the JAX package writes it, its 16-bit patterns as a
2-byte void array with ``"dtype": "bfloat16"`` in the manifest; unlike the
reference's restore (which raises on that file), this restore reads it
back as bfloat16.

Fault-tolerance contract used by the Trainer:
  - save is atomic (tmp dir + rename + COMMIT marker): a crash mid-save
    never corrupts the latest checkpoint;
  - the device-to-host copy is synchronous (a consistent snapshot), the
    file writes run on a thread;
  - restore loads into the structure of a like tree, each leaf on the like
    leaf's device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from .. import tree as tr

_BF16_FILE = np.dtype("V2")


def _to_host(t: torch.Tensor):
    """(numpy array to save, manifest dtype) of one leaf: a copy, since
    the trainer updates its tensors in place while the thread writes."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_FILE), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_file(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {a.dtype}")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, blocking: bool = False):
        """Device→host transfer happens synchronously (values are snapshot-
        consistent); file IO happens on a background thread."""
        self.wait()
        flat = tr.flatten_with_paths(tree)
        host = [(p, *_to_host(leaf)) for p, leaf in flat]

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step:09d}")
            final = os.path.join(self.dir, f"step_{step:09d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(os.path.join(tmp, "arrays"))
            manifest = dict(step=step, leaves=[])
            for i, (p, a, dtype) in enumerate(host):
                np.save(os.path.join(tmp, "arrays", f"{i}.npy"), a)
                manifest["leaves"].append(
                    dict(path=p, shape=list(a.shape), dtype=dtype))
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            with open(os.path.join(final, "COMMIT"), "w") as f:
                f.write("ok")
            self._gc()

        if self.async_save and not blocking:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def committed_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "COMMIT")):
                out.append(int(name.split("_")[1]))
        return out

    def latest_step(self):
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree):
        """A tree of ``like_tree``'s structure holding the saved values, each
        leaf in its saved dtype on its like leaf's device (the JAX
        function's ``shardings`` have no counterpart on one device)."""
        final = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(final, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {l["path"]: (i, l["dtype"])
                   for i, l in enumerate(manifest["leaves"])}
        out = []
        for p, ref in tr.flatten_with_paths(like_tree):
            idx, dtype = by_path[p]
            a = np.load(os.path.join(final, "arrays", f"{idx}.npy"))
            assert list(a.shape) == list(ref.shape), (p, a.shape, ref.shape)
            out.append(_from_file(a, dtype).to(ref.device))
        return tr.unflatten(like_tree, out)
