"""Checkpoint save/restore — the counterpart of
``repro.ckpt.checkpoint``, in its on-disk layout:

    <dir>/step_<n>/
        manifest.json   step, n_leaves, treedef, extra, and per leaf its
                        idx, shape, dtype and sha256
        leaf_<i>.npy    one array per leaf, in ``train.tree.leaves``
                        order (sorted dict keys: ``jax.tree.flatten``'s
                        order for the same dict tree)

  * integrity: the sha256 of each leaf file, checked on load (a torn
    write raises ``IOError``);
  * atomicity: everything is written to ``step_<n>.tmp``, each file
    fsynced, then the directory renamed;
  * async save: ``Checkpointer.save_async`` copies the tree's tensors to
    the host synchronously (the train step updates its state in place;
    numpy arrays are taken as they are, as the reference takes them) and
    writes it on a worker thread; ``wait`` joins it; the newest ``keep``
    steps are kept.

A checkpoint of the same tree written by either package loads in the
other (``train.step.state_to_tree`` gives the train state the
reference's tree).  The reference writes ``str(treedef)`` (a JAX
PyTreeDef) into the manifest and never reads it back; the port writes
its own description of the structure there (``train.tree.describe``)
and does not read it either: a load checks the leaf count.  A bf16 leaf
is saved as an ``ml_dtypes.bfloat16`` array, as the reference's numpy
holds it (``ml_dtypes`` is needed to save one, not to load it).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train import tree


def _to_numpy(leaf) -> np.ndarray:
    """A host array of ``leaf`` (a tensor, array or scalar); a bf16
    tensor becomes an ``ml_dtypes.bfloat16`` array."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            raise RuntimeError(
                "saving a bf16 leaf needs the ml_dtypes package (numpy's "
                "bfloat16, as the reference saves it); it is not "
                "installed") from None
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _host_copy(leaf):
    """The snapshot ``save_async`` takes: an owned host copy of a tensor
    (the train step updates its state in place); an array is taken as it
    is, as the reference's ``np.asarray`` takes it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


class _Hashing:
    """A write-only file that hashes what passes through it, so a leaf is
    hashed as it is written (numpy writes a non-file object in chunks)."""

    def __init__(self, f):
        self.f = f
        self.sha = hashlib.sha256()

    def write(self, b) -> int:
        self.sha.update(b)
        return self.f.write(b)


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def save_checkpoint(ckpt_dir: str, step: int, tree_: Any,
                    extra: Optional[dict] = None) -> str:
    """Synchronous atomic save.  Returns the final directory path."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = tree.leaves(tree_)
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": tree.describe(tree_), "extra": extra or {},
                "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = _to_numpy(leaf)
        with open(os.path.join(tmp, f"leaf_{i}.npy"), "wb") as f:
            h = _Hashing(f)
            np.save(h, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({
            "idx": i, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": h.sha.hexdigest()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def load_checkpoint(ckpt_dir: str, tree_like: Any,
                    step: Optional[int] = None) -> tuple[Any, int]:
    """Load the latest (or the given) step into the structure of
    ``tree_like``: each leaf a tensor on the device of ``tree_like``'s
    leaf (the CPU where that is a meta tensor or not a tensor).  Checks
    integrity; raises on corruption (``IOError``) and on a leaf count
    that differs (``ValueError``)."""
    if step is None:
        steps = _steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        step = steps[-1]
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = tree.leaves(tree_like)
    if len(like) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, tree_like has "
            f"{len(like)} — structure mismatch")
    out = []
    for i, (meta, want) in enumerate(zip(manifest["leaves"], like)):
        with open(os.path.join(path, f"leaf_{i}.npy"), "rb") as f:
            raw = f.read()
        if hashlib.sha256(raw).hexdigest() != meta["sha256"]:
            raise IOError(f"checkpoint leaf {i} corrupt (sha mismatch) in "
                          f"{path}")
        arr = np.load(io.BytesIO(raw))
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        dev = want.device if isinstance(want, torch.Tensor) else None
        out.append(t if dev is None or dev.type in ("cpu", "meta")
                   else t.to(dev))
    return tree.unflatten(tree_like, out), step


class Checkpointer:
    """Async checkpointer: snapshot to the host, save on a worker
    thread.  Unlike the reference's, a save that fails raises at the
    next ``wait`` (or ``save_async`` / ``restore``), not only on the
    worker thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save_async(self, step: int, tree_: Any,
                   extra: Optional[dict] = None) -> None:
        self.wait()
        host_tree = tree.tree_map(_host_copy, tree_)     # sync snapshot

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except BaseException as e:    # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; a save that failed raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _gc(self) -> None:
        for s in _steps(self.ckpt_dir)[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)

    def restore(self, tree_like: Any, step: Optional[int] = None):
        self.wait()
        return load_checkpoint(self.ckpt_dir, tree_like, step)
