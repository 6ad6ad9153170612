"""Checkpoints with atomic save and restore onto the caller's devices (port
of ``repro.ckpt.checkpoint``; the port keeps its own copy).

Layout (one directory per step, atomically renamed on completion):

    <root>/step_00000100.tmp/...    (in-flight)
    <root>/step_00000100/
        manifest.json               {"step", "leaves": [{"key", "file",
                                     "shape", "dtype"}, ...], "meta": {...}}
        arr_00000.npy ...

* a checkpoint is valid iff the final rename happened, so a crash mid-save
  never corrupts the latest checkpoint;
* ``latest_step`` scans for the highest complete step directory;
* ``restore`` places each leaf on the device of the matching tensor in
  ``like``, or where a matching tree of ``shardings`` says: a
  ``runtime/sharding.py`` ``Sharding`` (every rank reads the full array and
  keeps its part: no broadcast) or a device.  Checkpoints hold full arrays,
  so a state saved on one mesh (or none) restores onto any other;
* in a process group of several ranks (an SPMD program: every rank calls
  ``save`` with the same tree) rank 0 writes and every rank waits for it at
  a barrier; a sharded leaf (a ``DTensor``) is gathered to its full array
  first.

A tree is a dataclass (leaves keyed by field name, as the reference keys a
registered dataclass), a dict (by key), a list or tuple (by index), or a
leaf: a tensor or a numpy array.  ``None`` holds no leaf.  Leaves are
saved as numpy arrays in their own dtype; on restore a 32-bit integer leaf
saved in the other signedness (packed words saved as uint32, carried as
int32) comes back with the same bits, and a bfloat16 leaf is saved as its
raw 16-bit words (numpy has no bfloat16), as the reference's files hold it.

Async: ``AsyncCheckpointer.save_async`` copies the tree to host memory on
the caller's thread (a copy of a CPU tensor too: the caller may go on to
write its tensors in place, as the train step does) and writes it on a
background thread; ``wait()`` joins before the next save or at exit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.runtime import sharding as shd

_KEY_SEP = "/"


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _is_place(x) -> bool:
    return isinstance(x, (shd.Sharding, torch.device, str))


def _children(tree) -> list[tuple[str, Any]]:
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _map(fn: Callable, tree: Any, prefix: str = "", is_leaf=_is_leaf) -> Any:
    """The tree with every leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(prefix, tree)
    kids = {name: _map(fn, child, f"{prefix}{_KEY_SEP}{name}" if prefix else name,
                       is_leaf)
            for name, child in _children(tree)}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **kids)
    if isinstance(tree, dict):
        return {k: kids[str(k)] for k in tree}
    return type(tree)(kids[str(i)] for i in range(len(tree)))


def _flatten(tree: Any, is_leaf=_is_leaf) -> list[tuple[str, Any]]:
    """(key, leaf) pairs in tree order, keys joined by ``/``."""
    out: list[tuple[str, Any]] = []
    _map(lambda key, leaf: out.append((key, leaf)), tree, is_leaf=is_leaf)
    return out


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _barrier() -> None:
    """Wait for every rank, over the group's CPU backend (no device
    collective)."""
    dist.all_reduce(torch.zeros(1))


# numpy has no bfloat16: a bf16 leaf is saved as its raw 16-bit words, a
# two-byte void array, which is what the reference's files hold for one
_BF16_WORDS = np.dtype("V2")


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a numpy array; with ``copy`` it shares no memory with the
    leaf (a CPU tensor's ``numpy()`` would)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_WORDS)
        return t.numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _BF16_WORDS
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return leaf.dtype


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)  # hard link: refcounted, safe across _gc removals
    except OSError:  # cross-device root or a filesystem without links
        shutil.copy2(src, dst)


def save(root: str, step: int, tree: Any, meta: dict | None = None,
         link_from: dict[str, str] | None = None,
         aot: dict | None = None) -> str:
    """Synchronous atomic save; returns the final directory.

    ``aot`` (optional): ``{"path": <artifact dir>, "key": runtime/aot.py's
    artifact_key()}``, recorded as the manifest's ``aot`` entry: the deploy
    artifact a restarted worker warms from (``StreamingFleet.from_artifact``).

    ``link_from`` (optional): ``{leaf key: existing .npy path}`` for leaves the caller
    knows are unchanged since a previous step; they are hard-linked (copied
    where links are unsupported) instead of written, and a linked file whose
    shape or dtype differs from the live leaf raises.

    In a group of several ranks every rank calls ``save``: sharded leaves
    are gathered, rank 0 writes, and all return after it has."""
    final = os.path.join(root, f"step_{step:08d}")
    tree = _map(lambda _, leaf: leaf.full_tensor() if isinstance(leaf, DTensor)
                else leaf, tree)
    if _world() > 1:
        if dist.get_rank() == 0:
            _write(final, step, tree, meta, link_from, aot)
        _barrier()
        return final
    _write(final, step, tree, meta, link_from, aot)
    return final


def _write(final: str, step: int, tree: Any, meta: dict | None,
           link_from: dict[str, str] | None, aot: dict | None) -> None:
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "meta": meta or {}}
    if aot is not None:
        manifest["aot"] = aot
    link_from = link_from or {}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        fname = f"arr_{i:05d}.npy"
        src = link_from.get(key)
        if src is not None:
            header = np.load(src, mmap_mode="r")  # header only, no read
            want = _np_dtype(leaf)
            if tuple(header.shape) != tuple(leaf.shape) or header.dtype != want:
                raise ValueError(
                    f"link_from[{key!r}]: {src} holds "
                    f"{header.dtype}{tuple(header.shape)}, live leaf is "
                    f"{want}{tuple(leaf.shape)}")
            shape, dtype = list(header.shape), str(header.dtype)
            del header
            _link_or_copy(src, os.path.join(tmp, fname))
        else:
            arr = _host(leaf)
            np.save(os.path.join(tmp, fname), arr)
            shape = list(arr.shape)
            dtype = "bfloat16" if arr.dtype == _BF16_WORDS else str(arr.dtype)
        manifest["leaves"].append({"key": key, "file": fname,
                                   "shape": shape, "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def leaf_files(root: str, step: int) -> dict[str, str]:
    """``{leaf key: absolute .npy path}`` for one saved step: the source map
    of an incremental ``save(..., link_from=...)``."""
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    return {leaf["key"]: os.path.join(d, leaf["file"])
            for leaf in manifest["leaves"]}


class AsyncCheckpointer:
    """Snapshot on the caller thread, write on a background thread.

    In a group of several ranks every rank calls ``save_async`` at the same
    steps: sharded leaves are gathered on the caller thread (a collective
    of every rank), rank 0 writes in the background, and ``wait`` (which
    the next ``save_async`` calls first) returns on every rank once the
    write has landed, so a restart on any rank finds it."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._pending = False

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending and _world() > 1:
            _barrier()
        self._pending = False

    def save_async(self, step: int, tree: Any, meta: dict | None = None):
        self.wait()
        tree = _map(lambda _, leaf: leaf.full_tensor() if isinstance(leaf, DTensor)
                    else leaf, tree)
        host_tree = _map(lambda _, leaf: _host(leaf, copy=True), tree)
        self._pending = True
        if _world() > 1 and dist.get_rank() != 0:
            return
        final = os.path.join(self.root, f"step_{step:08d}")

        def _write_step():
            _write(final, step, host_tree, meta, None, None)
            _gc(self.root, self.keep)

        self._thread = threading.Thread(target=_write_step, daemon=True)
        self._thread.start()


def _gc(root: str, keep: int):
    steps = sorted(list_steps(root))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)


def list_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = re.fullmatch(r"step_(\d{8})", name)
        if m and os.path.exists(os.path.join(root, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = list_steps(root)
    return steps[-1] if steps else None


def _like_leaf(arr: np.ndarray, like, key: str, where=None):
    """A loaded array as the leaf ``like`` is: a tensor of its dtype on its
    device (or placed by ``where``: a ``Sharding`` or a device), or a numpy
    array."""
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                         f"{tuple(like.shape)}")
    if not isinstance(like, torch.Tensor):
        return arr
    if like.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "Viu":
            raise ValueError(f"dtype mismatch for {key}: ckpt {arr.dtype} vs bfloat16")
        words = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return _placed(words.view(torch.bfloat16), like, where)
    want = _np_dtype(like)
    if arr.dtype != want:
        if arr.dtype.kind not in "iu" or want.kind not in "iu" \
                or arr.dtype.itemsize != want.itemsize:
            raise ValueError(f"dtype mismatch for {key}: ckpt {arr.dtype} vs "
                             f"{want}")
        arr = arr.view(want)  # the same bits in the other signedness
    return _placed(torch.from_numpy(np.ascontiguousarray(arr)), like, where)


def _placed(t: torch.Tensor, like: torch.Tensor, where) -> torch.Tensor:
    return t.to(like.device) if where is None else shd.place(t, where)


def restore(root: str, step: int, like: Any, shardings: Any = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors or numpy
    arrays).  ``shardings``: a matching tree of ``Sharding``s, devices or
    None; each tensor leaf comes back where its entry says (its ``like``
    leaf may then be a ``meta`` tensor, for the shape and dtype), else on
    its ``like`` leaf's device."""
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    where = dict(_flatten(shardings, is_leaf=_is_place)) if shardings is not None else {}

    def load(key, leaf):
        arr = np.load(os.path.join(d, by_key[key]["file"]))
        return _like_leaf(arr, leaf, key, where.get(key))

    return _map(load, like)


def restore_latest(root: str, like: Any, shardings: Any = None):
    step = latest_step(root)
    if step is None:
        return None, None
    return step, restore(root, step, like, shardings)
