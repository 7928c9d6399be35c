"""Fault-tolerant checkpointing: atomic, async, elastic (the JAX
package's ``runtime/checkpoint.py``, on its on-disk format).

* atomic  — writes go to ``step_N.tmp/`` and are renamed only after the
            manifest fsyncs, so a crash mid-write never corrupts the
            latest checkpoint (restore always reads the newest *valid*
            manifest); an older ``step_N`` is moved aside to
            ``step_N.old.<pid>.<ns>`` first, and ``_recover`` renames an
            orphaned one back.
* async   — ``save_async`` copies the tree to the host on the caller's
            thread, then serializes in a background thread; the
            training loop loses only the device-to-host copy time.
* elastic — the tree is stored unsharded; ``restore`` hands each leaf
            to the caller's ``shardings`` (a device, or a function from
            the global tensor to this rank's slice), so a job can come
            back at another world size.

The format is the reference's: ``step_N/arrays.npz`` holds leaf ``i``
as ``a{i}``, a bf16 leaf as its ``uint16`` words with the dtype name
"bfloat16" in ``manifest.json``, and the manifest names each leaf as the
reference names it (``runtime/tree.py``), so either package reads the
other's checkpoint of a dict of arrays.  A leaf may be a tensor (on any
device), a numpy array or a number.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from . import tree as tree_lib

# Test seam for crash injection: when set, called with a tag string at
# the crash-sensitive points of ``_write`` (see ``_crashpoint``).  The
# atomicity tests install a hook that raises, emulating a process kill
# between the unpublish and the publish rename.
_CRASH_HOOK = None


def _crashpoint(tag: str) -> None:
    if _CRASH_HOOK is not None:
        _CRASH_HOOK(tag)


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: pathlib.Path) -> None:
    """fsync a directory so the rename/creat entries inside it are
    durable — flushing file *contents* alone does not persist the
    directory entry that names them."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platforms without O_RDONLY directory fds
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _flatten_with_names(tree: Any):
    pairs = tree_lib.leaves_with_path(tree)
    return [tree_lib.name(p) for p, _ in pairs], [leaf for _, leaf in pairs]


def _to_host(leaf: Any) -> np.ndarray:
    """A leaf as a host numpy array; a bf16 tensor as ``uint16`` words
    (``_HostBF16``), since numpy has no bf16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _HostBF16(t.contiguous().view(torch.int16).numpy().view(np.uint16))
        return t.numpy()
    return np.asarray(leaf)


class _HostBF16(np.ndarray):
    """A bf16 leaf's ``uint16`` words that remember their dtype name."""

    def __new__(cls, words: np.ndarray):
        return np.asarray(words).view(cls)


def _host_tree(tree: Any) -> Any:
    return tree_lib.tree_map(_to_host, tree)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if isinstance(a, _HostBF16) else str(a.dtype)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None
        self._recover()

    def _recover(self) -> None:
        """Finish interrupted publishes.  ``_write`` moves an existing
        ``step_N`` aside to a unique ``step_N.old.<pid>.<ns>`` before
        renaming the new tmp into place; a crash between the two renames
        leaves the step with only the ``.old`` copy.  On startup, any
        orphaned valid ``.old`` whose final is missing is renamed back —
        so there is never a step with zero valid checkpoints."""
        for old in sorted(self.dir.glob("step_*.old.*")):
            final = self.dir / old.name.split(".old.")[0]
            if not final.exists() and (old / "manifest.json").exists():
                old.rename(final)
            else:
                shutil.rmtree(old, ignore_errors=True)

    # ----------------------------------------------------------- save --
    def save(self, step: int, tree: Any, extra: dict | None = None):
        self._write(step, _host_tree(tree), extra or {})

    def save_async(self, step: int, tree: Any, extra: dict | None = None):
        """Snapshot now, serialize in the background."""
        self.wait()
        host_tree = _host_tree(tree)

        def work():
            try:
                self._write(step, host_tree, extra or {})
            except Exception as e:  # noqa: BLE001
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _write(self, step: int, host_tree: Any, extra: dict):
        names, leaves = _flatten_with_names(host_tree)
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays, dtypes = {}, []
        for i, lf in enumerate(leaves):
            a = lf if isinstance(lf, _HostBF16) else np.asarray(lf)
            dtypes.append(_dtype_name(a))
            if (isinstance(a, _HostBF16) or a.dtype.kind == "V"
                    or "bfloat16" in str(a.dtype)):
                a = np.asarray(a).view(np.uint16)  # npz-safe raw storage for bf16
            arrays[f"a{i}"] = a
        with open(tmp / "arrays.npz", "wb") as f:
            np.savez(f, **arrays)
            _fsync_file(f)
        manifest = {"step": step, "names": names, "time": time.time(),
                    "extra": extra, "dtypes": dtypes,
                    "shapes": [list(a.shape) for a in arrays.values()]}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            _fsync_file(f)          # manifest durable before any rename
        _fsync_dir(tmp)
        if final.exists():
            # never rmtree the live checkpoint before the replacement is
            # in place: move it aside under a unique recoverable name,
            # publish, then drop it.  A crash between the two renames
            # leaves either the old or the new copy on disk (never
            # neither); _recover() renames an orphaned .old back.
            old = self.dir / f"step_{step}.old.{os.getpid()}.{time.time_ns()}"
            final.rename(old)
            _crashpoint("publish")
            tmp.rename(final)       # atomic publish
            shutil.rmtree(old, ignore_errors=True)
        else:
            _crashpoint("publish")
            tmp.rename(final)       # atomic publish
        _fsync_dir(self.dir)        # the publish rename itself durable
        self._gc()

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -------------------------------------------------------- restore --
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p.suffix == ".tmp" or ".old." in p.name
                    or not (p / "manifest.json").exists()):
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: int | None = None,
                shardings: Any = None) -> tuple[int, Any, dict]:
        """Rebuild a ``like``-structured tree of tensors, each in its
        ``like`` leaf's dtype.  ``shardings`` (optional, a tree matching
        ``like``) places each leaf: a ``torch.device``, or a function
        from the global tensor to this rank's tensor (the elastic-resize
        path; the shape check is then the function's); without it a leaf
        stays on the host and must have its ``like`` leaf's shape.  A
        ``like`` leaf may be a meta tensor (shape and dtype only)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        data = np.load(path / "arrays.npz")
        names_like, leaves_like = _flatten_with_names(like)
        # the arrays are read one at a time, as each leaf is placed
        by_name = {nm: f"a{i}" for i, nm in enumerate(manifest["names"])}
        missing = [nm for nm in names_like if nm not in by_name]
        extra_leaves = sorted(set(manifest["names"]) - set(names_like))
        if missing or extra_leaves:
            raise ValueError(
                f"checkpoint step {step} does not match the target tree "
                f"structure: {len(missing)} leaf/leaves missing from the "
                f"checkpoint {missing}; {len(extra_leaves)} present only "
                f"in the checkpoint {extra_leaves}")
        shard_leaves = (tree_lib.leaves(shardings) if shardings is not None
                        else [None] * len(leaves_like))
        dtype_by_name = dict(zip(manifest["names"], manifest["dtypes"]))
        out = []
        for nm, proto, sh in zip(names_like, leaves_like, shard_leaves):
            arr = data[by_name[nm]]
            if not (arr.flags.writeable and arr.flags.c_contiguous):
                arr = np.array(arr, order="C")        # a tensor owns writable memory
            if "bfloat16" in dtype_by_name.get(nm, ""):
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            dtype = proto.dtype if isinstance(proto, torch.Tensor) else _torch_dtype(proto)
            t = t.to(dtype)
            if callable(sh):
                t = sh(t)
            else:
                assert tuple(t.shape) == tuple(np.shape(proto)), (nm, t.shape,
                                                                  np.shape(proto))
                if sh is not None:
                    t = t.to(sh)
            out.append(t)
            del arr, t
        return step, tree_lib.unflatten(like, out), manifest["extra"]


def _torch_dtype(proto: Any) -> torch.dtype:
    """The tensor dtype of a non-tensor ``like`` leaf (an array or a
    number): its numpy dtype's."""
    return torch.from_numpy(np.asarray(proto).reshape(-1)[:0]).dtype
