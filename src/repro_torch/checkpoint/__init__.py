"""Model checkpoints over the port's one serialization path (port of
`repro.checkpoint`).

`CheckpointManager` keeps the reference's ``step_<n>/`` layout and its
save/restore API, and is a thin wrapper over `engine.wal`'s snapshot
codec: the same atomic ``.tmp-<pid>`` + rename publish, one ``.npy`` a
leaf, sha256 verification, and bfloat16 stored as its uint16 bits.

A tree is a nested dict (or list or tuple) of tensors or arrays. Its
leaves are flattened in the reference's order — dict keys sorted, as
`jax.tree_util` sorts them — so each ``leaf_<i>.npy`` holds the same
leaf whichever package wrote it, and each package restores the other's
checkpoints.
"""
from __future__ import annotations

import os
import threading

import torch

from repro_torch.device import resolve_device
from repro_torch.engine.wal import (  # noqa: F401
    SnapshotError, gc_tmp_snapshots, list_snapshots, read_snapshot,
    write_snapshot)

_PREFIX = "step_"


def tree_flatten(tree) -> tuple[list, str]:
    """The leaves of `tree` in the reference's order (dict keys sorted;
    None is an empty subtree) and the structure's text as
    `jax.tree_util` prints it (``PyTreeDef({'b': *, 'w': *})``)."""
    leaves: list = []

    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, (list, tuple)):
            inner = ", ".join(walk(x) for x in node)
            if isinstance(node, list):
                return f"[{inner}]"
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if node is None:
            return "None"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def tree_unflatten(template, leaves: list):
    """`template`'s structure with its leaves, in flatten order, replaced
    by `leaves`; the counts must agree."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        if node is None:
            return None
        try:
            return next(it)
        except StopIteration:
            raise ValueError("checkpoint holds fewer leaves than the "
                             "template") from None

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("checkpoint holds more leaves than the template")
    return out


class CheckpointManager:
    """Numbered model checkpoints: atomic, hash-verified.

    Layout per step (written by `wal.write_snapshot` with the ``step_``
    prefix):

        <dir>/step_<n>.tmp-<pid>/   (in progress — ignored, removed)
        <dir>/step_<n>/             (atomic rename on completion)
            meta.json               shapes, dtypes, sha256 per leaf
            leaf_<i>.npy            one file per leaf

    A crash mid-save leaves only a ``.tmp`` dir; `latest_step` only ever
    sees complete checkpoints; every leaf is sha256-verified on
    restore."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        gc_tmp_snapshots(directory)
        self._async_thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = True) -> str:
        """Write checkpoint `step`. The leaves are copied to the host
        here, so the caller may go on changing its tensors.
        ``blocking=False`` hands the file I/O to a background thread (one
        in flight at a time: a second async save first `wait`s out the
        previous one). Returns the published path either way."""
        leaves, treedef = tree_flatten(tree)
        host = [x.detach().to("cpu", copy=True)
                if isinstance(x, torch.Tensor) else x for x in leaves]
        meta = {"step": step, "treedef": treedef}
        if blocking:
            return self._write(step, host, meta)
        self.wait()
        self._async_thread = threading.Thread(
            target=self._write, args=(step, host, meta))
        self._async_thread.start()
        return os.path.join(self.dir, f"{_PREFIX}{step}")

    def wait(self) -> None:
        """Join the in-flight async save, if any (idempotent)."""
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _write(self, step: int, host_leaves, meta) -> str:
        return str(write_snapshot(self.dir, step, host_leaves, meta,
                                  keep_last=self.keep_last, prefix=_PREFIX))

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> int | None:
        """Highest fully published checkpoint step (None when empty)."""
        steps = list_snapshots(self.dir, prefix=_PREFIX)
        return steps[-1][0] if steps else None

    def restore(self, template_tree, step: int | None = None, device=None):
        """-> (tree shaped like `template_tree` with tensors on `device`,
        step). `device` is the card unless ``device="cpu"``.

        Defaults to the latest step. Raises `FileNotFoundError` when no
        checkpoint exists and `SnapshotError` on corruption (a leaf whose
        sha256 does not match what was written)."""
        device = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"{_PREFIX}{step}")
        leaves, _meta = read_snapshot(path)
        return tree_unflatten(template_tree,
                              [t.to(device) for t in leaves]), step
