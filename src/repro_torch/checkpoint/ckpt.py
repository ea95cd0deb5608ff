"""Tree checkpoints in one ``.npz``, as ``repro/checkpoint/ckpt.py``.

A tree (nested dicts, lists and tuples of tensors or arrays) is flattened
into one ``.npz`` whose keys are the leaves' paths, dict keys in sorted
order joined by ``|`` and sequence positions as ``#i``: the strings the
JAX package's ``_path_str`` builds (``params|upd|xz|w``,
``opt_state|step``), so a JAX checkpoint of ``{params, opt_state, state}``
restores into the port's trees and the port's into JAX's. A small JSON
manifest holds the step and metadata.

Writes are crash-atomic: both files land by write-to-``*.tmp`` + fsync +
``os.replace``, and the manifest is written LAST, so its presence marks a
complete step. ``latest_step`` reports only steps whose npz + manifest
pair exists and loads.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_SEP = "|"


def _paths(tree, prefix: tuple = ()) -> list:
    """(path, leaf) pairs in the JAX package's leaf order: dict keys
    sorted, sequences by position; None is an empty subtree."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree)
                for pl in _paths(x, prefix + (f"#{i}",))]
    if tree is None:
        return []
    return [(_SEP.join(prefix), tree)]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, it) for x in tree)
    if tree is None:
        return None
    return next(it)


def _names(directory: str, step: int) -> tuple[str, str]:
    return (os.path.join(directory, f"ckpt_{step:08d}.npz"),
            os.path.join(directory, f"ckpt_{step:08d}.json"))


def _atomic_write(path: str, write_fn: Callable[[Any], None]) -> None:
    """Write by a same-directory temp file, fsync, then rename into place:
    a reader (or a resume after SIGKILL) sees the old complete file or
    the new one, never a torn write."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(directory: str, step: int, tree, *,
                    metadata: Optional[dict] = None) -> str:
    """Save ``tree`` as step ``step`` of ``directory``; returns the npz
    path. Tensors are copied to the host."""
    os.makedirs(directory, exist_ok=True)
    path, manifest_path = _names(directory, step)
    flat = {key: _host(leaf) for key, leaf in _paths(tree)}
    _atomic_write(path, lambda f: np.savez_compressed(f, **flat))
    manifest = {"step": step, "num_arrays": len(flat),
                "metadata": metadata or {}}
    # manifest last: its presence marks the step complete
    _atomic_write(manifest_path,
                  lambda f: f.write(json.dumps(manifest).encode()))
    return path


def _step_ok(directory: str, step: int) -> bool:
    """A step counts only when its npz + manifest pair is present and both
    parse: the leftovers of a killed writer are skipped."""
    path, manifest_path = _names(directory, step)
    if not (os.path.isfile(path) and os.path.isfile(manifest_path)):
        return False
    try:
        with open(manifest_path) as f:
            json.load(f)
        # np.load reads the zip's central directory (at its end), so a
        # truncated npz fails here rather than at restore
        with np.load(path) as data:
            data.files  # noqa: B018 — force the directory read
    except Exception:
        return False
    return True


def latest_step(directory: str) -> Optional[int]:
    """The newest COMPLETE step in ``directory`` (a lone npz, a torn zip
    or an unparsable manifest is skipped, not raised), or None."""
    if not os.path.isdir(directory):
        return None
    steps = sorted({int(m.group(1))
                    for fn in os.listdir(directory)
                    if (m := re.match(r"ckpt_(\d+)\.(npz|json)$", fn))},
                   reverse=True)
    for step in steps:
        if _step_ok(directory, step):
            return step
    return None


def restore_checkpoint(directory: str, step: int, target_tree):
    """Restore into the structure of ``target_tree`` (shapes checked).

    A tensor leaf of the target comes back as a tensor on that leaf's
    device, in the checkpoint's dtype; any other leaf as a numpy array.
    Raises ``FileNotFoundError`` when the step does not exist and
    ``ValueError``, naming the offending keys and what the checkpoint
    holds, when it does not cover the target (extra keys in the
    checkpoint are allowed: the best-val ``{params, state}`` is restored
    from a ``{params, opt_state, state}`` save)."""
    path, _ = _names(directory, step)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint for step {step} in "
                                f"{directory!r}")
    with np.load(path) as data:
        paths = _paths(target_tree)
        keys = [k for k, _ in paths]
        missing = [k for k in keys if k not in data]
        if missing:
            raise ValueError(
                f"checkpoint {path!r} does not match the target tree "
                f"structure: missing {len(missing)}/{len(keys)} keys "
                f"{missing[:5]}{'...' if len(missing) > 5 else ''}; "
                f"checkpoint holds {sorted(data.files)[:8]}"
                f"{'...' if len(data.files) > 8 else ''}")
        leaves = []
        for key, leaf in paths:
            arr = data[key]
            if tuple(arr.shape) != tuple(np.shape(leaf)):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs "
                    f"target {tuple(np.shape(leaf))}")
            if isinstance(leaf, torch.Tensor):
                arr = torch.from_numpy(arr).to(leaf.device)
            leaves.append(arr)
    return _rebuild(target_tree, iter(leaves))
