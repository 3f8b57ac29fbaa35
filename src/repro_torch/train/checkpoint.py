"""Atomic on-disk checkpoints of a flat or nested state of arrays.

PyTorch counterpart of ``repro.train.checkpoint``, with the same layout so
that either package reads the other's checkpoints: ``<dir>/step_<N>/``
holds ``arrays.npz`` (one entry a leaf, keyed by its path with the parts
joined by ``\\x1f``) and ``manifest.json`` (``step``, each key's shape and
dtype under ``keys``, the caller's ``extra``). A write goes to a
temporary directory beside the step, is fsynced and renamed into place,
so a reader never sees a half-written step; with ``background=True`` the
leaves are copied to the host inline and serialised on a thread.

Leaves may be tensors (copied to the host) or numpy arrays. A tensor keeps its dtype; callers that hold a uint32 bit
pattern in an int32 tensor (the port's signatures and packed words) pass
the uint32 numpy view, so the file carries the reference's dtype.

``restore_checkpoint`` (a target tree with shardings) belongs to training
and is not ported yet (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch

_SEP = "\x1f"  # unit separator: safe key-path join


def _flatten(tree, prefix: tuple = ()) -> dict[str, Any]:
    """Leaves of nested dicts keyed by their path, keys in sorted order
    (the order and keys ``jax.tree_util`` gives a dict tree)."""
    if not isinstance(tree, dict):
        return {_SEP.join(prefix): tree}
    flat = {}
    for k in sorted(tree):
        flat.update(_flatten(tree[k], prefix + (str(k),)))
    return flat


def _to_host(leaf) -> np.ndarray:
    """A host copy of a tensor (a background write must not see a later
    in-place update of a CPU tensor); numpy leaves as given."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, state, *, extra: dict | None
                    = None, background: bool = False, keep: int = 3):
    """Write ``state`` as step ``step`` atomically, then keep only the
    newest ``keep`` steps. With ``background=True`` the host copy happens
    inline and the write on a thread, which is returned (``join()`` it)."""
    host = {k: _to_host(v) for k, v in _flatten(state).items()}
    meta = {
        "step": int(step),
        "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                 for k, v in host.items()},
        "extra": extra or {},
    }

    def write():
        base = pathlib.Path(ckpt_dir)
        base.mkdir(parents=True, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=base)
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            final = base / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        _prune(ckpt_dir, keep)

    if background:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(list_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(pathlib.Path(ckpt_dir) / f"step_{s:08d}",
                      ignore_errors=True)


def list_steps(ckpt_dir: str) -> list[int]:
    base = pathlib.Path(ckpt_dir)
    if not base.is_dir():
        return []
    out = []
    for p in base.iterdir():
        if p.name.startswith("step_") and (p / "manifest.json").exists():
            out.append(int(p.name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_flat(ckpt_dir: str, *, step: int | None = None
                 ) -> tuple[dict[str, np.ndarray], dict, int]:
    """The flat key → host array dict of a step (the latest by default),
    with its ``extra`` and its step number. The manifest is the only shape
    oracle, so states whose leaf shapes vary (a ring's pending samples)
    restore without a target."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as arrays:
        out = {k: arrays[k] for k in arrays.files}
    return out, meta.get("extra", {}), int(step)
