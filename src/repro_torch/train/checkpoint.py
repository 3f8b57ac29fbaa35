"""Atomic on-disk checkpoints of a flat or nested state of arrays.

PyTorch counterpart of ``repro.train.checkpoint``, with the same layout so
that either package reads the other's checkpoints: ``<dir>/step_<N>/``
holds ``arrays.npz`` (one entry a leaf, keyed by its path with the parts
joined by ``\\x1f``) and ``manifest.json`` (``step``, each key's shape and
dtype under ``keys``, the caller's ``extra``). A write goes to a
temporary directory beside the step, is fsynced and renamed into place,
so a reader never sees a half-written step; with ``background=True`` the
leaves are copied to the host inline and serialised on a thread.

Leaves may be tensors (copied to the host) or numpy arrays, in nested
dicts or dataclasses (a ``TrainState`` flattens to the reference's keys:
``params/…``, ``opt/master/…``, ``opt/m/…``, ``opt/v/…``, ``opt/step`` and
``step``). A tensor keeps its dtype; a bf16 tensor is written as its raw
2-byte patterns (numpy ``V2``, manifest dtype ``bfloat16``), as the
reference writes ``ml_dtypes.bfloat16`` arrays. Callers that hold a uint32
bit pattern in an int32 tensor (the port's signatures and packed words)
pass the uint32 numpy view, so the file carries the reference's dtype.
``restore_checkpoint`` rebuilds a target tree on the target's device, so
either package restores the other's training checkpoints.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import utils

_SEP = "\x1f"  # unit separator: safe key-path join


def _children(tree) -> dict | None:
    """The named children of a dict (sorted keys, as ``jax.tree_util``
    orders a dict) or a dataclass instance (its fields in order, as a
    registered dataclass flattens); None for a leaf."""
    if isinstance(tree, dict):
        return {str(k): tree[k] for k in sorted(tree)}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    return None


def _flatten(tree, prefix: tuple = ()) -> dict[str, Any]:
    """Leaves keyed by their path, parts joined by ``_SEP``."""
    kids = _children(tree)
    if kids is None:
        return {_SEP.join(prefix): tree}
    flat = {}
    for k, v in kids.items():
        flat.update(_flatten(v, prefix + (k,)))
    return flat


def _to_host(leaf) -> np.ndarray:
    """A host copy of a tensor (a background write must not see a later
    in-place update of a CPU tensor); bf16 as its raw 2-byte patterns
    (``V2``); numpy leaves as given."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == np.dtype("V2") else str(a.dtype)


def save_checkpoint(ckpt_dir: str, step: int, state, *, extra: dict | None
                    = None, background: bool = False, keep: int = 3):
    """Write ``state`` as step ``step`` atomically, then keep only the
    newest ``keep`` steps. With ``background=True`` the host copy happens
    inline and the write on a thread, which is returned (``join()`` it)."""
    host = {k: _to_host(v) for k, v in _flatten(state).items()}
    meta = {
        "step": int(step),
        "keys": {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
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


def _leaf_tensor(key: str, arr: np.ndarray, ref, device) -> torch.Tensor:
    """One stored array as a tensor of ``ref``'s shape and dtype. bf16
    comes back from its 2-byte patterns (``V2`` or 16-bit integers) bit
    for bit, other stored floats by value; uint32 into int32 keeps the
    bits (the port's convention)."""
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                         f"target {tuple(ref.shape)}")
    want = ref.dtype
    if want == torch.bfloat16 and arr.dtype.itemsize == 2 and \
            arr.dtype.kind in "Viu":
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    elif arr.dtype == np.uint32 and want == torch.int32:
        t = torch.from_numpy(np.array(arr).view(np.int32))
    else:
        t = torch.from_numpy(np.array(arr)).to(want)
    return t.to(device)


def _rebuild(target, flat: dict, prefix: tuple = ()):
    kids = _children(target)
    if kids is None:
        return flat[_SEP.join(prefix)]
    out = {k: _rebuild(v, flat, prefix + (k,)) for k, v in kids.items()}
    if isinstance(target, dict):
        return {k: out[str(k)] for k in target}
    return dataclasses.replace(target, **out)


def restore_checkpoint(ckpt_dir: str, target, *, step: int | None = None,
                       device=None) -> tuple[Any, dict]:
    """Rebuild ``target``-structured state from step ``step`` (the latest
    by default) → (state, extra).

    ``target`` (nested dicts / dataclasses, e.g. a ``TrainState``) gives
    the structure, each leaf's shape and dtype and where it goes: a
    tensor's device, or ``device`` (cuda unless named) for a leaf on the
    ``meta`` device or any other object with ``shape`` and ``dtype``.
    A key missing from the checkpoint raises ``KeyError``, a shape that
    differs ``ValueError``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((d / "manifest.json").read_text())
    rebuilt = {}
    with np.load(d / "arrays.npz") as arrays:
        for key, ref in _flatten(target).items():
            if key not in arrays.files:
                raise KeyError(f"checkpoint missing {key!r}")
            dev = ref.device if isinstance(ref, torch.Tensor) and \
                ref.device.type != "meta" else utils.resolve_device(device)
            rebuilt[key] = _leaf_tensor(key, arrays[key], ref, dev)
    return _rebuild(target, rebuilt), meta.get("extra", {})
