"""Carry state between the JAX package and the port, as numpy arrays.

LM parameters, decode caches and training states (``lm_params``,
``lm_cache``, ``train_state``) keep the reference's nested keys and
layouts; bf16 leaves (``ml_dtypes.bfloat16`` arrays from ``np.asarray``)
travel as their uint16 bit patterns and become ``torch.bfloat16``
tensors bit for bit.

The detection system has no learned weights: its parameters are the hash
mappings (recomputed by ``lsh.hash_mappings``, bit-exact), the §5.2
median/MAD statistics, and the resident index state. These functions take
the reference's state as numpy arrays (``jax.device_get`` of an
``IndexState`` / ``FusedState`` / ``Pairs`` turned into a dict of leaves)
and return the port's tensors, and back. uint32 arrays (signatures,
packed words) become int32 tensors with the same bit pattern, and return
as uint32. Like every constructor of the package, each function puts
its tensors on ``cuda`` unless ``device`` names another. A state without
a station axis (the reference's solo form) gains a leading axis of 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import utils
from repro_torch.core.lsh import Pairs, VerifiedPairs
from repro_torch.stream.fused import FusedState
from repro_torch.stream.index import IndexState

_U32_LEAVES = ("sig", "pk")


def _tensor(a, device, dtype=None) -> torch.Tensor:
    device = utils.resolve_device(device)
    a = np.array(a)              # an owned, writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(dtype)


def index_state(leaves: dict, device=None) -> IndexState:
    """Reference ``IndexState`` leaves → the port's (station-stacked)."""
    solo = np.asarray(leaves["sig"]).ndim == 3
    out = {}
    for f in dataclasses.fields(IndexState):
        a = np.asarray(leaves[f.name])
        out[f.name] = _tensor(a[None] if solo else a, device, torch.int32)
    return IndexState(**out)


def index_state_to_numpy(state: IndexState) -> dict:
    """The port's index leaves as numpy, uint32 where the reference is."""
    out = {}
    for f in dataclasses.fields(IndexState):
        a = getattr(state, f.name).cpu().numpy()
        out[f.name] = a.view(np.uint32) if f.name in _U32_LEAVES else a
    return out


def fused_state(leaves: dict, device=None) -> FusedState:
    """Reference ``FusedState`` leaves ({"index": {...}, "halo", "med",
    "mad"}) → the port's."""
    solo = np.asarray(leaves["halo"]).ndim == 1

    def vec(a):
        a = np.asarray(a, np.float32)
        return _tensor(a[None] if solo else a, device)

    return FusedState(index=index_state(leaves["index"], device),
                      halo=vec(leaves["halo"]), med=vec(leaves["med"]),
                      mad=vec(leaves["mad"]))


def med_mad(med, mad, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    return (_tensor(np.asarray(med, np.float32), device),
            _tensor(np.asarray(mad, np.float32), device))


def pairs(leaves: dict, device=None) -> Pairs:
    """Reference ``Pairs`` / ``VerifiedPairs`` leaves → the port's."""
    t = {k: _tensor(v, device) for k, v in leaves.items()}
    return VerifiedPairs(**t) if "jac" in t else Pairs(**t)


def pairs_list(blocks: list, device=None) -> list[Pairs]:
    """A list of reference ``Pairs`` leaves (the blocks of
    ``partitioned_search``) → the port's, in the same order."""
    return [pairs(leaves, device) for leaves in blocks]


def signatures(sigs, device=None) -> torch.Tensor:
    """Reference uint32 (N, t) signatures → the port's int32 bit patterns."""
    return _tensor(np.asarray(sigs, np.uint32), device)


def _lm_tree(tree: dict, device) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _lm_tree(v, device)
            continue
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            bits = np.array(a, order="C").view(np.int16)  # an owned copy
            t = torch.from_numpy(bits).view(torch.bfloat16)
            out[k] = t.to(utils.resolve_device(device))
        else:
            out[k] = _tensor(a, device)
    return out


def lm_params(tree: dict, device=None) -> dict:
    """A reference LM parameter tree (nested dict of arrays) → the port's
    nested dict of tensors, same keys, shapes and dtypes."""
    return _lm_tree(tree, device)


def lm_cache(tree: dict, device=None) -> dict:
    """A reference decode cache (``pos``, ``k`` / ``v`` or ``conv`` /
    ``ssm``) → the port's, same keys, shapes and dtypes."""
    return _lm_tree(tree, device)


def _lm_tree_to_numpy(tree: dict) -> dict:
    """Tensors → numpy; bf16 leaves as fp32 arrays (every bf16 value is an
    fp32 value, so ``.astype(bfloat16)`` recovers them exactly)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _lm_tree_to_numpy(v)
        else:
            t = v.detach().cpu()
            out[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def train_state(leaves: dict, device=None):
    """A reference ``TrainState`` as numpy — {"params": tree, "opt":
    {"master", "m", "v", "step"}, "step"} — → the port's ``TrainState``
    with the same keys, shapes, dtypes and values."""
    from repro_torch.train.loop import TrainState
    opt = dict(leaves["opt"])
    return TrainState(
        params=_lm_tree(leaves["params"], device),
        opt={**_lm_tree({k: opt[k] for k in ("master", "m", "v")}, device),
             "step": _tensor(np.asarray(opt["step"], np.int32), device)},
        step=_tensor(np.asarray(leaves["step"], np.int32), device))


def train_state_to_numpy(state) -> dict:
    """The port's ``TrainState`` → {"params", "opt", "step"} of numpy
    arrays (bf16 leaves as fp32 values, see ``_lm_tree_to_numpy``)."""
    return {"params": _lm_tree_to_numpy(state.params),
            "opt": _lm_tree_to_numpy(state.opt),
            "step": state.step.cpu().numpy()}
