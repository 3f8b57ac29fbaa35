"""Shared utilities: integer mixing, bit packing, segment helpers.

PyTorch counterpart of ``repro.utils``. torch has no full uint32
arithmetic (its ``>>`` on int32 is arithmetic, and uint32 supports few
ops), so every hash here carries its uint32 value in an **int64** tensor
holding a number in [0, 2**32), masked after each ``*``, ``+`` and ``<<``.
Multiplication is split into two 16-bit halves so no intermediate leaves
the int64 range. Tensors that are *stored* (signatures, packed fingerprint
words) are int32 tensors holding the uint32 bit pattern; ``to_u32`` /
``to_i32_bits`` convert between the two forms.

Segment helpers work along the last dimension, so a leading batch of
stations or tables needs no Python loop.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor → int64 holding its low 32 bits as uint32."""
    return x.to(torch.int64) & MASK32


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values → int32 tensor with the same bit pattern."""
    x = x & MASK32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for x in [0, 2**32) without int64 overflow."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


# ---------------------------------------------------------------------------
# Integer hashing (murmur3 finalizer; values as int64 in [0, 2**32))
# ---------------------------------------------------------------------------


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Avalanche mixer over uint32 lanes (murmur3 finalizer)."""
    x = to_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def hash_u32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Seeded uint32 hash of integer input (any int dtype)."""
    s = (int(seed) & MASK32) * _GOLDEN & MASK32
    return mix32((to_u32(x) + s) & MASK32)


def hash_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Order-sensitive combine of two uint32 hash streams (boost-style)."""
    a = to_u32(a)
    b = to_u32(b)
    return a ^ ((b + _GOLDEN + ((a << 6) & MASK32) + (a >> 2)) & MASK32)


def fold_hashes(h: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Reduce a dimension of uint32 hashes into one via ``hash_combine``,
    starting from 0 (the reference's ``lax.scan``)."""
    h = torch.movedim(to_u32(h), dim, 0)
    out = torch.zeros(h.shape[1:], dtype=torch.int64, device=h.device)
    for x in h:
        out = hash_combine(out, x)
    return out


# ---------------------------------------------------------------------------
# Bit packing for binary fingerprints
# ---------------------------------------------------------------------------


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a boolean (..., d) with d % 32 == 0 into int32 (..., d // 32)
    words holding the uint32 pattern. Bit j of word w is position
    w * 32 + j."""
    d = bits.shape[-1]
    assert d % 32 == 0, f"fingerprint dim {d} not a multiple of 32"
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], d // 32, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return to_i32_bits((b << shifts).sum(dim=-1))


def unpack_bits(words: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of ``pack_bits``; returns bool (..., d)."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    b = (to_u32(words)[..., None] >> shifts) & 1
    return b.reshape(*words.shape[:-1], words.shape[-1] * 32)[..., :d].bool()


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-lane popcount of uint32 words (any int dtype) → int32."""
    v = to_u32(x)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & MASK32) >> 24).to(torch.int32)


# ---------------------------------------------------------------------------
# Segment helpers on sorted keys (along the last dimension)
# ---------------------------------------------------------------------------


def segment_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Boolean mask: True where a run of equal keys begins."""
    first = torch.ones_like(sorted_keys[..., :1], dtype=torch.bool)
    return torch.cat([first, sorted_keys[..., 1:] != sorted_keys[..., :-1]],
                     dim=-1)


def segment_ids_from_starts(starts: torch.Tensor) -> torch.Tensor:
    """Integer segment id per element (cumsum of run starts, 0-based)."""
    return (torch.cumsum(starts.to(torch.int32), dim=-1) - 1).to(torch.int32)


def segment_sum(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` along the last dimension (ids in range)."""
    out = torch.zeros(*data.shape[:-1], num_segments, dtype=data.dtype,
                      device=data.device)
    return out.scatter_add_(-1, seg.to(torch.int64), data)


def segment_min(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_min`` for int32 data: empty segments hold the
    int32 maximum, as in the reference."""
    out = torch.full((*data.shape[:-1], num_segments), INT32_MAX,
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(-1, seg.to(torch.int64), data, "amin")


def segment_max(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max`` for int32 data: empty segments hold the
    int32 minimum, as in the reference."""
    out = torch.full((*data.shape[:-1], num_segments), INT32_MIN,
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(-1, seg.to(torch.int64), data, "amax")


def run_lengths(sorted_keys: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(segment_ids, length_of_that_segment_per_element) for sorted keys."""
    seg = segment_ids_from_starts(segment_starts(sorted_keys))
    counts = segment_sum(torch.ones_like(seg), seg, sorted_keys.shape[-1])
    return seg, counts.gather(-1, seg.to(torch.int64))


def rank_in_run(sorted_keys: torch.Tensor) -> torch.Tensor:
    """0-based rank of each element inside its run of equal sorted keys."""
    starts = segment_starts(sorted_keys)
    idx = torch.arange(sorted_keys.shape[-1], dtype=torch.int32,
                       device=sorted_keys.device).expand(sorted_keys.shape)
    start_idx = torch.where(starts, idx, torch.zeros_like(idx))
    run_start = torch.cummax(start_idx, dim=-1).values
    return idx - run_start


def lex_key(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """One int64 key that orders signed int32 pairs (k1, k2)
    lexicographically — the torch stand-in for ``lax.sort(num_keys=2)``."""
    return (k1.to(torch.int64) << 32) + (k2.to(torch.int64) + 2**31)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


def tree_leaves(tree: dict, prefix: tuple = ()):
    """(path, leaf) pairs of a nested dict in the reference's flatten
    order (sorted keys, as ``jax.tree_util`` orders a dict)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from tree_leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def tree_map(fn, tree: dict) -> dict:
    """``fn`` applied to every leaf of a nested dict, same keys."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; never a silent CPU.

    Every public constructor of the package resolves its ``device`` here,
    so state built with the defaults lives on the card (and the kernels
    run), and a machine without CUDA raises instead of running the plain
    versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "repro_torch on the CPU")
    return dev


def placed(x, device=None) -> torch.Tensor:
    """Entry-point input as a tensor: a tensor stays on its own device
    unless ``device`` names another; anything else (numpy, with uint32
    arrays viewed as int32) goes to ``resolve_device(device)``, so cuda by
    default."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    if isinstance(x, np.ndarray) and x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.as_tensor(x, device=resolve_device(device))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b
