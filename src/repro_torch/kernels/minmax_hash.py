"""Min-Max LSH hashing (paper §6.2): raw min/max planes, and signatures
with salted bucket ids.

``csrc/minmax_hash.cu`` holds two CUDA kernels that share their set-bit
compaction and gather loop. ``minmax_hash`` replaces the Pallas kernel
``repro/kernels/minmax_hash.py:minmax_hash`` (the raw (N, H) mins and
maxs, folded by ``core.lsh.signatures`` on the offline search path);
``minmax_sig_buckets`` replaces ``minmax_sig_buckets`` there (fold and
bucket epilogue fused, the block replay). Both read the packed (N, D/32)
fingerprint words that ``binarize_coeffs`` produces instead of the (N, D)
bits, and gather only the mapping rows of set bits. ``plain_raw`` and
``plain`` compute the same functions from the same packed input in
PyTorch: the masked min/max (the reference's ``ref.minmax_hash``),
followed for ``plain`` by the signature fold and bucket addressing of
``repro/core/lsh.py``. Signatures are int32 tensors holding the uint32
bit pattern.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import utils
from repro_torch.kernels import _build

BIG = 2**31 - 1


def minmax(bits: torch.Tensor, mappings: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, D) bool × (D, H) int32 → (mins, maxs), each (N, H) int32.

    Empty rows give mins = 2**31 - 1 and maxs = 0. Gathers the mapping
    rows of each row's set bits (padded to the row with the most bits with
    an index that hits a sentinel row), in chunks of rows to bound memory.
    """
    n, d = bits.shape
    h = mappings.shape[1]
    dev = mappings.device
    lo_tab = torch.cat([mappings, torch.full((1, h), BIG, dtype=torch.int32,
                                             device=dev)])
    hi_tab = torch.cat([mappings, torch.zeros((1, h), dtype=torch.int32,
                                              device=dev)])
    nnz = bits.sum(dim=1)
    kmax = max(int(nnz.max()) if n else 0, 1)
    order = torch.argsort((~bits).to(torch.int8), dim=1, stable=True)[:, :kmax]
    slot = torch.arange(kmax, device=dev)[None, :]
    idx = torch.where(slot < nnz[:, None], order, d)
    mins = torch.empty((n, h), dtype=torch.int32, device=dev)
    maxs = torch.empty((n, h), dtype=torch.int32, device=dev)
    step = max(1, (1 << 24) // (kmax * max(h, 1)))
    for r in range(0, n, step):
        sel = idx[r:r + step]
        mins[r:r + step] = lo_tab[sel].amin(dim=1)
        maxs[r:r + step] = hi_tab[sel].amax(dim=1)
    return mins, maxs


def plain_raw(packed: torch.Tensor, mappings: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """packed (N, W) int32, mappings (32 W, H) int32 → (mins, maxs), each
    (N, H) int32, with no fold."""
    return minmax(utils.unpack_bits(packed, mappings.shape[0]), mappings)


def launch_raw(packed: torch.Tensor, mappings: torch.Tensor,
               mins: torch.Tensor, maxs: torch.Tensor) -> None:
    """Launch the raw-plane kernel on the current stream (no
    synchronisation)."""
    lib = _build.load("minmax_hash")
    fn = lib.minmax_hash_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    n, n_words = packed.shape
    rc = fn(packed.data_ptr(), n, n_words, mappings.data_ptr(),
            mappings.shape[1], mins.data_ptr(), maxs.data_ptr(),
            torch.cuda.current_stream(packed.device).cuda_stream)
    _build.check(rc, "minmax_hash")


def fold(mins: torch.Tensor, maxs: torch.Tensor, f: int,
         use_minmax: bool) -> torch.Tensor:
    """(..., T·f) min/max planes → (..., T) signatures as uint32 values in
    int64: per function ``hash_combine(min, max)`` (or the min alone for
    MinHash), then the f-way fold of each table from 0."""
    per_fn = utils.to_u32(mins)
    if use_minmax:
        per_fn = utils.hash_combine(per_fn, utils.to_u32(maxs))
    return utils.fold_hashes(
        per_fn.reshape(*per_fn.shape[:-1], -1, f), dim=-1)


def plain(packed: torch.Tensor, mappings: torch.Tensor, salts: torch.Tensor,
          f: int, use_minmax: bool, n_buckets: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """packed (N, W) int32, mappings (32 W, T f) int32, salts (T,) int32 →
    (sig (N, T) int32 uint32-pattern, bkt (N, T) int32)."""
    sig = fold(*plain_raw(packed, mappings), f, use_minmax)
    bkt = utils.hash_combine(sig, utils.to_u32(salts)[None, :]) \
        & (n_buckets - 1)
    return utils.to_i32_bits(sig), bkt.to(torch.int32)


def launch(packed: torch.Tensor, mappings: torch.Tensor, salts: torch.Tensor,
           f: int, use_minmax: bool, n_buckets: int, sig: torch.Tensor,
           bkt: torch.Tensor) -> None:
    """Launch the signature kernel on the current stream (no
    synchronisation)."""
    lib = _build.load("minmax_hash")
    fn = lib.minmax_sig_buckets_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    n, n_words = packed.shape
    rc = fn(packed.data_ptr(), n, n_words, mappings.data_ptr(),
            salts.data_ptr(), salts.shape[0], f, int(use_minmax), n_buckets,
            sig.data_ptr(), bkt.data_ptr(),
            torch.cuda.current_stream(packed.device).cuda_stream)
    _build.check(rc, "minmax_sig_buckets")
