"""Min-Max LSH hashing (paper §6.2): raw min/max planes, and
signatures with salted bucket ids.

``csrc/minmax_hash.cu`` holds two CUDA kernels for each function.
``minmax_hash`` replaces the Pallas kernel
``repro/kernels/minmax_hash.py:minmax_hash`` (the raw (N, H) mins and
maxs, folded by ``core.lsh.signatures`` on the offline search path);
``minmax_sig_buckets`` replaces ``minmax_sig_buckets`` there (fold and
bucket epilogue fused, the block replay). Both read the packed (N, D/32)
fingerprint words that ``binarize_coeffs`` produces instead of the (N, D)
bits, and compare only the mapping rows of set bits. ``plan`` picks the
kernel from the shapes: the tiled one (the mapping table staged in shared
memory once per tile of rows) at the paper widths (D = 8192) from
MIN_TILED_PLANE rows × columns, the row one (a CTA a row, mapping values
gathered from L2) for the rest.
``plain_raw`` and ``plain`` compute the same functions from the same
packed input in PyTorch: the masked min/max (the reference's
``ref.minmax_hash``), followed for ``plain`` by the signature fold and
bucket addressing of ``repro/core/lsh.py``. Signatures are int32 tensors
holding the uint32 bit pattern.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch import utils
from repro_torch.kernels import _build

BIG = 2**31 - 1

# The tiled kernel's shape: csrc/minmax_hash.cu's kCols, kRowsPerWarp,
# kMaxWarps, kChunk, kStages, kListBytes and kMaxSplit (the plan's copy;
# the launch sends only the warps, the split and the split's scratch).
SLICE_COLS = 128         # columns a CTA: 32 lanes x 4
ROWS_PER_WARP = 8        # rows whose mins and maxs a lane holds
MAX_WARPS = 16           # a row tile of 128 rows
CHUNK = 128              # dimensions staged at a time (4 words a row);
                         # at most 128 (list entries are 16-bit offsets)
STAGES = 3
LIST_BYTES = 2           # a set bit's entry: its staged row's byte offset
MAX_SPLIT = 8            # CTAs sharing a tile's dimensions
SMEM_LIMIT = 232_448     # shared memory a block can use on the H100
SM_SMEM = 233_472        # shared memory of an SM, 1 KB of it kept a CTA
REGS = 128               # registers a thread (the kernel's launch bounds)
H100_SMS = 132
# Below this many dimensions a row holds few set bits, and the row kernel's
# short CTAs beat the tiled kernel's pipeline fill (tools/kernel_ab.py on
# the H100: D = 320 and 1024 run 1.6-2.1x faster in the row kernel; at D
# of 8192 and more the tiled one runs up to 5.3x faster, 2x on a
# station-day).
MIN_TILED_DIMS = 4096
# Below this many rows x columns (the planes' size, N * H) the tiled grid
# fills few SMs even split 8 ways (256 rows at H = 400: 2 tiles x 4 slices
# x 8 CTAs), and the row kernel, whose work grows with N * H, is faster.
# tools/kernel_variants.py, run `rows`, on the H100 at D = 8192: the row
# kernel wins at 256 x 400 (1.27x raw, 1.03x signatures), the tiled one
# from 384 x 400 (1.03x raw, 1.14x signatures) and at 256 x 800 (1.28x).
MIN_TILED_PLANE = 1 << 17


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs: ``tiled`` or the row kernel and, when tiled,
    the CTA's warps, the CTAs that split a tile's dimensions (``split``),
    the dynamic shared memory in bytes (as the kernel's launch sizes it)
    and the grid."""
    tiled: bool
    warps: int = 0
    split: int = 1
    smem: int = 0
    grid: tuple[int, int] = (0, 0)


def _smem(warps: int) -> int:
    """The staged chunks, each row's list of set bits (an entry a
    dimension and two more, so that the rows' lists start in different
    banks) and 128 bytes to align the stages for TMA."""
    return (STAGES * CHUNK * SLICE_COLS * 4
            + warps * ROWS_PER_WARP * LIST_BYTES * (CHUNK + 2) + 128)


def plan(n: int, n_words: int, n_hash: int, f: int | None = None,
         aligned: bool = True, n_sms: int = H100_SMS) -> Plan:
    """The launch for ``n`` rows of ``n_words`` packed words and
    ``n_hash`` mapping columns; ``f`` the functions a table for
    signatures (None for the raw planes), ``aligned`` whether the mapping
    table starts on 16 bytes.

    The tiled kernel takes at least MIN_TILED_PLANE rows × columns of
    at least MIN_TILED_DIMS dimensions, H a multiple of 4 on an aligned
    table and, for signatures, 4 % f == 0 (a lane's 4 columns hold whole
    tables); every other shape takes the row kernel. Row tiles of up to
    128 rows, one CTA a tile and 128-column slice; where those leave SMs
    idle, up to 8 CTAs split each tile's dimensions, as many as one wave
    holds and no more than the chunks."""
    if (n * n_hash < MIN_TILED_PLANE or 32 * n_words < MIN_TILED_DIMS
            or n_hash % 4 or not aligned or (f is not None and 4 % f)):
        return Plan(False)
    warps = min(MAX_WARPS, max(1, -(-n // ROWS_PER_WARP)))
    tiles = -(-n // (warps * ROWS_PER_WARP))
    slices = -(-n_hash // SLICE_COLS)
    chunks = -(-32 * n_words // CHUNK)
    threads = warps * 32
    per_sm = max(1, min(SM_SMEM // (_smem(warps) + 1024),
                        65536 // (threads * REGS), 2048 // threads))
    split = 1
    while (tiles and split * 2 <= min(MAX_SPLIT, chunks)
           and tiles * slices * split * 2 <= n_sms * per_sm):
        split *= 2
    return Plan(True, warps, split, _smem(warps), (tiles * split, slices))


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_for(packed: torch.Tensor, mappings: torch.Tensor,
              f: int | None) -> Plan:
    return plan(packed.shape[0], packed.shape[1], mappings.shape[1], f,
                mappings.data_ptr() % 16 == 0, _n_sms(packed.device.index
                                                      or 0))


# the tiled entry points' plan arguments: warps, split, partials, counters
PLAN_TYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
# per (device, stream): a zero for every tile and slice of a split launch,
# which the kernel leaves zero
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _scratch(p: Plan, device: torch.device) -> tuple:
    """A split launch's room for partial mins and maxs (a CTA's rows × 128
    columns × 2) and its counters; nothing without a split."""
    if p.split == 1:
        return None, None
    ctas = p.grid[0] * p.grid[1]
    part = torch.empty(ctas * p.warps * ROWS_PER_WARP * SLICE_COLS * 2,
                       dtype=torch.int32, device=device)
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < ctas // p.split:
        counters = _COUNTERS[key] = torch.zeros(
            max(ctas // p.split, 1024), dtype=torch.int32, device=device)
    return part, counters


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
    n, n_words = packed.shape
    _run("minmax_hash", _plan_for(packed, mappings, None), packed.device,
         [packed.data_ptr(), n, n_words, mappings.data_ptr(),
          mappings.shape[1], mins.data_ptr(), maxs.data_ptr()],
         [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def _run(entry: str, p: Plan, device: torch.device, args: list,
         types: list) -> None:
    """Call ``<entry>_launch`` (the row kernel) or ``<entry>_tiled_launch``
    with the plan and its scratch, then the current stream."""
    lib = _build.load("minmax_hash")
    fn = getattr(lib, f"{entry}_tiled_launch" if p.tiled
                 else f"{entry}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = types + (PLAN_TYPES if p.tiled else []) + [ctypes.c_void_p]
    plan_args = []
    if p.tiled:
        part, counters = _scratch(p, device)
        plan_args = [p.warps, p.split,
                     part.data_ptr() if part is not None else None,
                     counters.data_ptr() if counters is not None else None]
    rc = fn(*args, *plan_args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(rc, entry)


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
    n, n_words = packed.shape
    _run("minmax_sig_buckets", _plan_for(packed, mappings, f), packed.device,
         [packed.data_ptr(), n, n_words, mappings.data_ptr(),
          salts.data_ptr(), salts.shape[0], f, int(use_minmax), n_buckets,
          sig.data_ptr(), bkt.data_ptr()],
         [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
          ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
