"""The work of each hand-written kernel, and its least time on the H100.

One function a kernel (the eight forward kernels and the two backward
ones) takes the kernel's input shapes and dtypes and returns its
``Work``: the operations it does, on which pipe, the bytes it must move
(each input read once, each output written once) and its
transcendentals. ``bound_ms`` turns a ``Work`` into the least time the
card could take for it. ``chip_smoke.py`` reads its ``bound_ms`` column
from here, and ``kernels/ops.py`` records the same work for every call
on a ``meta`` tensor into the recorder that ``launch/hlo_stats`` installs,
so a kernel's roofline reads the same work whichever caller asks.

Where the work depends on the data (the Min-Max kernels' set bits, the
Jaccard kernel's valid slots and distinct rows), the caller passes what
its data needs; without it a function counts the most the shapes allow,
except that ``set_bits_per_row`` (a context) gives the Min-Max kernels a
fingerprint's set bits when the caller knows them but not the bits.
"""
from __future__ import annotations

import contextlib
import dataclasses

# H100 SXM peaks (NVIDIA H100 80GB HBM3 datasheet at 700 W, and the CUDA
# C++ Programming Guide's throughput table for compute capability 9.0,
# 132 SMs at 1.98 GHz), except POPC, measured
HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_OPS_PER_S = 67e12         # CUDA-core 32-bit rate
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core rate
# exponentials (MUFU.EX2 on the SFU): 16 a clock an SM
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# 32-bit integer min/max: 64 results a clock an SM (IMNMX). The
# three-input DPX min/max (__vimin3_s32 / __vimax3_s32) issue at that
# rate with two comparisons a result (tools/int_minmax_peak.py)
INT_OPS_PER_S = 132 * 64 * 1.98e9
MINMAX_COMPARES_PER_S = 2 * INT_OPS_PER_S
# population counts (POPC): 15.4 a clock an SM, measured by
# tools/int_minmax_peak.py's `popc` probe (15.35-15.48 on an H100 80GB
# HBM3 at 700 W; the guide's table gives 16)
POPC_OPS_PER_S = 132 * 15.4 * 1.98e9

# the rate of each pipe a kernel's operations run on
PIPES = {"fp32": FP32_OPS_PER_S, "bf16": BF16_OPS_PER_S,
         "minmax": MINMAX_COMPARES_PER_S, "popc": POPC_OPS_PER_S}

@dataclasses.dataclass(frozen=True)
class Work:
    """A kernel call's work: ``ops`` operations on ``pipe`` (floating
    point, or integer comparisons and population counts), ``int_ops``
    other integer operations on the same pipe at the IMNMX rate (the
    Min-Max signature epilogue), ``bytes`` moved to and from device
    memory and ``transcendentals`` (exponentials, on the SFU)."""

    ops: float
    bytes: float
    transcendentals: float = 0.0
    pipe: str = "fp32"
    int_ops: float = 0.0

    @property
    def flops(self) -> float:
        """Every operation, as ``hlo_stats`` adds it to a step's count."""
        return self.ops + self.int_ops


def bound_ms(w: Work) -> tuple[float, str]:
    """The least time for ``w`` and what sets it: the bytes over the HBM
    rate, the operations over their pipe's rate, or the exponentials over
    the SFU rate, whichever is longest."""
    return max((w.bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
               ((w.ops / PIPES[w.pipe] + w.int_ops / INT_OPS_PER_S) * 1e3,
                "operations"),
               (w.transcendentals / SFU_OPS_PER_S * 1e3, "sfu"))


_SET_BITS: list[int | None] = [None]


@contextlib.contextmanager
def set_bits_per_row(n: int | None):
    """Within the block, the Min-Max functions count ``n`` set bits a
    fingerprint row where their caller gives no count (a fingerprint of
    ``FingerprintConfig.top_k`` kept coefficients holds that many)."""
    _SET_BITS.append(n)
    try:
        yield
    finally:
        _SET_BITS.pop()


def _set_bits(n_rows: int, words: int, nnz: int | None) -> int:
    if nnz is not None:
        return nnz
    per = _SET_BITS[-1]
    return n_rows * (32 * words if per is None else min(per, 32 * words))


def stft_mag(r: int, t: int, frame_len: int, k: int, hop: int) -> Work:
    """(R, T) waveforms, a window of ``frame_len`` and K DFT columns: the
    waveform, the window and the two DFT matrices read once, the (R,
    n_frames, K) spectrogram written once; a frame's window product, its
    2K dot products and K magnitudes."""
    nf = max(0, (t - frame_len) // hop + 1)
    return Work(ops=r * nf * (k * 4 * frame_len + frame_len + 3 * k),
                bytes=4 * (r * t + frame_len + 2 * frame_len * k
                           + r * nf * k))


def haar2d(n: int, h: int, w: int) -> Work:
    """(N, H, W) images read and written once with the two transform
    matrices; two matrix products an image."""
    return Work(ops=n * (2 * h * w * w + 2 * h * h * w),
                bytes=4 * (2 * n * h * w + h * h + w * w))


def minmax_hash(n: int, words: int, h: int, nnz: int | None = None,
                dims: int | None = None) -> Work:
    """(N, words) packed rows × (32·words, H) mappings → two (N, H) int32
    planes: the rows, the ``dims`` mapping rows that a set bit selects
    (default all) and the planes; a min and a max a set bit and column
    (``nnz`` set bits in all)."""
    nnz = _set_bits(n, words, nnz)
    dims = 32 * words if dims is None else dims
    return Work(ops=2 * nnz * h, pipe="minmax",
                bytes=4 * (n * words + dims * h + 2 * n * h))


def minmax_sig_buckets(n: int, words: int, h: int, t: int,
                       nnz: int | None = None,
                       dims: int | None = None) -> Work:
    """``minmax_hash``'s comparisons, then the signature epilogue: 6
    integer operations a column and 13 a table; reads the rows, the
    selected mapping rows and the T salts, writes (N, T) signatures and
    bucket ids."""
    nnz = _set_bits(n, words, nnz)
    dims = 32 * words if dims is None else dims
    return Work(ops=2 * nnz * h, pipe="minmax",
                int_ops=6 * n * h + 13 * n * t,
                bytes=4 * (n * words + dims * h + t + 2 * n * t))


def jaccard_popcount(s: int, p: int, m: int, words: int,
                     live: int | None = None,
                     rows: int | None = None) -> Work:
    """(S, P, words) ring, (S, M) slots: the ``rows`` distinct ring rows
    that the ``live`` valid pairs read, once each (default: every slot
    valid, each reading two rows, at most the ring), the valid flags and
    scores (5 bytes a slot) and the valid slots' ids; two POPC a word of
    each valid pair."""
    live = s * m if live is None else live
    rows = min(2 * live, s * p) if rows is None else rows
    return Work(ops=2 * live * words, pipe="popc",
                bytes=rows * words * 4 + s * m * 5 + 8 * live)


def occurrence_filter(m: int, n_fp: int, live: int | None = None) -> Work:
    """An (M,) pair stream over ``n_fp`` fingerprints with ``live`` valid
    slots (default all): every slot's flag read and its new flag and sim
    written (6 bytes a slot), the valid slots' ids and sim read and the
    (n_fp,) excluded flags written; a test of each slot's flag and 6
    integer operations a valid slot (two counts, two tests against the
    cap, two of the marks)."""
    live = m if live is None else live
    return Work(ops=0, int_ops=m + 6 * live,
                bytes=6 * m + 12 * live + n_fp)


def causal_pairs(sq: int, sk: int, causal: bool = True) -> int:
    """The (query, key) pairs attention computes: query i sees keys up to
    i + sk − sq under the causal mask (the mask's offset for a query
    block at the end of the keys), every key without it."""
    if not causal:
        return sq * sk
    lo = sk - sq + 1            # keys row 0 sees; row i sees lo + i
    total, i0 = 0, max(0, 1 - lo)          # rows that see no key
    i1 = min(sq, max(i0, sk - lo))         # rows not yet capped at sk
    if i1 > i0:
        total += (i1 - i0) * lo + (i0 + i1 - 1) * (i1 - i0) // 2
    return total + max(0, sq - i1) * sk


def _pipe(dtype) -> str:
    return "bf16" if "bfloat16" in str(dtype) else "fp32"


def _size(dtype) -> int:
    name = str(dtype)
    return 2 if ("bfloat16" in name or "float16" in name) else 4


def flash_attention(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
                    dtype, causal: bool = True) -> Work:
    """q and the output (B, Hq, Sq, D), k and v (B, Hkv, Sk, D) moved
    once; 4·D operations a computed pair (its score and its share of
    P·V) at the tensor-core rate in bf16, the FMA rate in fp32, and one
    exponential a pair."""
    pairs = causal_pairs(sq, sk, causal)
    return Work(ops=4 * b * hq * d * pairs, pipe=_pipe(dtype),
                transcendentals=b * hq * pairs,
                bytes=_size(dtype) * 2 * (b * hq * sq * d
                                          + b * hkv * sk * d))


def flash_attention_bwd(b: int, hq: int, hkv: int, sq: int, sk: int,
                        d: int, dtype, causal: bool = True) -> Work:
    """Reads q, o, dO, k, v and the fp32 log-sum-exp, writes dq, dk, dv;
    10·D operations a computed pair (the backward's five products) and
    one exponential a pair (P recomputed)."""
    pairs = causal_pairs(sq, sk, causal)
    q, kv = b * hq * sq * d, b * hkv * sk * d
    return Work(ops=10 * b * hq * d * pairs, pipe=_pipe(dtype),
                transcendentals=b * hq * pairs,
                bytes=_size(dtype) * (4 * q + 4 * kv) + 4 * b * hq * sq)


CHUNK = 32       # the scan kernels' time chunk (``kernels/mamba_scan.py``)


def mamba_scan(b: int, s: int, di: int, n: int, dtype,
               chunks: bool = False) -> Work:
    """xdt, dt (B, S, Di), B and C (B, S, N) in ``dtype`` read, y written,
    A (Di, N) read and h_final (B, Di, N) fp32 written (and with
    ``chunks`` the (B, ⌈S/32⌉, Di, N) fp32 chunk states); 7 operations
    and one exponential a (step, channel, state)."""
    el = _size(dtype)
    hc = b * -(-s // CHUNK) * di * n if chunks else 0
    return Work(ops=7 * b * s * di * n, transcendentals=b * s * di * n,
                bytes=el * (3 * b * s * di + 2 * b * s * n)
                + 4 * (di * n + b * di * n + hc))


def mamba_scan_bwd(b: int, s: int, di: int, n: int, dtype) -> Work:
    """Reads xdt, dt, dy, B, C, A and the chunk states, writes dxdt, ddt,
    dB, dC and dA; 16 operations and one exponential (the recompute's) a
    (step, channel, state)."""
    el = _size(dtype)
    hc = b * -(-s // CHUNK) * di * n
    return Work(ops=16 * b * s * di * n, transcendentals=b * s * di * n,
                bytes=el * (5 * b * s * di + 4 * b * s * n)
                + 4 * (2 * di * n + hc))


# the CUDA functions each kernel launches, by a part of their names as the
# profiler shows them (``launch.hlo_stats.extract_cost`` sums their device
# time by kernel)
DEVICE_NAMES = {
    "stft_mag": ("stft_mag_kernel",),
    "haar2d": ("haar2d_kernel", "haar2d_wide_kernel"),
    "minmax_hash": ("minmax_hash_kernel", "RawEpilogue"),
    "minmax_sig_buckets": ("minmax_sig_buckets_kernel", "SigEpilogue"),
    "jaccard_popcount": ("jaccard_popcount_kernel",),
    "occurrence_filter": ("occurrence_filter_",),
    "flash_attention": ("flash_attention_kernel",
                        "flash_attention_mma_kernel"),
    "flash_attention_bwd": ("fa_bwd_", "hop::"),
    "mamba_scan": ("mamba_scan_kernel",),
    "mamba_scan_bwd": ("mamba_scan_bwd_kernel", "sum_middle_kernel"),
}


def kernel_of(device_name: str) -> str | None:
    """The kernel whose CUDA function ``device_name`` is, or None."""
    for name, parts in DEVICE_NAMES.items():
        if any(p in device_name for p in parts):
            return name
    return None


# while not None, receives (kernel name, Work) for every kernel call on
# ``meta`` tensors (set by ``launch.hlo_stats.analyze_step``; a plain
# list, not a context variable, so that a backward running on another
# thread records too)
RECORDER: list | None = None


def record(name: str, work: Work) -> None:
    if RECORDER is not None:
        RECORDER.append((name, work))
