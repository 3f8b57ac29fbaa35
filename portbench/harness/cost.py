"""The benchmark's yardstick for kernel rooflines: a frozen copy of the
work counts of the detection kernels, their least time on the H100 and
the map from profiler kernel names to kernels.

Copied from the program's ``kernels/cost.py`` so that a later change to
the program cannot move the yardstick. A ``Work`` counts the operations
a call does, on which pipe, the bytes it must move (each input read
once, each output written once) and its transcendentals; where the work
depends on the data (set bits, valid pairs, distinct rows) the caller
passes what its inputs need.
"""
from __future__ import annotations

import dataclasses

# H100 SXM peaks (datasheet at 700 W; CUDA C++ Programming Guide's
# throughput table for compute capability 9.0, 132 SMs at 1.98 GHz),
# except POPC, measured (15.35-15.48 a clock an SM on an H100 80GB HBM3
# at 700 W; the guide's table gives 16)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
INT_OPS_PER_S = 132 * 64 * 1.98e9
MINMAX_COMPARES_PER_S = 2 * INT_OPS_PER_S
POPC_OPS_PER_S = 132 * 15.4 * 1.98e9
PIPES = {"fp32": FP32_OPS_PER_S, "minmax": MINMAX_COMPARES_PER_S,
         "popc": POPC_OPS_PER_S}


@dataclasses.dataclass(frozen=True)
class Work:
    ops: float
    bytes: float
    transcendentals: float = 0.0
    pipe: str = "fp32"
    int_ops: float = 0.0


def bound_ms(w: Work) -> float:
    """The least time for ``w``: bytes over HBM, operations over their
    pipe (other integer operations at the IMNMX rate) or exponentials
    over the SFU, whichever is longest."""
    return max(w.bytes / HBM_BYTES_PER_S * 1e3,
               (w.ops / PIPES[w.pipe] + w.int_ops / INT_OPS_PER_S) * 1e3,
               w.transcendentals / SFU_OPS_PER_S * 1e3)


def minmax_hash(n: int, words: int, h: int, nnz: int) -> Work:
    """(N, words) packed rows × (32·words, H) mappings → two (N, H) planes;
    a min and a max a set bit and column."""
    return Work(ops=2 * nnz * h, pipe="minmax",
                bytes=4 * (n * words + 32 * words * h + 2 * n * h))


def minmax_sig_buckets(n: int, words: int, h: int, t: int,
                       nnz: int) -> Work:
    """``minmax_hash``'s comparisons, then the signature epilogue (6
    integer operations a column, 13 a table); writes (N, T) signatures
    and bucket ids."""
    return Work(ops=2 * nnz * h, pipe="minmax", int_ops=6 * n * h + 13 * n * t,
                bytes=4 * (n * words + 32 * words * h + t + 2 * n * t))


def jaccard_popcount(s: int, m: int, words: int, live: int,
                     rows: int) -> Work:
    """(S, M) pair slots over a packed ring: the ``rows`` distinct ring
    rows that the ``live`` valid pairs read, once each, the valid flags
    and scores (5 bytes a slot) and the valid slots' ids; two POPC a word
    of each valid pair."""
    return Work(ops=2 * live * words, pipe="popc",
                bytes=rows * words * 4 + s * m * 5 + 8 * live)


# the CUDA functions each kernel launches, by a part of their names as
# the profiler shows them
DEVICE_NAMES = {
    "stft_mag": ("stft_mag_kernel",),
    "haar2d": ("haar2d_kernel", "haar2d_wide_kernel"),
    "minmax_hash": ("minmax_hash_kernel", "RawEpilogue"),
    "minmax_sig_buckets": ("minmax_sig_buckets_kernel", "SigEpilogue"),
    "jaccard_popcount": ("jaccard_popcount_kernel",),
}


def kernel_of(device_name: str) -> str | None:
    for name, parts in DEVICE_NAMES.items():
        if any(p in device_name for p in parts):
            return name
    return None
