#!/usr/bin/env python3
"""Measure the rates the Min-Max and Jaccard kernels rest on.

    python3 tools/int_minmax_peak.py

Builds ``tools/int_minmax_peak.cu`` with the port's ``nvcc`` flags and
times five probes, CUDA-event medians as ``tools/kernel_ab.py`` takes
them (1, 2 or 4 CTAs of 256 threads an SM; the gather 432 or 4,320
rows):

- ``imnmx``: 32-bit ``min``/``max`` with operands in registers (16
  independent accumulator pairs a thread); counts one comparison a result.
- ``dpx``: ``__vimin3_s32``/``__vimax3_s32``; counts two comparisons a
  result.
- ``popc``: 32-bit population counts (``__popc``) of registers, 16
  independent chains a thread, each count added into the next one's
  operand (one POPC and one IADD a count); the rate behind
  ``chip_smoke.py``'s ``POPC_OPS_PER_S``; counts one a result.
- ``lds128``: a warp loads one contiguous 512-byte shared-memory row (16
  bytes a lane), 8 loads in flight; bytes a clock an SM.
- ``l2_gather``: the row kernel's access pattern, a CTA a row, thread h
  loading ``mappings[d, h]`` for 400 pseudo-random d of 8192, over a
  (8192, 400) int32 table (13.1 MB, resident in the 50 MB L2); bytes
  loaded a second.

Last, ``clusters`` lines: the thread block clusters of 1, 2, 4 and 8 CTAs
the card keeps resident (``cudaOccupancyMaxActiveClusters``) at 512
threads and 164,352 or 73,728 bytes of shared memory a CTA (one or three
CTAs an SM).

Each rate line gives the comparisons (or counts, or bytes) a second
over the card's SMs, the SM clock (thread 0 of block 0's ``clock64``
span over the event time, at one CTA an SM; the other cases take the
clock of the last such probe) and the rate a clock an SM. Needs a CUDA
card.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))


def main() -> int:
    import torch
    import kernel_ab as ab
    if not torch.cuda.is_available():
        print("int_minmax_peak: CUDA is not available", file=sys.stderr)
        return 2
    lib = ab.build(ROOT / "tools" / "int_minmax_peak.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, types in (("minmax_probe_launch", [vp, vp] + [ci] * 4 + [vp]),
                        ("lds128_probe_launch", [vp, vp] + [ci] * 3 + [vp]),
                        ("popc_probe_launch", [vp, vp] + [ci] * 3 + [vp]),
                        ("gather_probe_launch",
                         [vp] + [ci] * 4 + [vp, vp, vp])):
        getattr(lib, name).restype = ci
        getattr(lib, name).argtypes = types
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    out = torch.empty(max(4 * sms * 256, 4320 * 400), dtype=torch.int32,
                      device="cuda")
    clock = {}

    def report(probe: str, fn, per_launch: float, unit: str,
               clocked: bool = False, **extra):
        """``clocked``: one CTA an SM, so block 0's clock span is the
        kernel's and gives the SM clock; the other cases take the last
        such clock."""
        rc = fn()
        torch.cuda.synchronize()
        if rc != 0:
            raise SystemExit(f"{probe}: launch failed, cudaError {rc}")
        ms = ab.time_ms(fn, iters=10)
        if clocked:
            clock["mhz"] = float(cycles.item()) / ms * 1e-3
        print(json.dumps({
            "probe": probe, **extra, "ms": ms, "sm_mhz": clock["mhz"],
            f"{unit}_per_clk_sm": per_launch / (ms * 1e3 * clock["mhz"]
                                                * sms),
            f"{unit}_per_s": per_launch / ms * 1e3}), flush=True)

    threads, iters = 256, 4096
    for kind, probe, per_result in ((0, "imnmx", 1), (1, "dpx", 2)):
        for per_sm in (1, 2, 4):
            blocks = per_sm * sms
            # 16 min and 16 max results a thread an iteration
            results = 2 * 16 * iters * blocks * threads
            report(probe, lambda: lib.minmax_probe_launch(
                out.data_ptr(), cycles.data_ptr(), kind, blocks, threads,
                iters, stream), results * per_result, "compares",
                per_sm == 1, blocks=blocks)
    for per_sm in (1, 2, 4):
        blocks = per_sm * sms
        report("popc", lambda: lib.popc_probe_launch(
            out.data_ptr(), cycles.data_ptr(), blocks, threads, iters,
            stream), 16 * iters * blocks * threads, "popc", per_sm == 1,
            blocks=blocks)
    for per_sm in (1, 2, 4):
        blocks = per_sm * sms
        loaded = 8 * 512 * iters * blocks * threads // 32
        report("lds128", lambda: lib.lds128_probe_launch(
            out.data_ptr(), cycles.data_ptr(), blocks, threads, iters,
            stream), loaded, "bytes", per_sm == 1, blocks=blocks)
    d, h, nnz = 8192, 400, 400
    g = torch.Generator(device="cuda").manual_seed(0)
    mappings = torch.randint(0, 2**31 - 1, (d, h), generator=g,
                             device="cuda", dtype=torch.int32)
    for rows in (432, 4320):
        report("l2_gather", lambda: lib.gather_probe_launch(
            mappings.data_ptr(), d, h, nnz, rows, out.data_ptr(),
            cycles.data_ptr(), stream), 4.0 * rows * nnz * h, "bytes",
            rows=rows, table_bytes=4 * d * h)
    fn = lib.max_active_clusters
    fn.restype, fn.argtypes = ci, [ci, ci, ci]
    for smem in (164_352, 73_728):
        print(json.dumps({"clusters": {
            size: fn(512, smem, size) for size in (1, 2, 4, 8)},
            "threads": 512, "smem": smem}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
