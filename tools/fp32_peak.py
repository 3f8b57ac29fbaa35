#!/usr/bin/env python3
"""Measure the card's FP32 FMA rate with operands in registers.

    python3 tools/fp32_peak.py

Builds ``tools/fp32_peak.cu`` with the port's ``nvcc`` flags and times
its probe (8 x 8, 4 x 4 and 2 x 4 accumulators a thread, 4096 FMA rounds)
at 1, 2, 4 and 8 CTAs of 256 threads per SM, CUDA-event medians as
``tools/kernel_ab.py`` takes them. Prints one JSON line per case with the
achieved TFLOP/s (2 flops an FMA). A kernel's gap to the card's
published 67 TFLOP/s can then be read against what plain FMAs reach here.
Needs a CUDA card.
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
        print("fp32_peak: CUDA is not available", file=sys.stderr)
        return 2
    fn = ab.build(ROOT / "tools" / "fp32_peak.cu").probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 256, 4096
    out = torch.empty(8 * sms * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for kind, acc in ((0, 64), (1, 16), (2, 8)):
        for per_sm in (1, 2, 4, 8):
            blocks = per_sm * sms
            ms = ab.time_ms(lambda: fn(out.data_ptr(), kind, blocks, threads,
                                       iters, stream), iters=10)
            print(json.dumps({
                "accumulators": acc, "blocks": blocks, "threads": threads,
                "ms": ms,
                "tflop_s": 2 * acc * iters * blocks * threads / ms * 1e-9}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
