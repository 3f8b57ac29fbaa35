"""Mamba1 selective scan from h₀ = 0:
h_t = exp(dt_t·A)∘h + (x·dt)_t ⊗ B_t, y_t = h_t·C_t.

The CUDA kernel (``csrc/mamba_scan.cu``) replaces the Pallas kernel
``repro/kernels/mamba_scan.py:mamba_scan``: the state stays in registers
(a thread per 4 states of one channel) while time runs sequentially in
32-step chunks double-buffered in shared memory, and y is reduced over
the states once a chunk, off the recurrence's path, so only xdt, dt, B,
C, y and the final state move through device memory. Its bound is the
exponentials on the SFU and those bytes (~0.06 ms each at
falcon-mamba-7b's 2048-token prefill); its parallelism is B·Di·N lanes.
h_final is bit-identical to the earlier one-lane-a-state kernel; y is
summed over the states in another order. ``plain`` is the
reference's sequential arithmetic (``repro.kernels.ref.mamba_scan``) in
fp32, as the kernel computes: only dt·a is exponentiated, as
``models/ssm.py`` forms its decay. ``kernels.ops.mamba_scan`` picks
between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_STATE = 32       # the kernel keeps one channel's states inside a warp


def plain(xdt: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor, c: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """xdt / dt (B, S, Di), a (Di, N), b / c (B, S, N) → (y (B, S, Di) in
    xdt's dtype, h_final (B, Di, N) fp32)."""
    bsz, s, di = xdt.shape
    xf, dtf, af, bf, cf = (t.float() for t in (xdt, dt, a, b, c))
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                    device=xdt.device)
    ys = []
    for t in range(s):
        g = torch.exp(dtf[:, t, :, None] * af[None])
        h = g * h + xf[:, t, :, None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bsz, 0, di))
    return y.to(xdt.dtype), h


def launch(xdt: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor, c: torch.Tensor, y: torch.Tensor,
           h_final: torch.Tensor) -> None:
    """Launch the CUDA kernel on the current stream (no synchronisation);
    all tensors contiguous."""
    lib = _build.load("mamba_scan")
    fn = lib.mamba_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    bsz, s, di = xdt.shape
    rc = fn(xdt.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), h_final.data_ptr(),
            int(xdt.dtype == torch.bfloat16), bsz, s, di, a.shape[1],
            torch.cuda.current_stream(xdt.device).cuda_stream)
    _build.check(rc, "mamba_scan")
