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

Training asks the forward for the state entering each 32-step chunk
(``h_chunks``, (B, ⌈S/32⌉, Di, N) fp32), and ``launch_bwd`` runs the
backward kernel of the same source. It is issue-bound on the SMs (its
bytes take 0.22 ms and its one exponential an element 0.13 ms at
falcon-mamba-7b's training microbatch, (2, 2048, 8192, 16) fp32). The
chunks are taken in reverse: a thread recomputes its 2 states' h_t and
g_t = exp(dt·a) for the chunk's 32 steps from the stored state, with the
forward's arithmetic, keeping the first 16 steps' in shared memory and
the last 16's in registers, then carries the adjoint backwards
(dh_{t−1} = g_t·dh_t + C_{t−1}·dy_{t−1}) through both halves with no
exponential of its own; the next chunk's inputs arrive by ``cp.async``
meanwhile. dxdt / ddt are reduced over a channel's lanes and dB / dC over
a warp's channels by shuffles each step, then over the CTA's 16 warps
once a half into per-CTA partials of 64 channels, which a second kernel
sums in order with da's per-batch-row partials (no atomics, so the
gradients are the same bits run to run). On an H100 80GB HBM3 at 700 W
that takes 1.42 ms at the training shape (PERF.md). ``plain_bwd`` is
the same adjoint recurrence in plain torch, what the kernel is held
against.
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


def plain_bwd(xdt: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
              dh_final: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, ...]:
    """The gradients (dxdt, ddt, da, db, dc) of ``plain``'s outputs, given
    dy (B, S, Di) and dh_final (B, Di, N) fp32 or None (zero): the adjoint
    recurrence written out (not autograd), in fp32. With λ_t = ∂L/∂h_t,
    walking time backwards: λ_t += dy_t C_t; dxdt_t = Σ_n λ_t B_t;
    ddt_t = Σ_n λ_t h_{t−1} g_t a; da += λ_t h_{t−1} g_t dt_t;
    dB_t = Σ_d λ_t xdt_t; dC_t = Σ_d dy_t h_t; λ_{t−1} = g_t λ_t. dxdt,
    ddt, db, dc come in xdt's dtype, da in fp32."""
    bsz, s, di = xdt.shape
    xf, dtf, af, bf, cf, dyf = (t.float() for t in (xdt, dt, a, b, c, dy))
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                    device=xdt.device)
    hs = []
    for t in range(s):
        g = torch.exp(dtf[:, t, :, None] * af[None])
        h = g * h + xf[:, t, :, None] * bf[:, t, None, :]
        hs.append(h)
    lam = torch.zeros_like(h) if dh_final is None else dh_final.float()
    dx, ddt = torch.zeros_like(xf), torch.zeros_like(xf)
    db, dc = torch.zeros_like(bf), torch.zeros_like(cf)
    da = torch.zeros_like(af)
    for t in reversed(range(s)):
        lam = lam + dyf[:, t, :, None] * cf[:, t, None, :]
        hprev = hs[t - 1] if t else torch.zeros_like(h)
        g = torch.exp(dtf[:, t, :, None] * af[None])
        dx[:, t] = (lam * bf[:, t, None, :]).sum(-1)
        dg = lam * hprev * g
        ddt[:, t] = (dg * af[None]).sum(-1)
        da += (dg * dtf[:, t, :, None]).sum(0)
        db[:, t] = (lam * xf[:, t, :, None]).sum(1)
        dc[:, t] = (dyf[:, t, :, None] * hs[t]).sum(1)
        lam = lam * g
    return (dx.to(xdt.dtype), ddt.to(xdt.dtype), da, db.to(xdt.dtype),
            dc.to(xdt.dtype))


CHUNK = 32           # the kernels' time chunk: h_chunks holds one state each


def launch(xdt: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor, c: torch.Tensor, y: torch.Tensor,
           h_final: torch.Tensor, h_chunks: torch.Tensor | None = None
           ) -> None:
    """Launch the CUDA kernel on the current stream (no synchronisation);
    all tensors contiguous. ``h_chunks`` ((B, ⌈S/32⌉, Di, N) fp32, or
    None) receives the state entering each chunk."""
    lib = _build.load("mamba_scan")
    fn = lib.mamba_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    bsz, s, di = xdt.shape
    rc = fn(xdt.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), h_final.data_ptr(),
            None if h_chunks is None else h_chunks.data_ptr(),
            int(xdt.dtype == torch.bfloat16), bsz, s, di, a.shape[1],
            torch.cuda.current_stream(xdt.device).cuda_stream)
    _build.check(rc, "mamba_scan")


def launch_bwd(xdt: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
               dh_final: torch.Tensor | None, h_chunks: torch.Tensor,
               grads: tuple[torch.Tensor, ...], events=None) -> None:
    """Launch the backward kernels on the current stream (no
    synchronisation) into ``grads`` = (dxdt, ddt, da, db, dc); all tensors
    contiguous, ``h_chunks`` from the forward. ``events`` (4
    ``torch.cuda.Event``, or None) are recorded before the main kernel and
    after it, the dB / dC sum and the da sum."""
    lib = _build.load("mamba_scan")
    scratch_n = lib.mamba_scan_bwd_scratch
    scratch_n.restype = ctypes.c_longlong
    scratch_n.argtypes = [ctypes.c_int] * 4
    fn = lib.mamba_scan_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_void_p]
    bsz, s, di = xdt.shape
    n = a.shape[1]
    scratch = torch.empty((scratch_n(bsz, s, di, n),), dtype=torch.float32,
                          device=xdt.device)
    dx, ddt, da, db, dc = grads
    ev = None
    if events is not None:
        for e in events:     # a torch event makes its CUDA event when recorded
            e.record()
        ev = (ctypes.c_void_p * 4)(*[e.cuda_event for e in events])
    rc = fn(xdt.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), dy.data_ptr(),
            None if dh_final is None else dh_final.data_ptr(),
            h_chunks.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            da.data_ptr(), db.data_ptr(), dc.data_ptr(), scratch.data_ptr(),
            int(xdt.dtype == torch.bfloat16), bsz, s, di, n,
            torch.cuda.current_stream(xdt.device).cuda_stream, ev)
    _build.check(rc, "mamba_scan_bwd")
