"""Blocked causal GQA attention: query head h reads kv head h // group.

The CUDA kernel (``csrc/flash_attention.cu``) replaces the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention``: an online softmax
over 64-row KV tiles in shared memory, fp32 running max, sum and
accumulator per q row, KV tiles above the causal diagonal (offset
Sk − Sq) never loaded, ragged Sq / Sk masked in the kernel. It is bound
by its operations (4·B·Hq·D flops per allowed q–k pair; 0.043 ms of bf16
tensor-core time for a causal 2048² prefill of 40 heads at D = 128) and
does them with fp32 FMAs on the CUDA cores for now: exact fp32 products,
far above the bound (PERF.md). ``plain`` is the reference's arithmetic
(``repro.kernels.ref.flash_attention``): K and V repeated per q head,
fp32 scores, −inf mask, softmax, fp32 P·V, cast to q's dtype.
``kernels.ops.flash_attention`` picks between them by device.

The kernel takes element strides for q, k, v and out (last dim
contiguous), so the model passes its (B, S, H, D) activations as
transposed views and no copy is made.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)     # head sizes the kernel is instantiated for


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          causal: bool = True) -> torch.Tensor:
    """q (B, Hq, Sq, D), k / v (B, Hkv, Sk, D) → (B, Hq, Sq, D) in q's
    dtype."""
    sq, d = q.shape[2], q.shape[3]
    group = q.shape[1] // k.shape[1]
    sk = k.shape[2]
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) / math.sqrt(d)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(ki > qi, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vx).to(q.dtype)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool) -> None:
    """Launch the CUDA kernel on the current stream (no synchronisation);
    every tensor's last dim is contiguous, the other strides are free."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, out) for s in t.stride()[:3]])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, hq, hkv, sq, sk, d, strides,
            int(causal), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
