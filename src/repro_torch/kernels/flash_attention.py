"""Blocked causal GQA attention: query head h reads kv head h // group.

The CUDA kernels (``csrc/flash_attention.cu``) replace the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention``: an online softmax
over 64-key KV tiles, fp32 running max, sum and accumulator per q row, KV
tiles above the causal diagonal (offset Sk − Sq) never loaded, ragged Sq
/ Sk masked in the kernel. The work is bound by its operations (4·B·Hq·D
flops per allowed q–k pair; 0.043 ms of bf16 tensor-core time for a
causal 2048² prefill of 40 heads at D = 128).

- bf16 inputs run on the tensor cores (``mma.sync`` m16n8k16, fp32
  accumulate): Q held in registers, K / V tiles double-buffered in
  swizzled shared memory with ``cp.async``, the softmax on the score
  fragments in registers and P rounded to bf16 in registers for P·V (the
  reference's XLA path also rounds P to the value dtype; the Pallas
  kernel keeps it fp32). ``cp.async`` moves 16 bytes a thread, so
  ``kernels.ops.flash_attention`` raises unless q, k and v start on a
  16-byte boundary with batch / head / seq strides that are multiples of
  8 elements.
- fp32 inputs run the exact kernel: fp32 FMAs on the CUDA cores, the path
  the LM parity runs take.

On an H100 80GB HBM3 at 700 W the bf16 kernel takes 0.187 ms for the
causal 2048² prefill (230 TFLOP/s, 4.3× the bound), the fp32 one 1.98 ms
(PERF.md). ``plain`` is the
reference's arithmetic (``repro.kernels.ref.flash_attention``): K and V
repeated per q head, fp32 scores, −inf mask, softmax, fp32 P·V, cast to
q's dtype. ``kernels.ops.flash_attention`` picks between them by device.

Both kernels take element strides for q, k, v and out (last dim
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


def aligned(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel's 16-byte ``cp.async`` loads can read ``t``:
    a 16-byte-aligned start and batch/head/seq strides that are multiples
    of 8 elements (strides of length-1 dims are never used)."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


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
