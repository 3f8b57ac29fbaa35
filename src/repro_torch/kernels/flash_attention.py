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
transposed views and no copy is made. Training asks the forward for each
row's log-sum-exp as well (``lse``, fp32 (B, Hq, Sq)), and
``launch_bwd`` runs the backward kernels of the same source, with no
atomics, so the gradients are the same bits run to run. The backward is
bound by its products (10·D flops an allowed q–k pair; 0.109 ms at the
bf16 tensor rate for qwen2.5-14b's causal 2048² of 40 / 8 heads at D =
128). bf16 at D = 64 and 128, the training path, runs Hopper kernels: a
pre-pass for rowsum(dO ∘ O) and the log-sum-exp in log2 units on padded
rows; a dK / dV kernel (one CTA per batch, kv head and 128-key block: two
consumer warpgroups of 64 keys with K and V resident, a producer
warpgroup streaming the group's Q and dO tiles by TMA through an
mbarrier ring, every product on ``wgmma``, P and dS formed in registers
and fed to the next products as register operands), its walk over q
heads and tiles cut in two halves and combined in order when the grid
is short of 1.5 waves; and a dQ kernel (one CTA per batch, q head and
128-row block, K and V tiles streamed, S and dP computed again); key
and q blocks are launched heaviest first. On an H100 80GB HBM3 at 700 W
that takes 0.340 ms at the qwen shape, against 0.347 ms for
``scaled_dot_product_attention``'s backward (PERF.md). bf16 at D = 32
keeps the ``mma.sync`` kernels, fp32 the exact FMA ones. ``plain_bwd`` is
the same FlashAttention-2 formulas in plain torch (P recomputed from the
log-sum-exp, dS = P ∘ (dP − rowsum(dO ∘ O))); it is what the kernels are
held against.
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


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool):
    """fp32 scaled scores (B, Hq, Sq, Sk) with −inf above the causal
    diagonal (offset Sk − Sq), and K repeated per q head (fp32)."""
    sq, d = q.shape[2], q.shape[3]
    group = q.shape[1] // k.shape[1]
    sk = k.shape[2]
    kx = k.repeat_interleave(group, dim=1).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) / math.sqrt(d)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(ki > qi, float("-inf"))
    return scores, kx


def plain_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``plain`` and each row's log-sum-exp of the scaled scores (natural
    log, fp32 (B, Hq, Sq); −inf for a row with no key), as the kernel's
    forward returns them for training."""
    scores, _ = _scores(q, k, causal)
    return plain(q, k, v, causal), torch.logsumexp(scores, dim=-1)


def plain_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``plain``'s output, given its output
    ``o``, its log-sum-exp ``lse`` and the output's gradient ``do``: the
    FlashAttention-2 formulas written out (not autograd), in fp32 —
    P = exp(S − L), dV = Pᵀ dO, dP = dO Vᵀ, dS = P ∘ (dP − rowsum(dO ∘ O)),
    dQ = dS K · scale, dK = dSᵀ Q · scale — with dK and dV summed over each
    kv head's group of q heads. In bf16, P is rounded to bf16 before
    dV = Pᵀ dO, as the forward rounds it before P·V. Each gradient is in
    its input's dtype."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    scores, kx = _scores(q, k, causal)
    live = torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(scores - lse[..., None]),
                    torch.zeros_like(scores))
    pv = p.to(v.dtype).float() if v.dtype == torch.bfloat16 else p
    vx = v.repeat_interleave(group, dim=1).float()
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", pv, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vx)
    ds = p * (dp - (dof * o.float()).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dk = dk.reshape(b, hkv, group, sk, d).sum(2)
    dv = dv.reshape(b, hkv, group, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def aligned(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel's 16-byte ``cp.async`` loads can read ``t``:
    a 16-byte-aligned start and batch/head/seq strides that are multiples
    of 8 elements (strides of length-1 dims are never used)."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool,
           lse: torch.Tensor | None = None) -> None:
    """Launch the CUDA kernel on the current stream (no synchronisation);
    every tensor's last dim is contiguous, the other strides are free.
    ``lse`` (fp32 (B, Hq, Sq) contiguous, or None) receives each row's
    log-sum-exp."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p]
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, out) for s in t.stride()[:3]])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, hq, hkv, sq, sk, d, strides,
            int(causal), 1.0 / math.sqrt(d),
            None if lse is None else lse.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
               dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
               causal: bool, events=None) -> None:
    """Launch the backward kernels on the current stream (no
    synchronisation): dq, dk, dv from q, k, v, the forward's output ``o``
    and log-sum-exp ``lse`` and the output's gradient ``do``. Every
    tensor's last dim is contiguous, the other strides are free.
    ``events`` (5 ``torch.cuda.Event``, or None) are recorded before the
    first kernel and after the Dv pre-pass, dK / dV, the combine of its
    split parts (after dK / dV again where there is none) and dQ."""
    lib = _build.load("flash_attention")
    scratch_n = lib.flash_attention_bwd_scratch
    scratch_n.restype = ctypes.c_longlong
    scratch_n.argtypes = [ctypes.c_int] * 7
    fn = lib.flash_attention_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p]
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    is_bf16 = int(q.dtype == torch.bfloat16)
    strides = (ctypes.c_longlong * 24)(*[
        s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]])
    scratch = torch.empty((scratch_n(is_bf16, b, hq, hkv, sq, sk, d),),
                          dtype=torch.float32, device=q.device)
    ev = None
    if events is not None:
        for e in events:     # a torch event makes its CUDA event when recorded
            e.record()
        ev = (ctypes.c_void_p * 5)(*[e.cuda_event for e in events])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), is_bf16, b, hq, hkv, sq, sk,
            d, strides, int(causal), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream, ev)
    _build.check(rc, "flash_attention_bwd")
