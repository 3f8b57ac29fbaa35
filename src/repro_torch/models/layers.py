"""Transformer building blocks: RMSNorm, RoPE, attention, SwiGLU.

The counterparts of ``repro.models.layers`` on one device, with its
layouts at every function: weights ``wq`` (d, Hq, hd), ``wo`` (Hq, hd, d);
activations (B, S, H, hd); decode caches (B, S_max, Hkv, hd). Prefill
and training attention (``blocked_attention``) go through the
``flash_attention`` kernel, and its backward through the backward kernel
(``ops.FlashAttentionFn``); decode attention is plain PyTorch. MoE and
the parallel attention + MLP block are not ported yet (ROADMAP queue 1
item 2).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# norms / rope / embeddings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., head_dim/2) for given positions."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) or (S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Rows of the table in the compute dtype. ``F.embedding`` and not
    ``table[tokens]``: the indexing's backward (``index_put_`` with
    accumulation) adds the rows of a repeated token in a different order
    from run to run on the CPU, and a resumed training run must repeat the
    uninterrupted one bit for bit; the embedding's backward sums them in
    a fixed order."""
    return F.embedding(tokens, table.to(cfg.cdtype))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def qkv_project(params: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor):
    """x (B,S,D) → q (B,S,Hq,hd), k/v (B,S,Hkv,hd) with RoPE applied."""
    cd = cfg.cdtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + params["bq"].to(cd)
        k = k + params["bk"].to(cd)
        v = v + params["bv"].to(cd)
    cos, sin = rope_tables(positions, cfg.hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True) -> torch.Tensor:
    """Causal GQA attention with an online softmax, through the
    ``flash_attention`` kernel. q: (B, S, Hq, hd); k/v: (B, S, Hkv, hd) →
    (B, S, Hq, hd).

    The kernel's contract is (B, H, S, D); it takes strides, so the
    transposes here are views and no copy is made. Any S (the reference
    needs S to be a multiple of its attention block). In bf16 the kernel
    rounds p to bf16 before P·V, as the reference's XLA path rounds it to
    the value dtype; in fp32 p stays fp32, as in the Pallas kernel. The
    kernel's tiles are its own: the reference's
    ``cfg.attn_q_block`` / ``attn_kv_block`` have no part here. On the
    card, inputs that require grad take ``ops.FlashAttentionFn``: the
    backward kernel writes dq, dk, dv in the views' own layout."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor
                     ) -> torch.Tensor:
    """Single-token attention against a (B, Skv, Hkv, hd) cache; keys at
    index <= pos[b] count. Scores and the weighted sum accumulate in fp32,
    the weights are rounded to the cache dtype first, as the reference
    does. K and V are grouped, never repeated per q head."""
    b, one, hq, hd = q.shape
    hkv = k_cache.shape[2]
    qg = q.float().reshape(b, one, hkv, hq // hkv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg,
                     k_cache.float()) / math.sqrt(hd)
    ki = torch.arange(k_cache.shape[1], device=q.device)
    s = s.masked_fill(ki > pos[:, None, None, None, None], -1e30)
    w = torch.softmax(s, dim=-1).to(v_cache.dtype).float()
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v_cache.float())
    return out.reshape(b, one, hq, hd).to(q.dtype)


def attention_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, *, return_kv: bool = False):
    """Full pre-norm attention residual block (prefill)."""
    h = rms_norm(x, params["ln"], cfg.rms_eps)
    q, k, v = qkv_project(params, h, cfg, positions)
    o = blocked_attention(q, k, v)
    o = torch.einsum("bshk,hkd->bsd", o, params["wo"].to(cfg.cdtype))
    if return_kv:
        return x + o, (k, v)
    return x + o


def write_kv(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
             cfg: ModelConfig) -> None:
    """Write one step's (B, 1, Hkv, hd) keys or values into a (B, S, Hkv,
    hd) cache, in place.

    ``cfg.uniform_decode_pos``: every row at pos[0], clamped into the
    cache as the reference's dynamic-update-slice clamps; otherwise row b
    at pos[b], and rows whose position is past the cache are dropped, as
    the reference's scatter drops them. Positions stay on the device (no
    host sync)."""
    new = new.to(cache.dtype)
    last = cache.shape[1] - 1
    if cfg.uniform_decode_pos:
        cache.index_copy_(1, pos[:1].long().clamp(max=last), new)
        return
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = pos.long().clamp(max=last)
    keep = (pos > last)[:, None, None]
    cache[rows, at] = torch.where(keep, cache[rows, at], new[:, 0])


def attention_block_decode(params: dict, x: torch.Tensor, cache: dict,
                           pos: torch.Tensor, cfg: ModelConfig):
    """Decode-step attention block; updates the KV cache in place.

    x: (B, 1, D); cache: {"k": (B, S, Hkv, hd), "v": ...}; pos: (B,) int32.
    """
    h = rms_norm(x, params["ln"], cfg.rms_eps)
    q, k_new, v_new = qkv_project(params, h, cfg, pos[:, None])
    write_kv(cache["k"], k_new, pos, cfg)
    write_kv(cache["v"], v_new, pos, cfg)
    o = decode_attention(q, cache["k"], cache["v"], pos)
    o = torch.einsum("bshk,hkd->bsd", o, params["wo"].to(cfg.cdtype))
    return x + o, cache


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_block(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, params["ln"], cfg.rms_eps)
    cd = cfg.cdtype
    g = torch.einsum("bsd,df->bsf", h, params["wg"].to(cd))
    u = torch.einsum("bsd,df->bsf", h, params["wu"].to(cd))
    y = torch.einsum("bsf,fd->bsd", F.silu(g) * u, params["wd"].to(cd))
    return x + y
