"""Transformer building blocks: RMSNorm, RoPE, attention, SwiGLU, the
parallel attention + MLP block, MoE (shared + routed experts).

The counterparts of ``repro.models.layers`` on one device, with its
layouts at every function: weights ``wq`` (d, Hq, hd), ``wo`` (Hq, hd, d),
routed experts ``wg`` / ``wu`` (E, d, F) and ``wd`` (E, F, d);
activations (B, S, H, hd); decode caches (B, S_max, Hkv, hd). Prefill
and training attention (``blocked_attention``) go through the
``flash_attention`` kernel, and its backward through the backward kernel
(``ops.FlashAttentionFn``); decode attention is plain PyTorch. The MoE's
routing, dispatch and grouped expert products are plain PyTorch, as the
reference runs them in XLA; under a mesh with a ``model`` axis the
routed experts are split over it (expert parallelism, ``_moe_ep``).

Under the tp layout the ``model`` axis splits the math the Megatron way,
as the reference's sharding constraints split it
(``dist.TensorParallel``): attention by heads (q heads from the rank's
``wq`` block, the kv heads they read, ``wo`` row-parallel), the SwiGLU
MLP and the shared experts by ``d_ff``, the embedding by vocab rows.
Each block's input goes through "f" and its output through one "g" (the
parallel block: one for both branches). The ``*_partial`` functions
compute a rank's partial output of a block for any ``TensorParallel``,
so ranks played in turn in one process can be summed by their caller
(``qkv_partial`` is the reference's ``qkv_project`` for a rank's heads:
it projects q, k and v and applies RoPE).
Decode attention is the flash-decode over the rank's sequence block of
the cache: every q head, the combine three all_reduces.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import dist, utils
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

# the vocabulary is padded to a multiple of this (``decoder.padded_vocab``)
VOCAB_PAD = 2048


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
    a fixed order.

    Under the tp layout the table is this rank's block of vocab rows:
    tokens outside it give zeros, and "g" sums the ranks' rows (exact:
    one non-zero row is added to zeros)."""
    tp = dist.tensor_parallel()
    if tp.mesh is None:
        return F.embedding(tokens, table.to(cfg.cdtype))
    v = utils.round_up(cfg.vocab_size, VOCAB_PAD)
    lo, hi = tp.block(v)
    rows = tp.part(table, 0, v)
    local = tokens.long() - lo
    inside = (local >= 0) & (local < hi - lo)
    out = F.embedding(local.clamp(0, hi - lo - 1), rows.to(cfg.cdtype))
    return tp.sum(torch.where(inside[..., None], out, 0.0))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _kv_needed(cfg: ModelConfig, tp: dist.TensorParallel
               ) -> tuple[int, int]:
    """[lo, hi) of the kv heads this rank's q heads read (GQA: q head h
    reads kv head h // (Hq / Hkv))."""
    lo, hi = tp.block(cfg.n_heads)
    g = cfg.n_heads // cfg.n_kv_heads
    return (lo // g, lo // g) if hi == lo else (lo // g, (hi - 1) // g + 1)


def qkv_partial(params: dict, h: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, tp: dist.TensorParallel, *,
                whole_kv: bool = False):
    """This rank's q heads and the kv heads they read, RoPE applied → (q
    (B,S,Hq/M,hd), k, v (B,S,·,hd), kv head offset), ``h`` already
    through "f". Where the rules split ``wk`` / ``wv`` over ``model`` the
    rank's block of kv heads is used when it covers the ones needed (else
    k and v are gathered, in one call); where they keep them whole the
    rank computes every kv head and cuts the ones needed. ``whole_kv``:
    k / v of every kv head (prefill's cache, decode), offset 0."""
    cd = cfg.cdtype
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    q = torch.einsum("bsd,dhk->bshk", h, tp.part(params["wq"], 1, hq).to(cd))
    if cfg.qkv_bias:
        q = q + tp.part(params["bq"], 0, hq).to(cd)
    k = torch.einsum("bsd,dhk->bshk", h, params["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", h, params["wv"].to(cd))
    if cfg.qkv_bias:
        k = k + params["bk"].to(cd)
        v = v + params["bv"].to(cd)
    cos, sin = rope_tables(positions, cfg.hd, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if tp.size == 1:
        return q, k, v, 0
    have = (0, hkv) if params["wk"].shape[1] == hkv else tp.block(hkv)
    need = (0, hkv) if whole_kv else _kv_needed(cfg, tp)
    if not (have[0] <= need[0] and need[1] <= have[1]):
        k, v = tp.gather_sum_grad(torch.stack([k, v]), 3, hkv)
        have = (0, hkv)
    lo = need[0] - have[0]
    k = k.narrow(2, lo, need[1] - need[0])
    v = v.narrow(2, lo, need[1] - need[0])
    return q, k, v, need[0]


def _grouped(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
             tp: dist.TensorParallel, kv_lo: int):
    """k / v laid out for the kernel's GQA (local q head i reads local kv
    head i // (Hq_loc / Hkv_loc)): as they are where the rank's q heads
    fall on whole groups, else one kv head a q head."""
    lo, hi = tp.block(cfg.n_heads)
    g = cfg.n_heads // cfg.n_kv_heads
    want = [(lo + i) // g - kv_lo for i in range(hi - lo)]
    nq, nkv = hi - lo, k.shape[2]
    if nkv and nq % nkv == 0 and want == [i // (nq // nkv)
                                          for i in range(nq)]:
        return k, v
    idx = torch.tensor(want, dtype=torch.long, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


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
    backward kernel writes dq, dk, dv in the views' own layout. No head
    (a tensor-parallel rank whose block of heads is empty): no work, and
    no kernel is launched."""
    if q.shape[2] == 0:
        return q * 0
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     tp: dist.TensorParallel | None = None,
                     seq_lo: int = 0) -> torch.Tensor:
    """Single-token attention against a (B, Skv, Hkv, hd) cache; keys at
    index <= pos[b] count. Scores and the weighted sum accumulate in fp32,
    the weights exp(s − m) / l are rounded to the cache dtype first, as
    the reference rounds its softmax. K and V are grouped, never repeated
    per q head.

    ``tp``: the cache is this rank's block of the sequence, starting at
    ``seq_lo`` (the flash-decode of the sequence-sharded cache), and q
    has every head. The combine is three all_reduces over the ranks: the
    max of the scores, Σ exp(s − m), and — once the weights are rounded
    with the global m and l — the weighted sum of V. A block may be
    short or empty (uneven sharding: blocks of ⌈S / ranks⌉): an empty
    one adds nothing to any of the three."""
    tp = tp or dist.TensorParallel()
    b, one, hq, hd = q.shape
    hkv = k_cache.shape[2]
    qg = q.float().reshape(b, one, hkv, hq // hkv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg,
                     k_cache.float()) / math.sqrt(hd)
    ki = seq_lo + torch.arange(k_cache.shape[1], device=q.device)
    s = s.masked_fill(ki > pos[:, None, None, None, None], -1e30)
    mx = s.amax(-1, keepdim=True) if s.shape[-1] else \
        s.new_full((*s.shape[:-1], 1), -1e30)
    m = tp.reduce(mx, torch.distributed.ReduceOp.MAX)
    e = torch.exp(s - m)
    den = tp.reduce(e.sum(-1, keepdim=True))
    w = (e / den).to(v_cache.dtype).float()
    out = tp.reduce(torch.einsum("bkgqs,bskd->bqkgd", w, v_cache.float()))
    return out.reshape(b, one, hq, hd).to(q.dtype)


def attention_partial(params: dict, h: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, tp: dist.TensorParallel, *,
                      return_kv: bool = False):
    """This rank's partial sum of the attention's output projection (B,
    S, D) from the normed input ``h`` (already through "f"): its q heads
    through ``flash_attention``, then its rows of ``wo``. ``return_kv``:
    also (k, v) of every kv head (prefill)."""
    q, k, v, kv_lo = qkv_partial(params, h, cfg, positions, tp,
                                 whole_kv=return_kv)
    kv = (k, v)
    if tp.size > 1:
        if return_kv:
            kv_lo, hi = _kv_needed(cfg, tp)
            k, v = k[:, :, kv_lo:hi], v[:, :, kv_lo:hi]
        k, v = _grouped(k, v, cfg, tp, kv_lo)
    o = blocked_attention(q, k, v)
    wo = tp.part(params["wo"], 0, cfg.n_heads)
    o = torch.einsum("bshk,hkd->bsd", o, wo.to(cfg.cdtype))
    return (o, kv) if return_kv else o


def attention_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, *, return_kv: bool = False):
    """Full pre-norm attention residual block (prefill)."""
    tp = dist.tensor_parallel()
    h = tp.sum_grad(rms_norm(x, params["ln"], cfg.rms_eps))
    o = attention_partial(params, h, cfg, positions, tp,
                          return_kv=return_kv)
    if return_kv:
        o, kv = o
        return x + tp.sum(o), kv
    return x + tp.sum(o)


def write_kv(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
             cfg: ModelConfig, seq_lo: int = 0,
             seq_len: int | None = None) -> None:
    """Write one step's (B, 1, Hkv, hd) keys or values into a (B, S, Hkv,
    hd) cache, in place.

    ``cfg.uniform_decode_pos``: every row at pos[0], clamped into the
    cache as the reference's dynamic-update-slice clamps; otherwise row b
    at pos[b], and rows whose position is past the cache are dropped, as
    the reference's scatter drops them. Positions stay on the device (no
    host sync). ``seq_lo`` / ``seq_len``: the cache is the block from
    ``seq_lo`` of a sequence of ``seq_len`` (short or empty where uneven
    sharding cut it); the clamp and the drop hold for the whole sequence,
    and only the rank whose block holds the position writes."""
    new = new.to(cache.dtype)
    n = cache.shape[1]
    if n == 0:
        return
    last = (n if seq_len is None else seq_len) - 1
    whole = seq_lo == 0 and last == n - 1
    if cfg.uniform_decode_pos:
        p = pos[:1].long().clamp(max=last)
        if whole:
            cache.index_copy_(1, p, new)
            return
        at = (p - seq_lo).clamp(0, n - 1)
        mine = ((p >= seq_lo) & (p < seq_lo + n))[:, None, None, None]
        cache.index_copy_(1, at, torch.where(mine, new,
                                             cache.index_select(1, at)))
        return
    rows = torch.arange(cache.shape[0], device=cache.device)
    p = pos.long()
    at = (p.clamp(max=last) - seq_lo).clamp(0, n - 1)
    keep = (p > last) | (p < seq_lo) | (p >= seq_lo + n)
    cache[rows, at] = torch.where(keep[:, None, None], cache[rows, at],
                                  new[:, 0])


def attention_decode_partial(params: dict, h: torch.Tensor, cache: dict,
                             pos: torch.Tensor, cfg: ModelConfig,
                             tp: dist.TensorParallel,
                             seq: tuple[int, int] | None = None,
                             write_pos: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """A decode step's attention as this rank's partial sum of the output
    projection (B, 1, D); writes the new k / v into ``cache`` in place.
    Every q head (the rank's, gathered), the new k / v of every kv head,
    written by the rank whose block holds the position; ``seq`` (its
    first position, the sequence's length): the cache is this rank's
    block of the sequence (the flash-decode combine), else (None) whole.
    ``write_pos``: the positions ``write_kv`` takes
    where they are not ``pos`` (the global batch's, whose first one the
    uniform mode writes at, when ``pos`` is this rank's rows)."""
    q, k_new, v_new, _ = qkv_partial(params, h, cfg, pos[:, None], tp,
                                     whole_kv=True)
    q = tp.gather(q, 2, cfg.n_heads) if tp.size > 1 else q
    lo, total = (0, cache["k"].shape[1]) if seq is None else seq
    for name, new in (("k", k_new), ("v", v_new)):
        write_kv(cache[name], new, pos if write_pos is None else write_pos,
                 cfg, lo, total)
    o = decode_attention(q, cache["k"], cache["v"], pos,
                         None if seq is None else tp, lo)
    hlo, hhi = tp.block(cfg.n_heads)
    wo = tp.part(params["wo"], 0, cfg.n_heads)
    return torch.einsum("bshk,hkd->bsd", o[:, :, hlo:hhi],
                        wo.to(cfg.cdtype))


def attention_block_decode(params: dict, x: torch.Tensor, cache: dict,
                           pos: torch.Tensor, cfg: ModelConfig,
                           seq: tuple[int, int] | None = None,
                           write_pos: torch.Tensor | None = None):
    """Decode-step attention block; updates the KV cache in place.

    x: (B, 1, D); cache: {"k": (B, S, Hkv, hd), "v": ...}; pos: (B,) int32
    (``seq`` / ``write_pos``: see ``attention_decode_partial``).
    """
    tp = dist.tensor_parallel()
    h = tp.sum_grad(rms_norm(x, params["ln"], cfg.rms_eps))
    o = attention_decode_partial(params, h, cache, pos, cfg, tp, seq,
                                 write_pos)
    return x + tp.sum(o), cache


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU)
# ---------------------------------------------------------------------------


def _swiglu(h: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            wd: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(silu(h·wg) ⊙ h·wu)·wd over (B, S, d) in the compute dtype."""
    cd = cfg.cdtype
    g = torch.einsum("bsd,df->bsf", h, wg.to(cd))
    u = torch.einsum("bsd,df->bsf", h, wu.to(cd))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, wd.to(cd))


def mlp_partial(params: dict, h: torch.Tensor, cfg: ModelConfig,
                tp: dist.TensorParallel, names=("wg", "wu", "wd")
                ) -> torch.Tensor:
    """This rank's partial sum of a SwiGLU (the dense MLP, or the shared
    experts with ``names`` ("swg", "swu", "swd")): its columns of the
    gate and up projections, its rows of the down projection; ``h``
    already through "f"."""
    g, u, d = names
    f = cfg.d_ff if g == "wg" else cfg.n_shared_experts * cfg.expert_ff
    return _swiglu(h, tp.part(params[g], 1, f), tp.part(params[u], 1, f),
                   tp.part(params[d], 0, f), cfg)


def mlp_block(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    tp = dist.tensor_parallel()
    h = tp.sum_grad(rms_norm(x, params["ln"], cfg.rms_eps))
    return x + tp.sum(mlp_partial(params, h, cfg, tp))


def parallel_partial(attn_params: dict, mlp_params: dict, h: torch.Tensor,
                     cfg: ModelConfig, positions: torch.Tensor | None,
                     tp: dist.TensorParallel, *, cache: dict | None = None,
                     pos: torch.Tensor | None = None,
                     seq: tuple[int, int] | None = None,
                     write_pos: torch.Tensor | None = None,
                     return_kv: bool = False):
    """This rank's partial sum of the parallel block's two branches,
    attention + MLP, added before the one "g" (the reference's single
    psum); ``h`` already through "f". Prefill / training, or a decode
    step with ``cache`` / ``pos`` (written in place). ``return_kv``: also
    (k, v) of every kv head."""
    kv = None
    if cache is not None:
        ao = attention_decode_partial(attn_params, h, cache, pos, cfg, tp,
                                      seq, write_pos)
    else:
        ao = attention_partial(attn_params, h, cfg, positions, tp,
                               return_kv=return_kv)
        if return_kv:
            ao, kv = ao
    out = ao + mlp_partial(mlp_params, h, cfg, tp)
    return (out, kv) if return_kv else out


def parallel_attn_mlp_block(attn_params: dict, mlp_params: dict,
                            x: torch.Tensor, cfg: ModelConfig,
                            positions: torch.Tensor | None, *,
                            cache: dict | None = None,
                            pos: torch.Tensor | None = None,
                            return_kv: bool = False,
                            seq: tuple[int, int] | None = None,
                            write_pos: torch.Tensor | None = None):
    """Command-r-style parallel block: y = x + (attn(ln(x)) + mlp(ln(x))),
    one norm (the attention's ``ln``) for both branches, their sum added
    to the residual once, as in the reference.

    Prefill / training: ``positions`` (S,), attention through the
    ``flash_attention`` kernel; ``return_kv`` → (y, (k, v)). Decode:
    ``cache`` {"k", "v"} (B, S, Hkv, hd) written in place at ``pos`` (B,)
    by ``write_kv`` (either ``uniform_decode_pos`` mode) → (y, cache)."""
    tp = dist.tensor_parallel()
    h = tp.sum_grad(rms_norm(x, attn_params["ln"], cfg.rms_eps))
    out = parallel_partial(attn_params, mlp_params, h, cfg, positions, tp,
                           cache=cache, pos=pos, seq=seq,
                           write_pos=write_pos, return_kv=return_kv)
    if return_kv:
        out, kv = out
        return x + tp.sum(out), kv
    y = x + tp.sum(out)
    return (y, cache) if cache is not None else y


# ---------------------------------------------------------------------------
# MoE (shared + routed experts, expert parallelism over a mesh)
# ---------------------------------------------------------------------------


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert takes per call: ⌈T·k·capacity_factor / E⌉, at
    least 8. T is the call's token count: a prefill's B·S, a decode
    step's B."""
    c = int(math.ceil(n_tokens * cfg.moe_top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, c)


def _route(h2: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    """(T, D) tokens → (top-k expert ids (T, k) int64, combine weights
    (T, k) fp32 summing to 1, Switch-style load-balance aux loss).

    The logits are fp32 (on the card TF32 must be off, or the routing
    drifts from the CPU's). Top-k is the first k of a stable descending
    sort, so among equal probabilities the lower expert id comes first,
    as ``jax.lax.top_k`` orders them (``torch.topk``'s order among ties
    is unspecified)."""
    k, e = cfg.moe_top_k, cfg.n_experts
    logits = torch.matmul(h2.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    density = F.one_hot(top_e[:, 0], e).float().mean(0)
    aux = e * (density * probs.mean(0)).sum()
    return top_e, top_w, aux


def _rank_within_expert(flat_e: torch.Tensor,
                        n_experts: int) -> torch.Tensor:
    """Arrival rank of each (token, slot) within its expert, in
    token-major order of ``flat_e`` (T·k,): the number of earlier entries
    with the same expert. int64. The one-hot is (E, T·k), so that the
    running count runs along the contiguous dim (a scan along the outer
    dim of a (T·k, E) one-hot took half of an MoE prefill's device
    time on the card)."""
    flat_e = flat_e.long()
    experts = torch.arange(n_experts, device=flat_e.device)
    onehot = (flat_e[None, :] == experts[:, None]).long()   # (E, T·k)
    csum = onehot.cumsum(1) - 1
    return csum.gather(0, flat_e[None, :])[0]


def _moe_local(h2: torch.Tensor, top_e: torch.Tensor, top_w: torch.Tensor,
               wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
               e_base: int, cfg: ModelConfig) -> torch.Tensor:
    """Dispatch → grouped expert products → combine, for the experts
    ``e_base`` .. ``e_base + wg.shape[0] − 1``.

    h2: (T, D); wg / wu: (E_loc, D, F); wd: (E_loc, F, D) → (T, D), zero
    for the (token, slot) pairs routed elsewhere or past an expert's
    capacity (the later arrivals). Every kept (expert, rank) pair is
    unique, so the dispatch assigns the kept rows into a zero buffer
    (no accumulation); the dropped pairs all land in the extra row
    ``cap``, which is cut."""
    t, d = h2.shape
    e_loc = wg.shape[0]
    k = cfg.moe_top_k
    cap = _capacity(t, cfg)
    flat_e = top_e.reshape(-1).long()                     # (T·k,)
    rank = _rank_within_expert(flat_e, cfg.n_experts)
    local_e = flat_e - e_base
    ok = (local_e >= 0) & (local_e < e_loc) & (rank < cap)
    le = torch.where(ok, local_e, 0)
    rr = torch.where(ok, rank, cap)                       # cap → dropped
    buf = h2.new_zeros((e_loc, cap + 1, d))
    buf[le, rr] = h2.repeat_interleave(k, dim=0)
    buf = buf[:, :cap]
    cd = h2.dtype
    g = torch.bmm(buf, wg.to(cd))
    u = torch.bmm(buf, wu.to(cd))
    y = torch.bmm(F.silu(g) * u, wd.to(cd))               # (E_loc, cap, D)
    y = torch.cat([y, y.new_zeros((e_loc, 1, d))], dim=1)
    gathered = torch.where(ok[:, None], y[le, rr], 0)     # (T·k, D)
    w = top_w.reshape(-1)[:, None].to(cd)
    return (gathered * w).reshape(t, k, d).sum(dim=1)


def expert_parallel(cfg: ModelConfig) -> bool:
    """The reference's condition for expert parallelism: a mesh with a
    ``model`` axis whose size divides ``n_experts``."""
    mesh = dist.current_mesh()
    return (mesh is not None and "model" in mesh.shape
            and cfg.n_experts % mesh.shape["model"] == 0)


def _moe_ep(params: dict, h2: torch.Tensor, cfg: ModelConfig):
    """The routed experts under expert parallelism → (y (T, D), this
    data shard's aux). Model rank m holds experts m·E/M … (m+1)·E/M − 1
    (``wg`` etc. of E/M experts; a whole E is cut to them). Every model
    rank routes the same tokens — the data shard's: under fsdp training,
    where the model ranks hold other rows, they are gathered first — so
    the input and the router are replicated over ``model`` and their
    gradients are summed over it (the reference's ``shard_map``
    transpose). Under tp the input comes through "f" already and y is
    this rank's experts' partial sum, which the caller sums over
    ``model`` with the shared experts' (one all_reduce, identity
    backward); under fsdp training a reduce_scatter to the rank's rows,
    with an all_gather backward. Serving under fsdp, whose model ranks
    hold the same rows (``dist.replicated_rows``), routes them as they
    are and sums the ranks' experts with one all_reduce over ``model``."""
    mesh = dist.current_mesh()
    m = mesh.shape["model"]
    e_loc = cfg.n_experts // m
    e_base = mesh.coords["model"] * e_loc
    rows = "model" in dist.live_batch_axes()
    tp = dist.tensor_parallel().mesh is not None
    router = params["router"]
    if rows:        # fsdp: the gather's backward sums over model
        t = h2.shape[0]
        h2 = dist.gather_param(h2, dist.Plan(
            mesh, (t * m, h2.shape[1]), ("model", None),
            frozenset({"model"})))
    elif tp:        # tp: the step sums over the batch axes only
        router = dist.sum_backward(router, ("model",))
    top_e, top_w, aux = _route(h2, router, cfg)
    wg, wu, wd = (params[k] if params[k].shape[0] == e_loc
                  else params[k][e_base:e_base + e_loc]
                  for k in ("wg", "wu", "wd"))
    y = _moe_local(h2, top_e, top_w, wg, wu, wd, e_base, cfg)
    if rows:        # this rank's rows of the experts' sum
        return dist.reduce_scatter_rows(y, ("model",)), aux
    if not tp:      # the same rows on every model rank: their sum
        return dist.sum_forward(y, ("model",)), aux
    return y, aux


def moe_block(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Shared-expert + routed-expert MoE residual block → (y, aux loss).
    The routed experts see the call's B·S tokens at once (capacity by
    ``_capacity``); the shared experts are a dense SwiGLU over all of
    them. Under a mesh the tokens are this rank's rows and the routing is
    per data shard, as the reference's expert-parallel ``shard_map``
    routes: with ``expert_parallel(cfg)`` the experts are split over
    ``model`` (``_moe_ep``), else every expert is local; the aux loss is
    the mean of the ranks' (``pmean``) — over every mesh axis under
    expert parallelism, over the batch axes without. Under the tp layout
    the shared experts are a tensor-parallel MLP, whose partial sum joins
    the routed experts' before the one all_reduce over ``model``."""
    b, s, d = x.shape
    shared = ("swg", "swu", "swd")
    tp = dist.tensor_parallel()
    h = rms_norm(x, params["ln"], cfg.rms_eps)
    if expert_parallel(cfg) and tp.mesh is not None:
        h = tp.sum_grad(h)
        y, aux = _moe_ep(params, h.reshape(b * s, d), cfg)
        aux = dist.mean_forward(aux, dist.current_mesh().axis_names)
        y = y.reshape(b, s, d)
        if cfg.n_shared_experts > 0:
            y = y + mlp_partial(params, h, cfg, tp, shared)
        return x + tp.sum(y), aux
    h2 = h.reshape(b * s, d)
    if expert_parallel(cfg):
        y, aux = _moe_ep(params, h2, cfg)
        aux = dist.mean_forward(aux, dist.current_mesh().axis_names)
    else:
        top_e, top_w, aux = _route(h2, params["router"], cfg)
        y = _moe_local(h2, top_e, top_w, params["wg"], params["wu"],
                       params["wd"], 0, cfg)
        aux = dist.mean_forward(aux, dist.live_batch_axes())
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts > 0:
        y = y + tp.sum(mlp_partial(params, tp.sum_grad(h), cfg, tp, shared))
    return x + y, aux
