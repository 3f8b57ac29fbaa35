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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import dist
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


def _swiglu(h: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            wd: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(silu(h·wg) ⊙ h·wu)·wd over (B, S, d) in the compute dtype."""
    cd = cfg.cdtype
    g = torch.einsum("bsd,df->bsf", h, wg.to(cd))
    u = torch.einsum("bsd,df->bsf", h, wu.to(cd))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, wd.to(cd))


def mlp_block(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, params["ln"], cfg.rms_eps)
    return x + _swiglu(h, params["wg"], params["wu"], params["wd"], cfg)


def parallel_attn_mlp_block(attn_params: dict, mlp_params: dict,
                            x: torch.Tensor, cfg: ModelConfig,
                            positions: torch.Tensor | None, *,
                            cache: dict | None = None,
                            pos: torch.Tensor | None = None,
                            return_kv: bool = False):
    """Command-r-style parallel block: y = x + (attn(ln(x)) + mlp(ln(x))),
    one norm (the attention's ``ln``) for both branches, their sum added
    to the residual once, as in the reference.

    Prefill / training: ``positions`` (S,), attention through the
    ``flash_attention`` kernel; ``return_kv`` → (y, (k, v)). Decode:
    ``cache`` {"k", "v"} (B, S, Hkv, hd) written in place at ``pos`` (B,)
    by ``write_kv`` (either ``uniform_decode_pos`` mode) → (y, cache)."""
    h = rms_norm(x, attn_params["ln"], cfg.rms_eps)
    extra = None
    if cache is not None:
        q, k_new, v_new = qkv_project(attn_params, h, cfg, pos[:, None])
        write_kv(cache["k"], k_new, pos, cfg)
        write_kv(cache["v"], v_new, pos, cfg)
        o = decode_attention(q, cache["k"], cache["v"], pos)
        extra = cache
    else:
        q, k, v = qkv_project(attn_params, h, cfg, positions)
        o = blocked_attention(q, k, v)
        if return_kv:
            extra = (k, v)
    ao = torch.einsum("bshk,hkd->bsd", o, attn_params["wo"].to(cfg.cdtype))
    mo = _swiglu(h, mlp_params["wg"], mlp_params["wu"], mlp_params["wd"],
                 cfg)
    y = x + (ao + mo)
    return y if extra is None else (y, extra)


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
    rank routes the same tokens — the data shard's: under fsdp, where the
    model ranks hold other rows, they are gathered first — so the input
    and the router are replicated over ``model`` and their gradients are
    summed over it (the reference's ``shard_map`` transpose); one
    all_reduce over ``model`` combines the experts' outputs, with an
    identity backward (under fsdp a reduce_scatter to the rank's rows,
    with an all_gather backward)."""
    mesh = dist.current_mesh()
    m = mesh.shape["model"]
    e_loc = cfg.n_experts // m
    e_base = mesh.coords["model"] * e_loc
    rows = "model" in dist.live_batch_axes()
    router = params["router"]
    if rows:        # fsdp: the gather's backward sums over model
        t = h2.shape[0]
        h2 = dist.gather_param(h2, dist.Plan(
            mesh, (t * m, h2.shape[1]), ("model", None),
            frozenset({"model"})))
    else:           # tp: the step sums over the batch axes only
        h2 = dist.sum_backward(h2, ("model",))
        router = dist.sum_backward(router, ("model",))
    top_e, top_w, aux = _route(h2, router, cfg)
    wg, wu, wd = (params[k] if params[k].shape[0] == e_loc
                  else params[k][e_base:e_base + e_loc]
                  for k in ("wg", "wu", "wd"))
    y = _moe_local(h2, top_e, top_w, wg, wu, wd, e_base, cfg)
    if rows:        # this rank's rows of the experts' sum
        return dist.reduce_scatter_rows(y, ("model",)), aux
    return dist.sum_forward(y, ("model",)), aux


def moe_block(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Shared-expert + routed-expert MoE residual block → (y, aux loss).
    The routed experts see the call's B·S tokens at once (capacity by
    ``_capacity``); the shared experts are a dense SwiGLU over all of
    them. Under a mesh the tokens are this rank's rows and the routing is
    per data shard, as the reference's expert-parallel ``shard_map``
    routes: with ``expert_parallel(cfg)`` the experts are split over
    ``model`` (``_moe_ep``), else every expert is local; the aux loss is
    the mean of the ranks' (``pmean``) — over every mesh axis under
    expert parallelism, over the batch axes without."""
    b, s, d = x.shape
    h = rms_norm(x, params["ln"], cfg.rms_eps)
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
        y = y + _swiglu(h, params["swg"], params["swu"], params["swd"], cfg)
    return x + y, aux
