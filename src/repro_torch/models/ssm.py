"""State-space blocks: Mamba1 (selective scan) and Mamba2 (SSD).

The counterparts of ``repro.models.ssm``. Mamba1's prefill scan goes
through the ``mamba_scan`` kernel, which computes the function of the
reference's chunked associative scan (``mamba1_scan``) with the state
held on chip, and training's backward through its backward kernel
(``ops.MambaScanFn``; h_final is unused there, so its gradient is None and
the kernel takes it as zero). Mamba2 runs the chunked state-space dual
(``ssd``) in plain PyTorch products, as the reference runs it in XLA
(no Pallas kernel). Decode is the O(1) recurrence in plain PyTorch.

Under the tp layout (``dist.TensorParallel``) Mamba1 runs on the rank's
block of the ``d_inner`` channels, as the rules lay out ``in_proj``,
``conv_*``, ``dt_w``, ``a_log``, ``d_skip`` and ``dt_bias``: ``x_proj``
is row-parallel, so its (dt_low | B | C) output is summed over the
ranks ("g") and each rank uses its channels' part of it ("f");
``mamba_scan`` runs on the rank's channels and ``out_proj`` is
row-parallel, then "g". The rules store ``in_proj``'s fused (x | z)
columns in blocks that are not the rank's channels, so a stored block's
product is gathered over the ranks (an activation, not the weight).
Mamba2 keeps its fused projections replicated, as its rules say: each
rank computes the block whole and only ``out_proj`` is row-parallel on
the rank's slice of ``d_inner``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import dist
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig, dtype
from repro_torch.models.layers import rms_norm


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (d_conv, C); left-padded causal conv via shifts."""
    d_conv = w.shape[0]
    out = torch.zeros_like(x)
    for i in range(d_conv):
        shift = d_conv - 1 - i
        xs = F.pad(x, (0, 0, shift, 0))[:, : x.shape[1]]
        out = out + xs * w[i][None, None, :]
    return out + b[None, None, :]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., L) log-decays → (..., L, L) lower-triangular cumulative
    log-decay: [i, j] = a[j+1] + … + a[i] = cs[i] − cs[j] for i ≥ j, −inf
    above the diagonal."""
    n = a.shape[-1]
    cs = a.cumsum(-1)
    diff = cs[..., :, None] - cs[..., None, :]
    lower = torch.ones((n, n), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~lower, float("-inf"))


def _dt_bc(params: dict, proj: torch.Tensor, cfg: ModelConfig,
           tp: dist.TensorParallel):
    """x_proj's output (dt_low | B | C) → (dt fp32 after softplus on the
    rank's channels, B fp32, C fp32), each (B, S, ·)."""
    n, r, di = cfg.ssm_state, cfg.dt_rank, cfg.d_inner
    bmat = proj[..., r: r + n].float().contiguous()
    cmat = proj[..., r + n:].float().contiguous()
    dt = F.softplus(
        torch.einsum("bsr,re->bse", proj[..., :r],
                     tp.part(params["dt_w"], 1, di).to(cfg.cdtype)).float()
        + tp.part(params["dt_bias"], 0, di).float())
    return dt, bmat, cmat


def _xz(params: dict, h: torch.Tensor, cfg: ModelConfig,
        tp: dist.TensorParallel):
    """in_proj → (x, z) on the rank's channels. A whole ``in_proj`` is cut
    to the rank's x and z columns; a stored block of the fused (x | z)
    columns gives its product, gathered over the ranks, of which the rank
    cuts its channels."""
    di, cd = cfg.d_inner, cfg.cdtype
    w = params["in_proj"]
    if tp.size == 1:
        return torch.einsum("bsd,de->bse", h, w.to(cd)).chunk(2, dim=-1)
    lo, hi = tp.block(di)
    if w.shape[1] == 2 * di:
        w = torch.cat([w[:, lo:hi], w[:, di + lo:di + hi]], dim=1)
        return torch.einsum("bsd,de->bse", h, w.to(cd)).split(
            [hi - lo, hi - lo], dim=-1)
    xz = tp.gather_sum_grad(torch.einsum("bsd,de->bse", h, w.to(cd)), 2,
                            2 * di)
    return xz[..., lo:hi], xz[..., di + lo:di + hi]


def mamba1_mix(params: dict, h: torch.Tensor, cfg: ModelConfig,
               tp: dist.TensorParallel):
    """A Mamba1 block's first half on the rank's channels, from the normed
    input ``h`` (already through "f") → (xin, z, xc (B, S, Di/M), the
    rank's partial sum of x_proj's output (B, S, r + 2N))."""
    cd, di = cfg.cdtype, cfg.d_inner
    xin, z = _xz(params, h, cfg, tp)
    xc = F.silu(causal_depthwise_conv(
        xin, tp.part(params["conv_w"], 1, di).to(cd),
        tp.part(params["conv_b"], 0, di).to(cd)))
    proj = torch.einsum("bse,ep->bsp", xc,
                        tp.part(params["x_proj"], 0, di).to(cd))
    return xin, z, xc, proj


def mamba1_scan_out(params: dict, xc: torch.Tensor, z: torch.Tensor,
                    proj: torch.Tensor, cfg: ModelConfig,
                    tp: dist.TensorParallel):
    """A Mamba1 block's second half on the rank's channels, from x_proj's
    whole output ``proj`` → (the rank's partial sum of out_proj's output
    (B, S, D), h_final (B, Di/M, N)). ``mamba_scan`` runs on the rank's
    channels; a rank without channels launches nothing."""
    cd, di = cfg.cdtype, cfg.d_inner
    dt, bmat, cmat = _dt_bc(params, proj, cfg, tp)
    a = -torch.exp(tp.part(params["a_log"], 0, di).float())   # (Di, N)
    sdt = dtype(cfg.ssm_scan_dtype)
    xdt = (dt * xc.float()).to(sdt)
    if xdt.shape[-1]:
        y, h_final = ops.mamba_scan(xdt, dt.to(sdt), a, bmat.to(sdt),
                                    cmat.to(sdt))
    else:
        y = xdt * 0
        h_final = xdt.new_zeros((xdt.shape[0], 0, a.shape[1]),
                                dtype=torch.float32)
    y = y.float() + tp.part(params["d_skip"], 0, di).float()[None, None] \
        * xc.float()
    y = y.to(cd) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y,
                       tp.part(params["out_proj"], 0, di).to(cd))
    return out, h_final


def mamba1_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 return_state: bool = False):
    """Full Mamba1 residual block (prefill path); under the tp layout on
    the rank's channels, with ``return_state`` their decode state."""
    tp = dist.tensor_parallel()
    h = tp.sum_grad(rms_norm(x, params["ln"], cfg.rms_eps))
    xin, z, xc, proj = mamba1_mix(params, h, cfg, tp)
    proj = tp.sum_grad(tp.sum(proj))
    out, h_final = mamba1_scan_out(params, xc, z, proj, cfg, tp)
    out = x + tp.sum(out)
    if return_state:
        state = {"conv": xin[:, -(cfg.ssm_conv - 1):].to(
            dtype(cfg.cache_dtype)), "ssm": h_final}
        return out, state
    return out


def mamba1_decode(params: dict, x: torch.Tensor, cache: dict,
                  cfg: ModelConfig):
    """Single-token Mamba1 step. x: (B, 1, D); cache: conv (B, dc-1, Di),
    ssm (B, Di, N) → (out, new cache); under the tp layout the cache and
    the new one are the rank's channels (Di/M)."""
    tp = dist.tensor_parallel()
    cd, di = cfg.cdtype, cfg.d_inner
    h = tp.sum_grad(rms_norm(x, params["ln"], cfg.rms_eps))
    xin, z = _xz(params, h, cfg, tp)
    conv_in = torch.cat([cache["conv"], xin], dim=1)       # (B, dc, Di)
    w = tp.part(params["conv_w"], 1, di).to(cd)
    xc = F.silu((conv_in * w[None]).sum(dim=1, keepdim=True)
                + tp.part(params["conv_b"], 0, di).to(cd))
    proj = torch.einsum("bse,ep->bsp", xc,
                        tp.part(params["x_proj"], 0, di).to(cd))
    dt, bmat, cmat = _dt_bc(params, tp.sum(proj), cfg, tp)
    a = -torch.exp(tp.part(params["a_log"], 0, di).float())
    g = torch.exp(dt[:, 0, :, None] * a[None])
    hs = (g * cache["ssm"]
          + (dt[:, 0, :, None] * xc.float()[:, 0, :, None])
          * bmat[:, 0, None, :])
    y = torch.einsum("bdn,bn->bd", hs, cmat[:, 0])
    y = y + tp.part(params["d_skip"], 0, di).float()[None] * xc.float()[:, 0]
    y = y[:, None].to(cd) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y,
                       tp.part(params["out_proj"], 0, di).to(cd))
    return x + tp.sum(out), {"conv": conv_in[:, 1:], "ssm": hs}


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def ssd(xdt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, h0: torch.Tensor, chunk: int):
    """Chunked state-space dual. xdt: (B, S, H, P) dt-scaled inputs; a:
    (B, S, H) log-decays; b, c: (B, S, N); h0: (B, H, P, N); all fp32 →
    (y (B, S, H, P), h_final (B, H, P, N)).

    Any S: the reference needs S ≤ ``chunk`` or a multiple of it; here a
    ragged tail is padded with zeros in xdt, a, b and c, whose decay
    exp(0) = 1 and zero input leave the valid outputs and h_final as they
    were. The reference's three-operand einsums are each two fp32
    products here, in another summation order than XLA's."""
    bsz, s, hh, p = xdt.shape
    n = b.shape[-1]
    pad = -s % chunk
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    x_ = xdt.reshape(bsz, nc, chunk, hh, p).permute(0, 1, 3, 2, 4)
    a_ = a.reshape(bsz, nc, chunk, hh).permute(0, 1, 3, 2)    # (B,nc,H,Lc)
    b_ = b.reshape(bsz, nc, chunk, n)
    c_ = c.reshape(bsz, nc, chunk, n)

    a_cs = a_.cumsum(-1)                                      # (B,nc,H,Lc)
    # diagonal blocks: y[l] = Σ_s exp(segsum)[l, s] (c_l · b_s) x_s
    att = torch.matmul(c_, b_.transpose(-1, -2))              # (B,nc,Lc,Lc)
    m = torch.exp(_segsum(a_)) * att[:, :, None]              # (B,nc,H,Lc,Lc)
    y = torch.matmul(m, x_)                                   # (B,nc,H,Lc,P)
    # each chunk's final state from its own inputs
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)           # (B,nc,H,Lc)
    states = torch.matmul((x_ * decay_states[..., None]).transpose(-1, -2),
                          b_[:, :, None])                     # (B,nc,H,P,N)
    chunk_decay = torch.exp(a_cs[..., -1])                    # (B,nc,H)
    h, prev = h0, []
    for i in range(nc):
        prev.append(h)
        h = chunk_decay[:, i, :, None, None] * h + states[:, i]
    h_prev = torch.stack(prev, dim=1)                         # (B,nc,H,P,N)
    # off-diagonal: the state entering each chunk, decayed to each step
    y_off = torch.matmul(c_[:, :, None], h_prev.transpose(-1, -2))
    y = y + y_off * torch.exp(a_cs)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(bsz, nc * chunk, hh, p)
    return y[:, :s], h


def _split_zxbcdt(params: dict, h: torch.Tensor, cfg: ModelConfig):
    """in_proj → (z (B,S,Di), xBC before the conv (B,S,Di+2N), dt before
    its softplus (B,S,H)), in the compute dtype."""
    di, n = cfg.d_inner, cfg.ssm_state
    zxbcdt = torch.einsum("bsd,de->bse", h,
                          params["in_proj"].to(cfg.cdtype))
    return zxbcdt.split([di, di + 2 * n, cfg.ssm_heads], dim=-1)


def mamba2_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 return_state: bool = False):
    """Full Mamba2 residual block (prefill / training path); with
    ``return_state`` also the decode state {"conv": the last d_conv − 1
    xBC inputs, "ssm": h_final}."""
    bsz, s, _ = x.shape
    di, n, hh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    cd = cfg.cdtype
    h = rms_norm(x, params["ln"], cfg.rms_eps)
    z, xbc_raw, dt_raw = _split_zxbcdt(params, h, cfg)
    xbc = F.silu(causal_depthwise_conv(xbc_raw, params["conv_w"].to(cd),
                                       params["conv_b"].to(cd)))
    xin, bmat, cmat = xbc.split([di, n, n], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())  # (B,S,H)
    a = -torch.exp(params["a_log"].float())                      # (H,)
    xh = xin.reshape(bsz, s, hh, p).float()
    h0 = xh.new_zeros((bsz, hh, p, n))
    y, h_final = ssd(xh * dt[..., None], dt * a, bmat.float(), cmat.float(),
                     h0, min(cfg.ssm_chunk, s))
    y = y + params["d_skip"].float()[None, None, :, None] * xh
    y = y.reshape(bsz, s, di).to(cd)
    y = rms_norm(y * F.silu(z), params["out_ln"], cfg.rms_eps)
    out = x + _out_proj(params, y, cfg)
    if return_state:
        state = {"conv": xbc_raw[:, -(cfg.ssm_conv - 1):].to(
            dtype(cfg.cache_dtype)), "ssm": h_final}
        return out, state
    return out


def mamba2_decode(params: dict, x: torch.Tensor, cache: dict,
                  cfg: ModelConfig):
    """Single-token Mamba2 step. x: (B, 1, D); cache: conv (B, dc-1,
    Di+2N), ssm (B, H, P, N) → (out, new cache), whole on every rank
    under the tp layout too (only ``out_proj`` is split)."""
    bsz = x.shape[0]
    di, n, hh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    cd = cfg.cdtype
    h = rms_norm(x, params["ln"], cfg.rms_eps)
    z, xbc, dt_raw = _split_zxbcdt(params, h, cfg)
    conv_in = torch.cat([cache["conv"], xbc], dim=1)       # (B, dc, C)
    xbc1 = F.silu((conv_in * params["conv_w"].to(cd)[None]).sum(
        dim=1, keepdim=True) + params["conv_b"].to(cd))
    xin, bmat, cmat = xbc1.split([di, n, n], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())[:, 0]
    a = -torch.exp(params["a_log"].float())
    g = torch.exp(dt * a[None])                            # (B, H)
    xh = xin[:, 0].reshape(bsz, hh, p).float()
    upd = (dt[..., None, None] * xh[..., None]
           * bmat[:, 0, None, None, :].float())
    hs = g[..., None, None] * cache["ssm"] + upd
    y = torch.einsum("bhpn,bn->bhp", hs, cmat[:, 0].float())
    y = y + params["d_skip"].float()[None, :, None] * xh
    y = rms_norm(y.reshape(bsz, 1, di).to(cd) * F.silu(z), params["out_ln"],
                 cfg.rms_eps)
    return x + _out_proj(params, y, cfg), {"conv": conv_in[:, 1:],
                                           "ssm": hs}


def _out_proj(params: dict, y: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """Mamba2's out_proj, row-parallel under the tp layout: the rank's
    slice of the (replicated) ``d_inner`` activations through "f", its
    rows of ``out_proj``, then "g"."""
    tp = dist.tensor_parallel()
    y = tp.sum_grad(y)
    if tp.size > 1:
        lo, hi = tp.block(cfg.d_inner)
        y = y[..., lo:hi]
    return tp.sum(torch.einsum(
        "bse,ed->bsd", y,
        tp.part(params["out_proj"], 0, cfg.d_inner).to(cfg.cdtype)))
