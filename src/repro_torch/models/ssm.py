"""State-space blocks: Mamba1 (selective scan) and Mamba2 (SSD).

The counterparts of ``repro.models.ssm``. Mamba1's prefill scan goes
through the ``mamba_scan`` kernel, which computes the function of the
reference's chunked associative scan (``mamba1_scan``) with the state
held on chip, and training's backward through its backward kernel
(``ops.MambaScanFn``; h_final is unused there, so its gradient is None and
the kernel takes it as zero). Mamba2 runs the chunked state-space dual
(``ssd``) in plain PyTorch products, as the reference runs it in XLA
(no Pallas kernel). Decode is the O(1) recurrence in plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _dt_bc(params: dict, xc: torch.Tensor, cfg: ModelConfig):
    """x_proj → (dt fp32 after softplus, B fp32, C fp32), each (B, S, ·)."""
    n, r = cfg.ssm_state, cfg.dt_rank
    proj = torch.einsum("bse,ep->bsp", xc, params["x_proj"].to(cfg.cdtype))
    bmat = proj[..., r: r + n].float().contiguous()
    cmat = proj[..., r + n:].float().contiguous()
    dt = F.softplus(
        torch.einsum("bsr,re->bse", proj[..., :r],
                     params["dt_w"].to(cfg.cdtype)).float()
        + params["dt_bias"].float())
    return dt, bmat, cmat


def mamba1_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 return_state: bool = False):
    """Full Mamba1 residual block (prefill path)."""
    cd = cfg.cdtype
    h = rms_norm(x, params["ln"], cfg.rms_eps)
    xz = torch.einsum("bsd,de->bse", h, params["in_proj"].to(cd))
    xin, z = xz.chunk(2, dim=-1)
    xc = F.silu(causal_depthwise_conv(xin, params["conv_w"].to(cd),
                                      params["conv_b"].to(cd)))
    dt, bmat, cmat = _dt_bc(params, xc, cfg)
    a = -torch.exp(params["a_log"].float())                  # (Di, N)
    sdt = dtype(cfg.ssm_scan_dtype)
    xdt = (dt * xc.float()).to(sdt)
    y, h_final = ops.mamba_scan(xdt, dt.to(sdt), a, bmat.to(sdt),
                                cmat.to(sdt))
    y = y.float() + params["d_skip"].float()[None, None] * xc.float()
    y = y.to(cd) * F.silu(z)
    out = x + torch.einsum("bse,ed->bsd", y, params["out_proj"].to(cd))
    if return_state:
        state = {"conv": xin[:, -(cfg.ssm_conv - 1):].to(
            dtype(cfg.cache_dtype)), "ssm": h_final}
        return out, state
    return out


def mamba1_decode(params: dict, x: torch.Tensor, cache: dict,
                  cfg: ModelConfig):
    """Single-token Mamba1 step. x: (B, 1, D); cache: conv (B, dc-1, Di),
    ssm (B, Di, N) → (out, new cache)."""
    cd = cfg.cdtype
    h = rms_norm(x, params["ln"], cfg.rms_eps)
    xz = torch.einsum("bsd,de->bse", h, params["in_proj"].to(cd))
    xin, z = xz.chunk(2, dim=-1)
    conv_in = torch.cat([cache["conv"], xin], dim=1)       # (B, dc, Di)
    w = params["conv_w"].to(cd)
    xc = F.silu((conv_in * w[None]).sum(dim=1, keepdim=True)
                + params["conv_b"].to(cd))
    dt, bmat, cmat = _dt_bc(params, xc, cfg)
    a = -torch.exp(params["a_log"].float())
    g = torch.exp(dt[:, 0, :, None] * a[None])
    hs = (g * cache["ssm"]
          + (dt[:, 0, :, None] * xc.float()[:, 0, :, None])
          * bmat[:, 0, None, :])
    y = torch.einsum("bdn,bn->bd", hs, cmat[:, 0])
    y = y + params["d_skip"].float()[None] * xc.float()[:, 0]
    y = y[:, None].to(cd) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"].to(cd))
    return x + out, {"conv": conv_in[:, 1:], "ssm": hs}


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
    out = x + torch.einsum("bse,ed->bsd", y, params["out_proj"].to(cd))
    if return_state:
        state = {"conv": xbc_raw[:, -(cfg.ssm_conv - 1):].to(
            dtype(cfg.cache_dtype)), "ssm": h_final}
        return out, state
    return out


def mamba2_decode(params: dict, x: torch.Tensor, cache: dict,
                  cfg: ModelConfig):
    """Single-token Mamba2 step. x: (B, 1, D); cache: conv (B, dc-1,
    Di+2N), ssm (B, H, P, N) → (out, new cache)."""
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
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"].to(cd))
    return x + out, {"conv": conv_in[:, 1:], "ssm": hs}
