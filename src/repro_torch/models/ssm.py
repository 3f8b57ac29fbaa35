"""State-space blocks: Mamba1 (selective scan).

The counterparts of ``repro.models.ssm``'s Mamba1 functions. The prefill
scan goes through the ``mamba_scan`` kernel, which computes the function
of the reference's chunked associative scan (``mamba1_scan``) with the
state held on chip; decode is the O(1) recurrence in plain PyTorch.
Mamba2 (SSD) is not ported yet (ROADMAP).
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
