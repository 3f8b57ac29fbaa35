"""Model configuration covering all the LM architecture families.

One dataclass describes dense GQA transformers, MoE (shared + routed
experts), Mamba1/Mamba2 SSMs, and Zamba2-style hybrids with a shared
attention block; modality frontends (ViT patches / EnCodec tokens) are
stubs whose precomputed embeddings arrive as inputs. The fields and their
defaults are those of ``repro.models.config``; ``cdtype`` / ``pdtype``
are ``torch.dtype``s.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

BlockKind = Literal["attn", "mamba1", "mamba2"]


def dtype(name: str) -> torch.dtype:
    """A dtype field's name ("bfloat16", "float32", ...) as a torch dtype."""
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return out


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 0                  # 0 → d_model // n_heads
    qkv_bias: bool = False             # qwen-family
    parallel_block: bool = False       # command-r: attn+FFN share the norm
                                       # and sum before ONE TP psum/layer
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    # block layout
    block_kind: BlockKind = "attn"     # homogeneous stack kind
    shared_attn_every: int = 0         # zamba2: shared attn block cadence
    # MoE (0 experts → dense)
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    expert_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    # SSM
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0               # 0 → ceil(d_model / 16)
    ssm_head_dim: int = 64             # mamba2 P
    ssm_chunk: int = 64                # SSD / chunked-scan length
    ssm_scan_dtype: str = "float32"    # chunked-scan pair dtype (perf knob)
    # frontend stubs
    frontend: Literal["none", "patch", "audio"] = "none"
    n_patches: int = 0                 # vlm: patch embeddings prepended
    # numerics / execution
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"
    remat: Literal["none", "block", "block_dots"] = "block"
    attn_q_block: int = 512
    attn_kv_block: int = 512
    loss_vocab_chunk: int = 2048       # CE computed in sequence chunks
    loss_seq_chunk: int = 512
    # decode cache update: True → all sequences share one position (one
    # slice write at pos[0]); False → per-slot positions (the
    # continuous-batching engine path)
    uniform_decode_pos: bool = True
    # sub-quadratic attention capability (long-context eligibility)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def ssm_heads(self) -> int:
        assert self.d_inner % self.ssm_head_dim == 0
        return self.d_inner // self.ssm_head_dim

    @property
    def cdtype(self) -> torch.dtype:
        return dtype(self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return dtype(self.param_dtype)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab_size * d * 2  # untied in/out embeddings
        per_layer = 0
        if self.block_kind == "attn" or self.shared_attn_every:
            qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
            o = (self.n_heads * hd) * d
            attn = qkv + o
        else:
            attn = 0
        if self.block_kind == "attn":
            per_layer += attn
        if self.block_kind in ("mamba1", "mamba2"):
            di, n = self.d_inner, self.ssm_state
            if self.block_kind == "mamba1":
                per_layer += (d * 2 * di + self.ssm_conv * di
                              + di * (self.dt_rank + 2 * n)
                              + self.dt_rank * di + di * n + di + di * d)
            else:
                h = self.ssm_heads
                per_layer += (d * (2 * di + 2 * n + h) + self.ssm_conv
                              * (di + 2 * n) + h * 2 + di + di * d)
        if self.is_moe:
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * self.expert_ff
            per_layer += self.n_shared_experts * 3 * d * self.expert_ff
        elif self.d_ff and self.block_kind == "attn":
            per_layer += 3 * d * self.d_ff
        per_layer += 2 * d  # norms
        total = emb + self.n_layers * per_layer
        if self.shared_attn_every:
            total += attn + d
            if self.d_ff:
                total += 3 * d * self.d_ff  # shared block MLP
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        routed_all = self.n_experts * 3 * d * self.expert_ff
        routed_active = self.moe_top_k * 3 * d * self.expert_ff
        return (self.param_count()
                - self.n_layers * (routed_all - routed_active))
