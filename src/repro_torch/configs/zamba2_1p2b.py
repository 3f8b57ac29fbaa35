"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]. 38L d_model=2048 32H (kv=32) d_ff=8192
vocab=32000 ssm_state=64. The shared transformer block (attn + d_ff MLP)
is invoked every 6 Mamba2 layers (per-invocation LoRA deltas and the
concat-with-embedding input are simplified away — noted deviations).
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "zamba2-1.2b"


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", n_layers=38, d_model=2048, n_heads=32,
        n_kv_heads=32, d_ff=8192, vocab_size=32000, block_kind="mamba2",
        ssm_state=64, ssm_head_dim=64, ssm_conv=4, ssm_expand=2,
        ssm_chunk=64, shared_attn_every=6, subquadratic=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", n_layers=5, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab_size=512, block_kind="mamba2",
        ssm_state=16, ssm_head_dim=32, ssm_chunk=16, shared_attn_every=2,
        attn_q_block=32, attn_kv_block=32, loss_seq_chunk=32,
        subquadratic=True)
