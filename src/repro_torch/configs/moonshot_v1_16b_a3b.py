"""moonshot-v1-16b-a3b [moe] — kimi/moonlight-style MoE: 64 routed
top-6 (+2 shared, moonlight-style). [hf:moonshotai/Moonlight-16B-A3B; hf].
48L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=163840.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "moonshot-v1-16b-a3b"


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=0, vocab_size=163840, n_experts=64,
        n_shared_experts=2, moe_top_k=6, expert_ff=1408)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-smoke", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=512, n_experts=8,
        n_shared_experts=2, moe_top_k=2, expert_ff=64, attn_q_block=32,
        attn_kv_block=32, loss_seq_chunk=32)
