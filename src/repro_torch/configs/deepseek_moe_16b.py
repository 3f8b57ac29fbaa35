"""deepseek-moe-16b [moe] — fine-grained MoE: 2 shared + 64 routed
experts, top-6. [arXiv:2401.06066; hf]. 28L d_model=2048 16H (kv=16)
expert d_ff=1408 vocab=102400. (Upstream's dense first layer is folded
into the uniform MoE stack — noted deviation.)
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "deepseek-moe-16b"


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=0, vocab_size=102400, n_experts=64,
        n_shared_experts=2, moe_top_k=6, expert_ff=1408)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=0, vocab_size=512, n_experts=8,
        n_shared_experts=2, moe_top_k=2, expert_ff=64, attn_q_block=32,
        attn_kv_block=32, loss_seq_chunk=32)
