"""qwen2.5-14b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf].
48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2.5-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=13824, vocab_size=152064, qkv_bias=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b-smoke", n_layers=2, d_model=160, n_heads=5,
        n_kv_heads=1, d_ff=320, vocab_size=512, qkv_bias=True,
        attn_q_block=32, attn_kv_block=32, loss_seq_chunk=32)
