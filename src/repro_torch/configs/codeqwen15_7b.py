"""codeqwen1.5-7b [dense] — qwen1.5 arch (QKV bias).
[hf:Qwen/CodeQwen1.5-7B; hf]. 32L d_model=4096 32H (GQA kv=32)
d_ff=13440 vocab=92416.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "codeqwen1.5-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=32, d_ff=13440, vocab_size=92416, qkv_bias=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=320, vocab_size=512, qkv_bias=True,
        attn_q_block=32, attn_kv_block=32, loss_seq_chunk=32)
