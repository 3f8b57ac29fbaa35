"""yi-9b [dense] — llama-arch GQA. [arXiv:2403.04652; hf].
48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "yi-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b", n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab_size=64000)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab_size=512, attn_q_block=32,
        attn_kv_block=32, loss_seq_chunk=32)
