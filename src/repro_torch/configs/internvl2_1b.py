"""internvl2-1b [vlm] — InternViT + (qwen2-arch) LM backbone.
[arXiv:2404.16821; hf]. 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655. Frontend stub: the batch carries precomputed patch
embeddings (B, 256, d_model) as ``patch_embeds``; a learned projector
maps them into the sequence (first 256 positions).
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "internvl2-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", n_layers=24, d_model=896, n_heads=14,
        n_kv_heads=2, d_ff=4864, vocab_size=151655, qkv_bias=True,
        frontend="patch", n_patches=256)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab_size=512, qkv_bias=True,
        frontend="patch", n_patches=8, attn_q_block=32, attn_kv_block=32,
        loss_seq_chunk=32)
