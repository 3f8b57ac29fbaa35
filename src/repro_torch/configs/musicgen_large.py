"""musicgen-large [audio] — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]. 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048. Frontend stub: the inputs are precomputed EnCodec frame token
ids (single-stream; the 4-codebook interleave is upstream of the
backbone). Closest kin to the paper: the fingerprinter descends from audio
fingerprinting (Waveprint).
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "musicgen-large"


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=32, d_ff=8192, vocab_size=2048, frontend="audio")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab_size=512, frontend="audio",
        attn_q_block=32, attn_kv_block=32, loss_seq_chunk=32)
