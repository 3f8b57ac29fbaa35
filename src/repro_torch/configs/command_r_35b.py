"""command-r-35b [dense] — GQA, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]. 40L d_model=8192 64H
(GQA kv=8) d_ff=22528 vocab=256000. (Parallel attn+FFN blocks are
implemented faithfully — one TP psum per layer; embeddings stay untied —
noted deviation.)
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "command-r-35b"


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", n_layers=40, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=22528, vocab_size=256000, parallel_block=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b-smoke", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=2, d_ff=320, vocab_size=512, parallel_block=True,
        attn_q_block=32, attn_kv_block=32, loss_seq_chunk=32)
