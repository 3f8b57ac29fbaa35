"""falcon-mamba-7b [ssm] — mamba1 arch, attention-free.
[arXiv:2410.05355; unverified]. 64L d_model=4096 vocab=65024
ssm_state=16. O(1)-state decode → runs long_500k.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "falcon-mamba-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", n_layers=64, d_model=4096, n_heads=1,
        n_kv_heads=1, d_ff=0, vocab_size=65024, block_kind="mamba1",
        ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_chunk=64,
        subquadratic=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke", n_layers=2, d_model=128, n_heads=1,
        n_kv_heads=1, d_ff=0, vocab_size=512, block_kind="mamba1",
        ssm_state=8, ssm_chunk=16, loss_seq_chunk=32, subquadratic=True)
