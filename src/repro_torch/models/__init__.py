"""LM stack: the decoder of every LM family in the registry."""
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.decoder import (decode_step, forward,  # noqa: F401
                                        init_cache, init_params, lm_loss,
                                        padded_vocab, param_shapes, prefill)
