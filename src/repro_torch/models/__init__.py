"""LM stack: the decoder's dense-attention and Mamba1 families."""
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.decoder import (decode_step, init_cache,  # noqa: F401
                                        init_params, padded_vocab,
                                        param_shapes, prefill)
