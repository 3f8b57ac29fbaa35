"""Assigned input-shape sets and ``meta`` input specs per cell (the
counterpart of ``repro.configs.shapes``).

LM shapes (seq_len × global_batch):
  train_4k     4,096 × 256   → train_step
  prefill_32k  32,768 × 32   → serve prefill
  decode_32k   32,768 × 128  → serve decode (1 new token, 32k cache)
  long_500k    524,288 × 1   → serve decode; sub-quadratic archs only

``[audio]``/``[vlm]`` backbones get stub frontends: input_specs provides
precomputed EnCodec token ids / ViT patch embeddings.

``sds`` is ``jax.ShapeDtypeStruct``'s counterpart: a ``meta`` tensor,
with a shape and a dtype and no storage (as ``fast_seismic.input_specs``
makes them).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import init_cache
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> list[str]:
    """Applicable shape names; long_500k only for sub-quadratic archs."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return names


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """``meta`` stand-ins for every model input of one cell, global shapes.

    For train/prefill: the token batch (+ stub frontend tensors).
    For decode: the (B, 1) token plus the pre-filled cache
    (``init_cache`` on ``meta``; under a mesh, this rank's blocks of it).
    """
    spec = LM_SHAPES[shape_name]
    b, s = spec.global_batch, spec.seq_len
    if spec.kind in ("train", "prefill"):
        batch = {"tokens": sds((b, s), torch.int32)}
        if spec.kind == "train":
            batch["labels"] = sds((b, s), torch.int32)
            batch["loss_mask"] = sds((b, s), torch.float32)
        if cfg.frontend == "patch":
            batch["patch_embeds"] = sds((b, cfg.n_patches, cfg.d_model),
                                        torch.bfloat16)
        return batch
    return {"tokens": sds((b, 1), torch.int32),
            "cache": init_cache(cfg, b, s, device="meta")}
