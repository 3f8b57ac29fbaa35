"""Configurations of the port (the reference's widths) and the LM
architecture registry: ``--arch <id>`` → config / smoke config / module
(``get_module``: the arch's config module, with its ``SHAPES`` and
``input_specs`` where it has them).

The registry names every architecture of ``repro.configs``, and the port
builds, serves and trains each of the ten LM architectures: the dense GQA
transformers (qwen2.5-14b, yi-9b, codeqwen1.5-7b, musicgen-large), the
parallel attention + MLP block (command-r-35b), MoE (deepseek-moe-16b,
moonshot-v1-16b-a3b), Mamba1 (falcon-mamba-7b), the Mamba2 + shared
attention hybrid (zamba2-1.2b) and the patch frontend (internvl2-1b).
"""
from __future__ import annotations

import importlib

_MODULES = {
    "musicgen-large": "musicgen_large",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "yi-9b": "yi_9b",
    "command-r-35b": "command_r_35b",
    "qwen2.5-14b": "qwen25_14b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-1b": "internvl2_1b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "zamba2-1.2b": "zamba2_1p2b",
    "fast_seismic": "fast_seismic",
}

LM_ARCHS = [a for a in _MODULES if a != "fast_seismic"]
ALL_ARCHS = list(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ALL_ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _mod(arch).config()


def get_smoke_config(arch: str):
    return _mod(arch).smoke_config()


def get_module(arch: str):
    return _mod(arch)
