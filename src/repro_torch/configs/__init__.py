"""Configurations of the port (the reference's widths) and the LM
architecture registry: ``--arch <id>`` → config / smoke config.

The registry names every architecture of ``repro.configs``. The port
serves the dense GQA transformer (``qwen2.5-14b``) and Mamba1
(``falcon-mamba-7b``) so far; the other LM architectures raise
``NotImplementedError`` until ROADMAP queue 1 item 6 ports their families.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "musicgen-large": None,
    "codeqwen1.5-7b": None,
    "yi-9b": None,
    "command-r-35b": None,
    "qwen2.5-14b": "qwen25_14b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-1b": None,
    "deepseek-moe-16b": None,
    "moonshot-v1-16b-a3b": None,
    "zamba2-1.2b": None,
    "fast_seismic": "fast_seismic",
}

LM_ARCHS = [a for a in _MODULES if a != "fast_seismic"]
ALL_ARCHS = list(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ALL_ARCHS}")
    if _MODULES[arch] is None:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: ROADMAP queue 1 item 6 (the "
            f"remaining LM families) brings it to repro_torch")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _mod(arch).config()


def get_smoke_config(arch: str):
    return _mod(arch).smoke_config()

