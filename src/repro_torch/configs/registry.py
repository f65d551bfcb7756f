"""Architecture registry: the 10 assigned configs, exactly as specified.

Sources are public ([hf:...] / [arXiv:...] per the assignment); each file
``configs/<id>.py`` exposes ``CONFIG``.
"""

from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeSpec  # noqa: F401

ARCH_IDS = [
    "whisper_tiny",
    "llama3_2_3b",
    "gemma3_1b",
    "yi_6b",
    "qwen3_1_7b",
    "qwen2_vl_2b",
    "zamba2_1_2b",
    "deepseek_v2_lite",
    "deepseek_v2_236b",
    "mamba2_130m",
]

_ALIASES = {
    "whisper-tiny": "whisper_tiny",
    "llama3.2-3b": "llama3_2_3b",
    "gemma3-1b": "gemma3_1b",
    "yi-6b": "yi_6b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "zamba2-1.2b": "zamba2_1_2b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-130m": "mamba2_130m",
}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{arch}", __package__)
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
