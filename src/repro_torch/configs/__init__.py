"""Architecture registry of the port: the video DiT, qwen3-14b,
internlm2-20b, llama4-maverick-400b (MoE) and llama3-405b so far.

Each module exposes ``config(**overrides)`` (full size) and
``smoke_config(**overrides)`` (reduced, for CPU tests).
"""
from __future__ import annotations

import importlib

ARCH_NAMES = ["wan_dit_1_3b", "qwen3_14b", "internlm2_20b",
              "llama4_maverick_400b", "llama3_405b"]


def _module(name: str):
    if name not in ARCH_NAMES:
        raise ValueError(f"{name!r} is not ported; one of {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str, **overrides):
    """Full-size config of ``name``."""
    return _module(name).config(**overrides)


def get_smoke_config(name: str, **overrides):
    """Reduced config of ``name``."""
    return _module(name).smoke_config(**overrides)
