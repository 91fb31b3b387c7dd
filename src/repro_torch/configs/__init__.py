"""Registry of assigned architectures: get_config("<id>") / ARCHS (the
port's copy of ``repro.configs``; every published number unchanged)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, shape_for  # noqa: F401

ARCHS = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "internvl2-76b": "internvl2_76b",
    "gemma2-27b": "gemma2_27b",
    "qwen3-4b": "qwen3_4b",
    "qwen2-1.5b": "qwen2_1_5b",
    "olmo-1b": "olmo_1b",
    "whisper-base": "whisper_base",
    "mamba2-780m": "mamba2_780m",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def get_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.CONFIG


def all_cells():
    """Every runnable (arch, shape) pair; skipped cells yield reason strings."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape in cfg.skip_shapes:
                yield arch, shape, "skip: full attention excludes long-context decode"
            else:
                yield arch, shape, None
