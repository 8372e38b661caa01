"""Architecture registry: ``get_arch(arch_id)`` -> ArchDef, over the
reference's ten archs. Each arch module defines FULL (paper-exact) and
SMOKE (reduced, same family) configs.
"""
from .base import (ArchDef, Shape, SHAPES, SMOKE_SHAPES, applicable_shapes,
                   input_specs)
from . import (deepseek_67b, llama3_2_1b, qwen3_14b, deepseek_7b,
               llama4_scout_17b_a16e, deepseek_v2_lite_16b, rwkv6_7b,
               whisper_tiny, internvl2_26b, zamba2_2_7b)

_MODULES = [deepseek_67b, llama3_2_1b, qwen3_14b, deepseek_7b,
            llama4_scout_17b_a16e, deepseek_v2_lite_16b, rwkv6_7b,
            whisper_tiny, internvl2_26b, zamba2_2_7b]

REGISTRY = {m.ARCH.arch_id: m.ARCH for m in _MODULES}
ARCH_IDS = sorted(REGISTRY)


def get_arch(arch_id: str) -> ArchDef:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return REGISTRY[arch_id]
