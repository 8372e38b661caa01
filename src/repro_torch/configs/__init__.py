"""Architecture registry: ``get_arch(arch_id)`` -> ArchDef, over the archs
the port has. Each arch module defines FULL (paper-exact) and SMOKE
(reduced, same family) configs. The reference's rwkv6-7b, whisper-tiny
and zamba2-2.7b wait with their families (ROADMAP.md, Queue 1 item 7).
"""
from .base import (ArchDef, Shape, SHAPES, SMOKE_SHAPES, applicable_shapes,
                   input_specs)
from . import (deepseek_67b, llama3_2_1b, qwen3_14b, deepseek_7b,
               llama4_scout_17b_a16e, deepseek_v2_lite_16b, internvl2_26b)

_MODULES = [deepseek_67b, llama3_2_1b, qwen3_14b, deepseek_7b,
            llama4_scout_17b_a16e, deepseek_v2_lite_16b, internvl2_26b]

REGISTRY = {m.ARCH.arch_id: m.ARCH for m in _MODULES}
ARCH_IDS = sorted(REGISTRY)


def get_arch(arch_id: str) -> ArchDef:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return REGISTRY[arch_id]
