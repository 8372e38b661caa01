"""Architecture registry: ``get_arch(arch_id)`` -> ArchDef, over the archs
the port has. Each arch module defines FULL (paper-exact) and SMOKE
(reduced, same family) configs. The reference's other nine archs wait
(ROADMAP.md, Queue 1 item 7).
"""
from .base import (ArchDef, Shape, SHAPES, SMOKE_SHAPES, applicable_shapes,
                   input_specs)
from . import llama3_2_1b

_MODULES = [llama3_2_1b]

REGISTRY = {m.ARCH.arch_id: m.ARCH for m in _MODULES}
ARCH_IDS = sorted(REGISTRY)


def get_arch(arch_id: str) -> ArchDef:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return REGISTRY[arch_id]
