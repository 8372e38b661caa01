"""The logical-axis sharding rules (``rules.py``). The reference's
``ctx.py`` (activation constraints inside a sharded step) is not ported
yet: see ``repro_torch/launch/__init__.py``."""
from .rules import (DEFAULT_RULES, SP_RULES, ShardingRules, local_shape,
                    mesh_sizes, partition_spec, placements, tree_specs)
