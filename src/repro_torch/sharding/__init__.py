"""The logical-axis sharding rules (``rules.py``) and the activation
constraints inside a step run over a mesh (``ctx.py``)."""
from .ctx import (activation_sharding_ctx, full_value, is_dtensor,
                  shard_activation, to_local)
from .rules import (DEFAULT_RULES, SP_RULES, ShardingRules, distribute_tree,
                    full_tree, local_bytes, local_shape, mesh_sizes,
                    partition_spec, placements, tree_specs)
