# Host-side filter construction (numpy, bit-identical to the JAX package)
# and the torch twins of the probe hashing.
from .bloom import BloomFilter, optimal_params
from .bloomier import (BloomierTable, XorFilter, PeelingFailed, bulk_peel,
                       bulk_peel2, bulk_assign, make_layout)
from .othello import Othello, DynamicExactFilter
from .lsm import (SSTable, ChainedTableFilter, LsmLevelChained,
                  LsmLevelBloom, latency_model)
from . import hashing

__all__ = [
    "BloomFilter", "optimal_params",
    "BloomierTable", "XorFilter", "PeelingFailed",
    "bulk_peel", "bulk_peel2", "bulk_assign", "make_layout",
    "Othello", "DynamicExactFilter",
    "SSTable", "ChainedTableFilter", "LsmLevelChained", "LsmLevelBloom",
    "latency_model", "hashing",
]
