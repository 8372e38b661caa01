# Host-side filter construction (numpy, bit-identical to the JAX package)
# and the torch twins of the probe hashing.
from .theory import (f_lower_bound, chain_rule_gap, entropy,
                     chained_and_space_exact, chained_and_space_exact_rounded,
                     chained_cascade_space_exact, exact_bloomier_space,
                     corollary_4_1_space, optimal_eps_prime_exact, cuckoo_lambda)
from .bloom import BloomFilter, optimal_params
from .bloomier import (BloomierTable, XorFilter, ExactBloomier, PeelingFailed,
                       bulk_peel, bulk_peel2, bulk_assign, make_layout)
from .chained import ChainedFilterAnd, ChainedFilterCascade
from .cuckoo import CuckooHashTable, CuckooFilter, CuckooFull
from .othello import Othello, DynamicExactFilter
from .adaptive import AdaptiveCuckoo, emoma_bits, expected_access_reduction
from .lsm import (SSTable, ChainedTableFilter, LsmLevelChained,
                  LsmLevelBloom, latency_model)
from .learned import LearnedFilter, synth_url_dataset
from . import hashing, theory

__all__ = [
    "f_lower_bound", "chain_rule_gap", "entropy",
    "chained_and_space_exact", "chained_and_space_exact_rounded",
    "chained_cascade_space_exact", "exact_bloomier_space",
    "corollary_4_1_space", "optimal_eps_prime_exact", "cuckoo_lambda",
    "BloomFilter", "optimal_params",
    "BloomierTable", "XorFilter", "ExactBloomier", "PeelingFailed",
    "ChainedFilterAnd", "ChainedFilterCascade",
    "bulk_peel", "bulk_peel2", "bulk_assign", "make_layout",
    "CuckooHashTable", "CuckooFilter", "CuckooFull",
    "Othello", "DynamicExactFilter",
    "AdaptiveCuckoo", "emoma_bits", "expected_access_reduction",
    "SSTable", "ChainedTableFilter", "LsmLevelChained", "LsmLevelBloom",
    "latency_model", "LearnedFilter", "synth_url_dataset",
    "hashing", "theory",
]
