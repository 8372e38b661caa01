"""Filter-pushdown query subsystem: predicate pipelines over filter banks.

The chain rule (paper §2–3) composes elementary filters without losing
information; a multi-predicate query plan is the same composition one
level up: each stage consumes the previous stage's survivors, and only
survivors pay the next probe. This package executes whole plans that way
— fused filter cascades over ``repro_torch.storage`` stores instead of SQL CTE
chains:

- ``catalog``  — named ``LsmStore`` collections plus secondary-index
  **tag banks**: key→tag Othello retrieval (Dietzfelbinger & Pagh's
  retrieval construction, bit-planes over the existing Othello machinery)
  enrolled at every flush/compact through the store's publish hook and
  double-buffered through ``FilterService`` — one captured ``BankState``
  per generation, so pinned plans probe the bank that matches their view.
- ``pipeline`` — the predicate-pipeline API: membership, min/max fence,
  and tag equality/set stages, each a batched bank probe over the current
  survivor set only, executed against per-store ``snapshot()`` handles
  (generation ids are the fence — a compaction mid-plan cannot tear the
  view).
- ``join``     — Datalog-style semijoin pruning: probe the next
  relation's filter bank before materializing join candidates, so only
  bank survivors pay an SSTable read.
"""
from .catalog import Catalog, Collection, TagIndex
from .pipeline import (Member, RangeFence, TagEq, TagIn, Pipeline,
                       PlanExecution, PlanResult, stages_from_specs)
from .join import JoinStep, SemiJoin, SemiJoinExecution, SemiJoinResult

__all__ = [
    "Catalog", "Collection", "TagIndex",
    "Member", "RangeFence", "TagEq", "TagIn", "Pipeline", "PlanExecution",
    "PlanResult", "stages_from_specs",
    "JoinStep", "SemiJoin", "SemiJoinExecution", "SemiJoinResult",
]
