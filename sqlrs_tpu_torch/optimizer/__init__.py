"""HEP plan optimizer.

Engine in hep.py (reference src/optimizer/heuristic/), rules in rules.py
(reference src/optimizer/rules/). The batch schedule replicates the
reference's default_optimizer (reference src/db.rs:57-105): predicate
pushdown → limit pushdown → column pruning → combine operators → simplify
casts; the physical-rewrite batch is the PhysicalPlanGenerator.
"""

from sqlrs_tpu_torch.optimizer.hep import HepBatch, HepBatchStrategy, HepOptimizer
from sqlrs_tpu_torch.optimizer.rules import default_rule_batches
from sqlrs_tpu_torch.plan.logical import LogicalOperator


def default_optimizer(trace: bool = False) -> HepOptimizer:
    return HepOptimizer(default_rule_batches(), trace=trace)


def optimize(plan: LogicalOperator) -> LogicalOperator:
    return default_optimizer().find_best(plan)


__all__ = [
    "HepOptimizer",
    "HepBatch",
    "HepBatchStrategy",
    "default_optimizer",
    "default_rule_batches",
    "optimize",
]
