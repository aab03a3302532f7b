"""HEP (heuristic) optimizer engine.

Parity with the reference's rule engine (reference
src/optimizer/heuristic/optimizer.rs:20-110, batch.rs:5-56, matcher.rs:24):
named batches of rules run with a strategy (fix-point with max iterations, or
once), matching patterns against plan nodes in top-down order. The reference
maintains a petgraph StableDiGraph with edge weights for child order; since
every rule is a pure tree rewrite, this implementation works on the operator
tree directly — same semantics, no graph bookkeeping.

Fix-point detection matches the reference (optimizer.rs:83-90): a batch
repeats until the rendered plan stops changing or max_iteration is hit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from sqlrs_tpu_torch.plan.logical import LogicalOperator, explain_tree


@dataclass
class Pattern:
    """Node predicate + child patterns (reference
    src/optimizer/core/pattern.rs:14-33). children=None means "don't care";
    a list requires the first len(list) children to match pairwise."""

    predicate: Callable[[LogicalOperator], bool]
    children: Optional[list["Pattern"]] = None

    def matches(self, node: LogicalOperator) -> bool:
        if not self.predicate(node):
            return False
        if self.children is None:
            return True
        if len(node.children) < len(self.children):
            return False
        return all(
            p.matches(c) for p, c in zip(self.children, node.children)
        )


class Rule:
    name = "rule"
    pattern: Pattern

    def apply(self, node: LogicalOperator) -> Optional[LogicalOperator]:
        """Return a replacement subtree, or None if the rule does not fire."""
        raise NotImplementedError


@dataclass
class HepBatchStrategy:
    max_iteration: int = 1
    top_down: bool = True

    @staticmethod
    def fix_point_topdown(max_iteration: int) -> "HepBatchStrategy":
        return HepBatchStrategy(max_iteration=max_iteration, top_down=True)

    @staticmethod
    def once_topdown() -> "HepBatchStrategy":
        return HepBatchStrategy(max_iteration=1, top_down=True)


@dataclass
class HepBatch:
    name: str
    strategy: HepBatchStrategy
    rules: list[Rule] = field(default_factory=list)


class HepOptimizer:
    def __init__(self, batches: list[HepBatch], trace: bool = False) -> None:
        self.batches = batches
        self.trace = trace

    def find_best(self, plan: LogicalOperator) -> LogicalOperator:
        for batch in self.batches:
            prev = explain_tree(plan)
            for _ in range(batch.strategy.max_iteration):
                plan = self._apply_batch(plan, batch)
                cur = explain_tree(plan)
                if cur == prev:
                    break
                prev = cur
        return plan

    def _apply_batch(self, plan: LogicalOperator, batch: HepBatch) -> LogicalOperator:
        for rule in batch.rules:
            plan = self._apply_rule(plan, rule, batch.strategy.top_down)
            if self.trace:
                print(f"[hep] after {rule.name}:\n{explain_tree(plan)}")
        return plan

    def _apply_rule(
        self, node: LogicalOperator, rule: Rule, top_down: bool
    ) -> LogicalOperator:
        if top_down:
            node = self._try_apply(node, rule)
            node.children = [
                self._apply_rule(c, rule, top_down) for c in node.children
            ]
            return node
        node.children = [self._apply_rule(c, rule, top_down) for c in node.children]
        return self._try_apply(node, rule)

    def _try_apply(self, node: LogicalOperator, rule: Rule) -> LogicalOperator:
        # re-apply while the rule keeps firing at this position (e.g. a chain
        # of collapsible projections)
        for _ in range(16):
            if not rule.pattern.matches(node):
                return node
            out = rule.apply(node)
            if out is None or out is node:
                return node
            node = out
        return node
